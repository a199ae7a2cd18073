"""Classic embedders and the ACE stack (counterpart of
``kbner_tpu/models/embedders.py``):

  - :class:`WordEmbedder`: a word-vector table, optionally frozen, with a
    word2vec/GloVe text reader;
  - :class:`CharBiLSTMEmbedder`: a BiLSTM over each word's characters,
    its last forward and first backward states;
  - :class:`CharLM`, :class:`CharLMHead` and :class:`FlairLMEmbedder`: a
    character language model over the sentence's character stream, each
    word taking the forward state at its last character and the backward
    state at its first;
  - :class:`TransformerWordEmbedder`: XLM-R's first-subtoken states,
    frozen unless ``fine_tune``;
  - :class:`StackedEmbedder`: the members' features concatenated in
    float32, each multiplied by its entry of an ACE selection mask;
  - :class:`ScalarMix`: a softmax-weighted sum of layers;
  - :class:`ELMoEmbedder`: a character CNN over each word and a word-level
    bi-LM over the sentence, in two topologies: the native one (tanh SAME
    convolutions, :class:`FlaxLSTM` layers sharing a mixed input) and
    bilm-tf's (``cell_dim`` set: relu VALID convolutions over the whole
    padded window, :class:`ELMoLSTMP` stacks per direction with residual
    skips), whose parameters published ELMo weight files fill
    (:meth:`ELMoEmbedder.load_hdf5`, read by :mod:`.hdf5`);
  - :class:`BPEVocab` and :class:`BPEmbEmbedder`: subword pieces by greedy
    longest match, each word's first and last piece vectors;
  - :func:`build_pooled_flair_table`: a Flair member's features pooled
    over a corpus into a word table.

Every member maps a batch of arrays to word features ``[B, W, D]``.

:class:`FlaxLSTM` computes what ``flax.linen.RNN(OptimizedLSTMCell(H),
reverse=..., keep_order=True)`` computes: gates i, f, o sigmoid and g
tanh, ``c = f*c + i*g``, ``h = o*tanh(c)``, from a zero carry over every
time step. With ``seq_lengths`` a reverse pass runs right to left within
each row's real length (the padding is flipped to the row's end, as
``flax.linen.recurrent.flip_sequences`` does), so a real position's state
never depends on the padding. All input projections are one matmul; the
time loop does the recurrent one. Parameters are kept in Flax's layout:
``kernel_i [in, 4H]`` and ``kernel_h [H, 4H]`` are the cell's
``ii|if|ig|io`` and ``hi|hf|hg|ho`` kernels side by side, ``bias [4H]``
the ``h*`` biases. :class:`FlaxGRU` is Flax's ``RNN`` of a ``GRUCell``
in the same style (the text classifier's ``rnn`` pooling).

Initialization draws from Flax's distributions with a ``torch.Generator``
on the module's device: tables from ``normal(0, 1/D)`` (``nn.Embed``),
input kernels and Dense kernels ``lecun_normal`` (a normal truncated at
two standard deviations, variance 1/fan_in), recurrent kernels orthogonal
per gate, biases zero; the transformer member as the tagger's encoder.
Gathers clamp their positions into range, as ``mode="clip"`` does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .xlmr import XLMRConfig, XLMREncoder

Batch = Dict[str, torch.Tensor]


# -- Flax's initializers ----------------------------------------------------------

@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """``flax.linen.initializers.lecun_normal``: a standard normal truncated
    to [-2, 2], scaled to variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


@torch.no_grad()
def embed_normal_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``nn.Embed``'s default: normal with variance ``1 / D``."""
    return t.normal_(0.0, t.shape[-1] ** -0.5, generator=gen)


def _dense(n_in: int, n_out: int, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, device=device, dtype=torch.float32)


@torch.no_grad()
def reset_dense_(lin: nn.Linear, gen: torch.Generator) -> None:
    """Flax ``Dense``: lecun_normal kernel, zero bias."""
    lecun_normal_(lin.weight, lin.in_features, gen)
    lin.bias.zero_()


@torch.no_grad()
def reset_flax_(root: nn.Module, gen: torch.Generator) -> None:
    """Flax's defaults over every layer under ``root``: ``nn.Linear`` as
    ``Dense`` (:func:`reset_dense_`), ``nn.Embedding`` as ``Embed``
    (:func:`embed_normal_`), ``nn.LayerNorm`` ones and zeros."""
    for module in root.modules():
        if isinstance(module, nn.Linear):
            reset_dense_(module, gen)
        elif isinstance(module, nn.Embedding):
            embed_normal_(module.weight, gen)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


def _gather_words(states: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``states[b, pos[b, w]]`` with positions clamped into the time
    axis: ``[B, T, H]`` and ``[B, W]`` -> ``[B, W, H]``."""
    pos = pos.long().clamp(0, states.shape[1] - 1)
    return torch.gather(states, 1,
                        pos.unsqueeze(-1).expand(-1, -1, states.shape[2]))


# -- the LSTM ---------------------------------------------------------------------

def flip_sequences(x: torch.Tensor, seq_lengths: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Flip a time-major ``[T, B, ...]`` array in time within each row's
    length, its padding flipped to the end (Flax's ``flip_sequences``);
    the whole axis without lengths. It is its own inverse."""
    T = x.shape[0]
    if seq_lengths is None:
        return torch.flip(x, (0,))
    idx = (torch.arange(T - 1, -1, -1, device=x.device)[:, None]
           + seq_lengths.long()[None, :]) % T  # [T, B]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 0, idx)


class FlaxLSTM(nn.Module):
    """Flax's ``RNN`` of an ``OptimizedLSTMCell(hidden)`` with ``reverse``
    and ``keep_order=True``, over batch-major inputs ``[B, T, in]``."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 device=None):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        kw = dict(device=device, dtype=torch.float32)
        self.kernel_i = nn.Parameter(torch.empty(in_dim, 4 * hidden, **kw))
        self.kernel_h = nn.Parameter(torch.empty(hidden, 4 * hidden, **kw))
        self.bias = nn.Parameter(torch.empty(4 * hidden, **kw))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        H = self.hidden
        for g in range(4):
            lecun_normal_(self.kernel_i[:, g * H:(g + 1) * H],
                          self.kernel_i.shape[0], gen)
            nn.init.orthogonal_(self.kernel_h[:, g * H:(g + 1) * H],
                                generator=gen)
        self.bias.zero_()

    def forward(self, x: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """States ``[B, T, H]`` at every step, in input order."""
        B, T, _ = x.shape
        H = self.hidden
        # every step's input projection and bias in one matmul, time-major
        xw = torch.addmm(self.bias, x.reshape(B * T, -1).float(),
                         self.kernel_i).view(B, T, 4 * H).transpose(0, 1)
        if self.reverse:
            xw = flip_sequences(xw, seq_lengths)
        h = xw.new_zeros(B, H)
        c = xw.new_zeros(B, H)
        hs = []
        # unbind and chunk: one backward node each for the whole split,
        # where indexing per step would add a zero-filled gradient of the
        # whole tensor per step
        for xw_t in xw.unbind(0):
            z = torch.addmm(xw_t, h, self.kernel_h)
            i, f, _, o = torch.sigmoid(z).chunk(4, dim=1)
            c = torch.addcmul(f * c, i, torch.tanh(z.chunk(4, dim=1)[2]))
            h = o * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs)  # [T, B, H], in scan order
        if self.reverse:
            out = flip_sequences(out, seq_lengths)
        return out.transpose(0, 1)


class FlaxGRU(nn.Module):
    """Flax's ``RNN`` of a ``GRUCell(hidden)`` (forward), over batch-major
    inputs ``[B, T, in]``: ``r = sigmoid(ir(x) + hr(h))``, ``z =
    sigmoid(iz(x) + hz(h))``, ``n = tanh(in(x) + r * hn(h))``, ``h = (1 -
    z) * n + z * h`` from a zero carry. In Flax's layout: ``kernel_i [in,
    3H]`` the ``ir|iz|in`` kernels side by side with their biases
    ``bias_i [3H]``, ``kernel_h [H, 3H]`` the ``hr|hz|hn`` kernels, and
    ``bias_hn [H]`` the only recurrent bias. Input kernels are drawn
    lecun-normal, recurrent ones orthogonal per gate, biases zero."""

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        self.hidden = hidden
        kw = dict(device=device, dtype=torch.float32)
        self.kernel_i = nn.Parameter(torch.empty(in_dim, 3 * hidden, **kw))
        self.bias_i = nn.Parameter(torch.empty(3 * hidden, **kw))
        self.kernel_h = nn.Parameter(torch.empty(hidden, 3 * hidden, **kw))
        self.bias_hn = nn.Parameter(torch.empty(hidden, **kw))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        H = self.hidden
        for g in range(3):
            lecun_normal_(self.kernel_i[:, g * H:(g + 1) * H],
                          self.kernel_i.shape[0], gen)
            nn.init.orthogonal_(self.kernel_h[:, g * H:(g + 1) * H],
                                generator=gen)
        self.bias_i.zero_()
        self.bias_hn.zero_()

    def forward(self, x: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """States ``[B, T', H]`` at the first ``T'`` steps, ``T'`` the
        longest of ``seq_lengths`` (all ``T`` without them); a row's
        states before its length are Flax's."""
        B, T, _ = x.shape
        if seq_lengths is not None:
            T = int(seq_lengths.max()) if B else 0
        H = self.hidden
        xw = torch.addmm(self.bias_i, x[:, :T].reshape(B * T, -1).float(),
                         self.kernel_i).view(B, T, 3 * H).transpose(0, 1)
        h = xw.new_zeros(B, H)
        hs = []
        for xw_t in xw.unbind(0):
            hw = h @ self.kernel_h
            x_r, x_z, x_n = xw_t.chunk(3, dim=1)
            h_r, h_z, h_n = hw.chunk(3, dim=1)
            r = torch.sigmoid(x_r + h_r)
            z = torch.sigmoid(x_z + h_z)
            n = torch.tanh(x_n + r * (h_n + self.bias_hn))
            h = (1.0 - z) * n + z * h
            hs.append(h)
        if not hs:
            return xw.new_zeros(B, 0, H)
        return torch.stack(hs, dim=1)


# -- the members ------------------------------------------------------------------

class WordEmbedder(nn.Module):
    """A word-vector table over ``word_ids``, frozen unless
    ``trainable``."""

    def __init__(self, vocab_size: int, dim: int = 100,
                 trainable: bool = True, device=None):
        super().__init__()
        self.trainable = trainable
        self.table = nn.Embedding(vocab_size, dim, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_normal_(self.table.weight, gen)

    def forward(self, batch: Batch) -> torch.Tensor:
        emb = self.table(batch["word_ids"].long())
        return emb if self.trainable else emb.detach()

    @staticmethod
    def load_pretrained_text(path, vocab_limit: Optional[int] = None
                             ) -> Tuple[Dict[str, int], np.ndarray]:
        """A word2vec/GloVe text file -> (vocabulary, ``[V, D]`` float32
        matrix). Row 0 is ``<unk>``: the file's ``<unk>`` vector, else
        zeros; a repeated word keeps its first vector."""
        vocab: Dict[str, int] = {"<unk>": 0}
        rows: List[np.ndarray] = []
        unk_vec = None
        with open(path, encoding="utf-8", errors="ignore") as f:
            first = f.readline().split()
            if not (len(first) == 2 and all(t.isdigit() for t in first)):
                f.seek(0)  # no word2vec header line
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) < 3:
                    continue
                word = parts[0]
                vec = np.asarray(parts[1:], dtype=np.float32)
                if word in vocab:
                    if word == "<unk>":
                        unk_vec = vec
                    continue
                vocab[word] = len(rows) + 1
                rows.append(vec)
                if vocab_limit and len(vocab) > vocab_limit:
                    break
        dim = len(rows[0]) if rows else (
            len(unk_vec) if unk_vec is not None else 0)
        row0 = (unk_vec if unk_vec is not None
                else np.zeros(dim, np.float32)).reshape(1, dim)
        matrix = np.vstack([row0] + rows) if rows else row0
        return vocab, matrix


class CharBiLSTMEmbedder(nn.Module):
    """A BiLSTM over each word's characters; the word's feature is the
    forward state at its last character and the backward state at its
    first (``2 * hidden`` wide)."""

    def __init__(self, char_vocab_size: int, char_dim: int = 25,
                 hidden: int = 25, device=None):
        super().__init__()
        self.hidden = hidden
        self.chars = nn.Embedding(char_vocab_size, char_dim, device=device)
        self.fwd = FlaxLSTM(char_dim, hidden, device=device)
        self.bwd = FlaxLSTM(char_dim, hidden, reverse=True, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_normal_(self.chars.weight, gen)
        self.fwd.reset_parameters(gen)
        self.bwd.reset_parameters(gen)

    def forward(self, batch: Batch) -> torch.Tensor:
        char_ids = batch["char_ids"]  # [B, W, C]
        B, W, C = char_ids.shape
        x = self.chars(char_ids.reshape(B * W, C).long())
        lengths = batch["char_mask"].reshape(B * W, C).bool().sum(-1)
        h_f = self.fwd(x, lengths)
        h_b = self.bwd(x, lengths)
        last = _gather_words(h_f, (lengths.clamp(min=1) - 1)[:, None])[:, 0]
        out = torch.cat([last, h_b[:, 0]], dim=-1)
        return out.reshape(B, W, 2 * self.hidden)


class CharLM(nn.Module):
    """A one-direction character language model: ``[B, T]`` ids ->
    ``[B, T, H]`` states; ``reverse`` runs right to left within
    ``seq_lengths``."""

    def __init__(self, char_vocab_size: int, embed_dim: int = 50,
                 hidden: int = 256, reverse: bool = False, device=None):
        super().__init__()
        self.embed = nn.Embedding(char_vocab_size, embed_dim, device=device)
        self.lstm = FlaxLSTM(embed_dim, hidden, reverse=reverse,
                             device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_normal_(self.embed.weight, gen)
        self.lstm.reset_parameters(gen)

    def forward(self, char_stream: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.lstm(self.embed(char_stream.long()), seq_lengths)


class CharLMHead(nn.Module):
    """A :class:`CharLM` with a next-character decoder, for pretraining."""

    def __init__(self, char_vocab_size: int, embed_dim: int = 50,
                 hidden: int = 256, device=None):
        super().__init__()
        self.lm = CharLM(char_vocab_size, embed_dim, hidden, device=device)
        self.decoder = _dense(hidden, char_vocab_size, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.lm.reset_parameters(gen)
        reset_dense_(self.decoder, gen)

    def forward(self, char_stream: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.lm(char_stream))

    def loss(self, char_stream: torch.Tensor, mask: torch.Tensor
             ) -> torch.Tensor:
        """Mean next-character cross-entropy over the masked targets."""
        logits = self(char_stream)[:, :-1]
        targets = char_stream[:, 1:].long()
        m = mask[:, 1:].float()
        gold = torch.gather(F.log_softmax(logits, -1), 2,
                            targets.unsqueeze(-1))[..., 0]
        return -(gold * m).sum() / m.sum().clamp(min=1.0)


class FlairLMEmbedder(nn.Module):
    """Forward and backward :class:`CharLM` over the character stream;
    word w gets the forward state at its last character and the backward
    state at its first (``2 * hidden`` wide)."""

    def __init__(self, char_vocab_size: int, embed_dim: int = 50,
                 hidden: int = 256, device=None):
        super().__init__()
        self.fwd = CharLM(char_vocab_size, embed_dim, hidden, device=device)
        self.bwd = CharLM(char_vocab_size, embed_dim, hidden, reverse=True,
                          device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.fwd.reset_parameters(gen)
        self.bwd.reset_parameters(gen)

    def forward(self, batch: Batch) -> torch.Tensor:
        stream = batch["char_stream"]
        lengths = batch["char_stream_mask"].sum(-1)
        h_f = self.fwd(stream, lengths)
        h_b = self.bwd(stream, lengths)
        return torch.cat([_gather_words(h_f, batch["word_char_ends"]),
                          _gather_words(h_b, batch["word_char_starts"])],
                         dim=-1)


class TransformerWordEmbedder(nn.Module):
    """XLM-R's state at each word's first subtoken, in the encoder's
    compute dtype, without dropout. ``fine_tune=False`` runs the encoder
    without gradients: its parameters get none, which the optimizer
    reads as zeros."""

    def __init__(self, config: XLMRConfig, fine_tune: bool = False,
                 device=None):
        super().__init__()
        self.fine_tune = fine_tune
        self.encoder = XLMREncoder(config, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """As the tagger's encoder: Flax's defaults (:func:`reset_flax_`)."""
        reset_flax_(self.encoder, gen)

    def forward(self, batch: Batch) -> torch.Tensor:
        with torch.set_grad_enabled(self.fine_tune and
                                    torch.is_grad_enabled()):
            hidden = self.encoder(batch["input_ids"], batch["attention_mask"])
            return _gather_words(hidden, batch["word_starts"])


class ScalarMix(nn.Module):
    """``gamma * sum_l softmax(weights)_l * layers[l]`` over ``[L, ...]``
    (weights start at 0, gamma at 1)."""

    def __init__(self, num_layers: int, device=None):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(num_layers, device=device))
        self.gamma = nn.Parameter(torch.ones((), device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weights.zero_()
            self.gamma.fill_(1.0)

    def forward(self, layer_stack: torch.Tensor) -> torch.Tensor:
        norm = torch.softmax(self.weights, dim=0)
        return self.gamma * torch.einsum("l,l...->...", norm, layer_stack)


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    """One member of a stack: its module and its output width."""

    name: str
    module: nn.Module
    dim: int


class StackedEmbedder(nn.Module):
    """The members' features side by side, in float32 (XLM-R's bfloat16
    features join the classic members' float32 ones, as
    ``jnp.concatenate`` promotes them). With a ``selection`` vector
    ``[N]``, member i's features are multiplied by ``selection[i]``: a
    masked member is still computed and adds zeros, so the width stays."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        self.members = nn.ModuleList(members)

    def forward(self, batch: Batch,
                selection: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs = []
        for i, member in enumerate(self.members):
            feats = member(batch).float()
            if selection is not None:
                feats = feats * selection[i].float()
            outs.append(feats)
        return torch.cat(outs, dim=-1)


# -- ELMo -------------------------------------------------------------------------

def _lstmp_step(z: torch.Tensor, c: torch.Tensor, w_p: torch.Tensor,
                clip: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bilm-tf LSTMP update from the gate pre-activations ``z [B, 4 *
    cell]`` (order i, j, f, o) and the cell state ``c``: ``(c, h)``."""
    i, j, f, o = z.chunk(4, dim=1)
    c = torch.addcmul(torch.sigmoid(f + 1.0) * c, torch.sigmoid(i),
                      torch.tanh(j)).clamp(-clip, clip)
    h = ((torch.sigmoid(o) * torch.tanh(c)) @ w_p).clamp(-clip, clip)
    return c, h


class _LSTMPParams(nn.Module):
    """The parameters of bilm-tf's LSTM with a projection, in tf's
    layouts: one fused kernel ``W_0 [in + proj, 4 * cell]`` (gate order i,
    j, f, o), its bias ``B`` and the projection ``W_P_0 [cell, proj]``,
    drawn as Flax draws them (lecun normal, zero bias)."""

    def __init__(self, in_dim: int, cell_dim: int, proj_dim: int,
                 clip: float = 3.0, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.clip = clip
        kw = dict(device=device, dtype=torch.float32)
        self.W_0 = nn.Parameter(torch.empty(in_dim + proj_dim, 4 * cell_dim,
                                            **kw))
        self.B = nn.Parameter(torch.empty(4 * cell_dim, **kw))
        self.W_P_0 = nn.Parameter(torch.empty(cell_dim, proj_dim, **kw))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        lecun_normal_(self.W_0, self.W_0.shape[0], gen)
        self.B.zero_()
        lecun_normal_(self.W_P_0, self.W_P_0.shape[0], gen)


class ELMoLSTMPCell(_LSTMPParams):
    """One step of bilm-tf's LSTM with a projection (the reference's Flax
    ``ELMoLSTMPCell``): ``c = clip(sigmoid(f + 1) * c + sigmoid(i) *
    tanh(j))`` and ``h = clip((sigmoid(o) * tanh(c)) @ W_P_0)``, both
    clipped to ``[-clip, clip]``, the gates from ``[x, h] @ W_0 + B``.
    The carry is ``(c [..., cell], h [..., proj])``."""

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        """``((c, h), h)`` after one step on ``x [..., in]``."""
        c, h = carry
        lead = x.shape[:-1]
        inp = torch.cat([x, h], dim=-1).reshape(-1, self.W_0.shape[0])
        c, h = _lstmp_step(torch.addmm(self.B, inp, self.W_0),
                           c.reshape(inp.shape[0], -1), self.W_P_0,
                           self.clip)
        c, h = c.view(*lead, -1), h.view(*lead, -1)
        return (c, h), h

    def initialize_carry(self, rng, input_shape):
        """Zero ``(c, h)`` for inputs of ``input_shape`` (``rng`` is
        unused, as in Flax's)."""
        lead = tuple(input_shape[:-1])
        return (self.W_0.new_zeros(lead + (self.W_P_0.shape[0],)),
                self.W_0.new_zeros(lead + (self.W_P_0.shape[1],)))


class ELMoLSTMP(_LSTMPParams):
    """:class:`ELMoLSTMPCell`'s recurrence over batch-major inputs ``[B,
    T, in]`` from a zero carry. ``reverse`` runs right to left within
    ``seq_lengths`` as :class:`FlaxLSTM` does. Every step's input half of
    ``W_0`` is one matmul; the time loop does the recurrent half and the
    projection."""

    def __init__(self, in_dim: int, cell_dim: int, proj_dim: int,
                 clip: float = 3.0, reverse: bool = False, device=None):
        super().__init__(in_dim, cell_dim, proj_dim, clip, device)
        self.reverse = reverse

    def forward(self, x: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Projected states ``[B, T, proj]`` at every step, in input
        order."""
        n, T, _ = x.shape
        xw = torch.addmm(self.B, x.reshape(n * T, -1).to(self.W_0.dtype),
                         self.W_0[:self.in_dim]).view(n, T, -1).transpose(0, 1)
        if self.reverse:
            xw = flip_sequences(xw, seq_lengths)
        w_h = self.W_0[self.in_dim:]
        h = xw.new_zeros(n, self.W_P_0.shape[1])
        c = xw.new_zeros(n, self.W_P_0.shape[0])
        hs = []
        for xw_t in xw.unbind(0):
            c, h = _lstmp_step(torch.addmm(xw_t, h, w_h), c, self.W_P_0,
                               self.clip)
            hs.append(h)
        out = torch.stack(hs)  # [T, B, proj], in scan order
        if self.reverse:
            out = flip_sequences(out, seq_lengths)
        return out.transpose(0, 1)


class ELMoEmbedder(nn.Module):
    """ELMo's architecture: a character CNN encodes each word (one pass
    over the batch's ``B * W`` words), highways and a projection to
    ``proj_dim``, then a ``num_layers`` word-level bi-LM over the
    sentence. ``mode`` combines the layers (token layer included, each
    ``2 * proj_dim`` wide): ``all`` side by side, ``top`` the last,
    ``average`` their mean, ``mix`` a learned :class:`ScalarMix`. Padded
    words come out zero.

    Native topology (``cell_dim`` None): SAME convolutions (an even width
    pads one more on the right) with ``conv_activation``, max-pooled over
    the word's real characters (a word of none gets a zero token), and
    :class:`FlaxLSTM` layers of width ``proj_dim`` whose next input is the
    sum of both directions. bilm-tf topology (``cell_dim`` set, the
    published ELMo's): VALID convolutions over all ``C`` embedded
    characters, pad characters included, activation then max, and
    separate forward and backward :class:`ELMoLSTMP` stacks, each layer's
    input the previous layer's output plus its input.

    Character ids are clamped into the table. ``input_key`` names the
    character window (``char_ids``, or ``elmo_char_ids`` for the byte ids
    of :func:`~..data.encode.add_classic_features` with ``elmo_bytes``);
    its mask is the key with ``mask`` for ``ids``. Submodules carry the
    Flax module's names: ``chars``, ``conv{width}`` (a ``Conv1d``, weight
    ``[out, in, width]``), ``hw_t{i}``/``hw_h{i}``, ``proj``,
    ``fwd{i}``/``bwd{i}``, ``mix``."""

    def __init__(self, char_vocab_size: int, char_dim: int = 16,
                 filters: Sequence[Tuple[int, int]] = ((1, 32), (2, 32),
                                                       (3, 64)),
                 n_highway: int = 2, proj_dim: int = 64, num_layers: int = 2,
                 mode: str = "all", cell_dim: Optional[int] = None,
                 conv_activation: str = "tanh", lstm_clip: float = 3.0,
                 input_key: str = "char_ids", device=None):
        super().__init__()
        if mode not in ("all", "top", "average", "mix"):
            raise ValueError(f"unknown ELMo mode {mode!r}")
        self.char_vocab_size = char_vocab_size
        self.filters = tuple((int(w), int(c)) for w, c in filters)
        self.n_highway = n_highway
        self.proj_dim = proj_dim
        self.num_layers = num_layers
        self.mode = mode
        self.cell_dim = cell_dim
        self.conv_activation = conv_activation
        self.input_key = input_key
        self.chars = nn.Embedding(char_vocab_size, char_dim, device=device)
        for width, channels in self.filters:
            self.add_module(f"conv{width}", nn.Conv1d(
                char_dim, channels, width, device=device))
        n_filters = sum(c for _, c in self.filters)
        for i in range(n_highway):
            self.add_module(f"hw_t{i}", _dense(n_filters, n_filters, device))
            self.add_module(f"hw_h{i}", _dense(n_filters, n_filters, device))
        self.proj = _dense(n_filters, proj_dim, device)
        for i in range(num_layers):
            for d, reverse in (("fwd", False), ("bwd", True)):
                self.add_module(f"{d}{i}", ELMoLSTMP(
                    proj_dim, cell_dim, proj_dim, lstm_clip, reverse,
                    device=device) if self.bilm else FlaxLSTM(
                    proj_dim, proj_dim, reverse, device=device))
        self.mix = (ScalarMix(num_layers + 1, device=device)
                    if mode == "mix" else None)

    @property
    def bilm(self) -> bool:
        return self.cell_dim is not None

    @property
    def out_dim(self) -> int:
        per_layer = 2 * self.proj_dim
        return per_layer * (self.num_layers + 1) if self.mode == "all" \
            else per_layer

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Flax's draws: the table normal(0, 1/D), convolutions and dense
        layers lecun-normal with zero biases, the LSTMs as their own
        ``reset_parameters``."""
        embed_normal_(self.chars.weight, gen)
        for width, _ in self.filters:
            conv = getattr(self, f"conv{width}")
            lecun_normal_(conv.weight, conv.weight[0].numel(), gen)
            conv.bias.zero_()
        for i in range(self.n_highway):
            reset_dense_(getattr(self, f"hw_t{i}"), gen)
            reset_dense_(getattr(self, f"hw_h{i}"), gen)
        reset_dense_(self.proj, gen)
        for i in range(self.num_layers):
            getattr(self, f"fwd{i}").reset_parameters(gen)
            getattr(self, f"bwd{i}").reset_parameters(gen)
        if self.mix is not None:
            self.mix.reset_parameters(gen)

    def tokens(self, batch: Batch) -> torch.Tensor:
        """The character CNN, highways and projection: ``[B, W, proj]``."""
        char_ids = batch[self.input_key].long().clamp(
            0, self.char_vocab_size - 1)
        B, W, C = char_ids.shape
        x = self.chars(char_ids.reshape(B * W, C)).transpose(1, 2)
        m = batch[self.input_key.replace("ids", "mask")].reshape(
            B * W, C).bool()
        act = torch.tanh if self.conv_activation == "tanh" else torch.relu
        pooled = []
        for width, _ in self.filters:
            conv = getattr(self, f"conv{width}")
            if self.bilm:
                pooled.append(torch.amax(act(conv(x)), dim=2))
                continue
            lo = (width - 1) // 2  # SAME: the odd pad goes right
            h = act(conv(F.pad(x, (lo, width - 1 - lo))))  # [BW, ch, C]
            pooled.append(torch.amax(h.masked_fill(~m[:, None, :],
                                                   float("-inf")), dim=2))
        tok = torch.cat(pooled, dim=-1)
        if not self.bilm:  # words of no character
            tok = torch.where(m.any(-1)[:, None], tok, 0.0)
        for i in range(self.n_highway):
            t = torch.sigmoid(getattr(self, f"hw_t{i}")(tok))
            h = torch.relu(getattr(self, f"hw_h{i}")(tok))
            tok = t * h + (1.0 - t) * tok
        return self.proj(tok).reshape(B, W, self.proj_dim)

    def forward(self, batch: Batch) -> torch.Tensor:
        return self.contextual(self.tokens(batch), batch["word_mask"])

    def contextual(self, tok: torch.Tensor, word_mask: torch.Tensor
                   ) -> torch.Tensor:
        """The bi-LM over the tokens ``[B, W, proj]`` and the layers
        combined by ``mode``, zero at pad words."""
        lengths = word_mask.sum(-1)
        layers = [torch.cat([tok, tok], dim=-1)]
        h_f = h_b = tok
        for i in range(self.num_layers):
            fwd = getattr(self, f"fwd{i}")(h_f, lengths)
            bwd = getattr(self, f"bwd{i}")(h_b, lengths)
            layers.append(torch.cat([fwd, bwd], dim=-1))
            if self.bilm:
                h_f, h_b = fwd + h_f, bwd + h_b
            else:
                h_f = h_b = fwd + bwd
        if self.mode == "all":
            out = torch.cat(layers, dim=-1)
        elif self.mode == "top":
            out = layers[-1]
        elif self.mode == "average":
            out = sum(layers) / len(layers)
        else:
            out = self.mix(torch.stack(layers))
        return out * word_mask[:, :, None].to(out.dtype)

    # -- weight files ---------------------------------------------------------

    def save_npz(self, path: Union[str, Path]) -> None:
        """The member's Flax tree flattened to ``a/b/c`` keys in an npz
        (the layout ``kbner_tpu``'s ``ELMoEmbedder.save_npz`` writes for
        the member's subtree)."""
        np.savez(path, **_flatten(self._tree()))

    @torch.no_grad()
    def load_npz(self, path: Union[str, Path]) -> None:
        """Every parameter from an npz of ``a/b/c`` keys (written by
        either package, for the member's subtree or under ``params/``);
        a missing key or another shape raises."""
        with np.load(path) as data:
            def leaf(key, like):
                name = key if key in data.files else f"params/{key}"
                if name not in data.files:
                    raise KeyError(f"{path}: no array {key!r}")
                arr = data[name]
                if arr.shape != like.shape:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {like.shape}")
                return arr

            flat = {k: leaf(k, v) for k, v in _flatten(self._tree()).items()}
        self._load_tree(_unflatten(flat))

    @torch.no_grad()
    def load_hdf5(self, path: Union[str, Path]) -> Dict:
        """Published ELMo weights (bilm-tf's ``elmo_*_weights.hdf5``, as
        allennlp reads them) into a bilm-tf-topology member, read by
        :mod:`.hdf5` without ``h5py``. Every array is a direct copy (the
        member is in tf's conventions), the convolutions' leading
        singleton squeezed, each checked against the member's shape.
        Keys: ``char_embed``, ``CNN/W_cnn_i|b_cnn_i``,
        ``CNN_high_k/W_carry|b_carry|W_transform|b_transform``,
        ``CNN_proj/W_proj|b_proj`` and
        ``RNN_{0,1}/RNN/MultiRNNCell/Cell{L}/LSTMCell/W_0|B|W_P_0``
        (``RNN_0`` the forward LM). Returns the member's Flax tree."""
        from .hdf5 import HDF5File

        tree = self._tree()

        def put(dst, arr):
            node = tree
            for k in dst[:-1]:
                node = node[k]
            want = node[dst[-1]].shape
            arr = np.asarray(arr, np.float32)
            if arr.shape != want:
                raise ValueError(f"{'/'.join(dst)}: file {arr.shape} vs "
                                 f"model {want}")
            node[dst[-1]] = arr

        with HDF5File(path) as f:
            put(("chars", "embedding"), f["char_embed"])
            for i in sorted(int(k.rsplit("_", 1)[1]) for k in f["CNN"]
                            if k.startswith("W_cnn_")):
                kernel = np.asarray(f[f"CNN/W_cnn_{i}"])
                if kernel.ndim == 4:  # tf's conv2d [1, w, in, out]
                    kernel = kernel[0]
                width = kernel.shape[0]
                put((f"conv{width}", "kernel"), kernel)
                put((f"conv{width}", "bias"), f[f"CNN/b_cnn_{i}"])
            k = 0
            while f"CNN_high_{k}" in f:
                g = f[f"CNN_high_{k}"]
                put((f"hw_t{k}", "kernel"), g["W_carry"])
                put((f"hw_t{k}", "bias"), g["b_carry"])
                put((f"hw_h{k}", "kernel"), g["W_transform"])
                put((f"hw_h{k}", "bias"), g["b_transform"])
                k += 1
            put(("proj", "kernel"), f["CNN_proj/W_proj"])
            put(("proj", "bias"), f["CNN_proj/b_proj"])
            for d, prefix in ((0, "fwd"), (1, "bwd")):
                layer = 0
                while f"RNN_{d}/RNN/MultiRNNCell/Cell{layer}" in f:
                    g = f[f"RNN_{d}/RNN/MultiRNNCell/Cell{layer}/LSTMCell"]
                    for leaf in ("W_0", "B", "W_P_0"):
                        put((f"{prefix}{layer}", leaf), g[leaf])
                    layer += 1
        self._load_tree(tree)
        return tree

    def _tree(self) -> Dict:
        from .. import weights
        return weights.member_to_jax_params(self.state_dict(), self)

    def _load_tree(self, tree: Dict) -> None:
        from .. import weights
        self.load_state_dict(weights.member_from_jax_params(tree, self))


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


# -- BPEmb ------------------------------------------------------------------------

class BPEVocab:
    """Subword pieces and their vectors for :class:`BPEmbEmbedder`, in
    SentencePiece's convention (``▁`` opens a word, text lowercased); a
    word is cut by greedy longest match over the pieces. Read BPEmb's
    word2vec text files with :meth:`from_w2v_text`, or make an inventory
    from a corpus with :meth:`build`."""

    def __init__(self, pieces: Dict[str, int], matrix: np.ndarray):
        if "<unk>" not in pieces:
            raise ValueError("piece inventory must reserve '<unk>'")
        self.pieces = pieces
        self.matrix = matrix
        self._max_len = max((len(p) for p in pieces), default=1)

    @property
    def dim(self) -> int:
        return self.matrix.shape[1]

    @classmethod
    def from_w2v_text(cls, path) -> "BPEVocab":
        vocab, matrix = WordEmbedder.load_pretrained_text(path)
        return cls(vocab, matrix)

    @classmethod
    def build(cls, records, dim: int = 25, max_words: int = 2000,
              seed: int = 0) -> "BPEVocab":
        """Every character of the corpus (as ``▁c`` and ``c``) and its
        ``max_words`` most frequent lowercased words as ``▁word``; vectors
        normal(0, 0.1) from ``default_rng(seed)``, ``<unk>`` zero."""
        from collections import Counter
        counts: Counter = Counter()
        chars = set()
        for rec in records:
            for tok in rec.tokens:
                low = tok.lower()
                counts[low] += 1
                chars.update(low)
        pieces = {"<unk>": 0}
        for ch in sorted(chars):
            for form in (f"▁{ch}", ch):
                pieces.setdefault(form, len(pieces))
        for word, _ in counts.most_common(max_words):
            pieces.setdefault(f"▁{word}", len(pieces))
        rng = np.random.default_rng(seed)
        matrix = rng.normal(0, 0.1, (len(pieces), dim)).astype(np.float32)
        matrix[0] = 0.0
        return cls(pieces, matrix)

    def segment(self, word: str) -> List[int]:
        """The word's piece ids by greedy longest match (a character no
        piece starts with is ``<unk>``); never empty."""
        text = "▁" + word.lower()
        out: List[int] = []
        i = 0
        while i < len(text):
            for ln in range(min(self._max_len, len(text) - i), 0, -1):
                idx = self.pieces.get(text[i:i + ln])
                if idx is not None:
                    out.append(idx)
                    i += ln
                    break
            else:
                out.append(0)
                i += 1
        return out

    def encode_first_last(self, eb) -> Tuple[np.ndarray, np.ndarray]:
        """Each word's first and last piece ids, int32 ``[B, W]``."""
        B, W = eb.word_mask.shape
        first = np.zeros((B, W), dtype=np.int32)
        last = np.zeros((B, W), dtype=np.int32)
        for b, rec in enumerate(eb.records):
            for w, tok in enumerate(rec.tokens[:W]):
                ids = self.segment(tok)
                first[b, w] = ids[0]
                last[b, w] = ids[-1]
        return first, last


class BPEmbEmbedder(nn.Module):
    """Each word's first and last piece vectors side by side (``2 * dim``
    wide) from ``bpe_first_ids``/``bpe_last_ids``; frozen unless
    ``trainable``."""

    def __init__(self, piece_vocab_size: int, dim: int = 25,
                 trainable: bool = True, device=None):
        super().__init__()
        self.trainable = trainable
        self.table = nn.Embedding(piece_vocab_size, dim, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_normal_(self.table.weight, gen)

    def forward(self, batch: Batch) -> torch.Tensor:
        out = torch.cat([self.table(batch["bpe_first_ids"].long()),
                         self.table(batch["bpe_last_ids"].long())], dim=-1)
        return out if self.trainable else out.detach()


# -- pooled Flair tables ----------------------------------------------------------

@torch.no_grad()
def build_pooled_flair_table(flair_embedder: FlairLMEmbedder, records,
                             tokenizer, char_vocab, pooling: str = "mean",
                             batch_size: int = 32):
    """A Flair member's features over a corpus, pooled per word type by
    ``mean``, ``min`` or ``max`` (the reference's ``PooledFlairEmbeddings``
    as a precomputed table): batches of ``batch_size`` sentences in corpus
    order run on the member's device, and the host sums in float64.
    Returns ``(vocabulary, [V, 2H] float32)`` over a
    ``Dictionary(add_unk=True)`` of the corpus's words; a word never seen
    gets zeros."""
    from ..data.dictionary import Dictionary
    from ..data.encode import add_classic_features, encode_batch

    if pooling not in ("mean", "min", "max"):
        raise ValueError(f"unknown pooling {pooling!r}")
    vocab = Dictionary(add_unk=True)
    for rec in records:
        for tok in rec.tokens:
            vocab.add_item(tok)
    dim = 2 * flair_embedder.fwd.lstm.hidden
    sums = np.zeros((len(vocab), dim), dtype=np.float64)
    counts = np.zeros(len(vocab), dtype=np.int64)
    mins = np.full((len(vocab), dim), np.inf)
    maxs = np.full((len(vocab), dim), -np.inf)
    device = flair_embedder.fwd.embed.weight.device
    for i in range(0, len(records), batch_size):
        chunk = records[i:i + batch_size]
        eb = add_classic_features(encode_batch(chunk, tokenizer, None), None,
                                  char_vocab)
        feats = flair_embedder({k: torch.from_numpy(v).to(device)
                                for k, v in eb.arrays().items()})
        feats = feats.cpu().numpy()
        for b, rec in enumerate(chunk):
            for w, tok in enumerate(rec.tokens[:feats.shape[1]]):
                v = vocab.get_idx_for_item(tok)
                sums[v] += feats[b, w]
                counts[v] += 1
                np.minimum(mins[v], feats[b, w], out=mins[v])
                np.maximum(maxs[v], feats[b, w], out=maxs[v])
    seen = counts > 0
    table = {"mean": sums / np.maximum(counts, 1)[:, None], "min": mins,
             "max": maxs}[pooling]
    return vocab, np.where(seen[:, None], table, 0.0).astype(np.float32)
