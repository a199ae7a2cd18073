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
  - :class:`ScalarMix`: a softmax-weighted sum of layers.

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
from typing import Dict, List, Optional, Sequence, Tuple

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
