"""The ``tokenizer.json`` types beyond XLM-R's in the port's reader
(``kbner_tpu_torch.data.HFTokenizer``), against ``kbner_tpu.data.HFTokenizer``
(``transformers``' ``AutoTokenizer`` over the ``tokenizers`` library): the
ByteLevel pre-tokenizer, normalizer and BPE (RoBERTa, GPT-2), WordPiece
behind ``BertNormalizer`` and ``BertPreTokenizer``, ``WordLevel``, byte
fallback, BPE dropout, ``Split`` over Onig regexes with every behavior,
``Punctuation``, ``Digits``, ``CharDelimiterSplit``, ``StripAccents``,
``Prepend``, ``Nmt``, and the options ``transformers`` rewrites
(``add_prefix_space``, ``do_lower_case``). Each case writes its directory
under ``tmp_path`` with ``tokenizers`` (the seeded RoBERTa- and mBERT-shaped
ones with the port's ``synth_tokenizer``) and loads it with both packages;
ids, special ids and ``vocab_size`` must be equal, word for word, over
``sample_words(2000)`` and the trap words below (U+001C-U+001F, NBSP, CJK,
accents under each ``lowercase``, contractions, digit runs, characters
only byte fallback covers, over-long words), and over sentences.
"""

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

from kbner_tpu.data.subword import HFTokenizer as JHFTokenizer  # noqa: E402
from kbner_tpu_torch.data import HFTokenizer  # noqa: E402
from kbner_tpu_torch.data import hf_tokenizer as hf  # noqa: E402
from kbner_tpu_torch.data import synth_tokenizer as st  # noqa: E402

WORDS = st.sample_words(2000, seed=0)
TRAPS = [
    "a\x1cb", "\x1c", "x\x1dy\x1ez\x1f", "a\x1f", "\x1e\x1e", "a\xa0b",
    "\xa0", "a b", "　x", "a\tb", "a\nb", "\r", "a\x0bb", "a\x0cb",
    "a\x85b", "​", "a​b", "﻿", "▁", "�", "\x00",
    "a\x00b", "\x7f", "\x8f", " ",
    "中文字", "東京タワー", "漢字かな", "㐀䶿", "\U00020000",
    "豈", "한국어",
    "Café", "CAFÉ", "naïve", "ÉCOLE", "é", "Ångström", "Ωμέγα",
    "Straße", "İstanbul", "ǅemal", "ͅ", "ᳲa",
    "'s", "it's", "IT'S", "we'll", "I'M", "'LL", "you're", "they've",
    "she'd", "'", "''", "o'neill", "ſ's", "'ſ", "K",
    "1234567", "12a345", "3.14159", "1,000,000", "٣٤٥", "१२३", "¹²³", "½",
    "Ⅻ", "①②", "𝟙𝟚",
    "<0x41>", "<0xE4>", "☃", "𝔘𝔫𝔦", "😀", "👍🏽", "\U0001f970", "ꙮ", "𐍈",
    "\U0001e030", "\U000e0001",
    "a" * 101, "b" * 150, "supercalifragilistic", "x" * 9, "é" * 30,
    "hello-world", "e-mail", "a--b", "$100", "€5", "50%", "C++", "a/b",
    "(x)", "[y]", "…", "«quote»", "¿qué?", "¡hola!", "「括弧」", "x・y",
    "a.b.c", "...", "U.S.A.", "mid­dot", "word’s", "—",
]


def _train(d, model, trainer, normalizer=None, pre_tokenizer=None,
           config=None, edit=None, corpus=None):
    """Train ``model`` with ``trainer`` behind ``normalizer`` and
    ``pre_tokenizer`` on the seeded words and a few sentences, save it under
    ``d`` with ``config`` as ``tokenizer_config.json``; ``edit`` changes
    the saved JSON."""
    from tokenizers import Tokenizer

    d.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer(model)
    if normalizer is not None:
        tok.normalizer = normalizer
    if pre_tokenizer is not None:
        tok.pre_tokenizer = pre_tokenizer
    tok.train_from_iterator(corpus or (WORDS[::2] + [
        "alice visited berlin yesterday", "it's what we'll do, isn't it?",
        "Café au lait costs 3.50 € in Zürich", "東京タワー 中文 한국어"]),
        trainer)
    tok.save(str(d / "tokenizer.json"))
    if edit is not None:
        spec = json.loads((d / "tokenizer.json").read_text())
        edit(spec)
        (d / "tokenizer.json").write_text(json.dumps(spec))
    (d / "tokenizer_config.json").write_text(json.dumps(config or {
        "tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
        "pad_token": "<pad>", "cls_token": "<s>", "sep_token": "</s>"}))
    return d


SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
BERT_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _byte_level_bpe(file_prefix=True, config=None, use_regex=True,
                    dropout=None, vocab_size=900, edit=None):
    def write(d):
        from tokenizers import models, pre_tokenizers, trainers

        return _train(
            d, models.BPE(dropout=dropout), trainers.BpeTrainer(
                vocab_size=vocab_size, special_tokens=SPECIALS,
                initial_alphabet=pre_tokenizers.ByteLevel.alphabet()),
            pre_tokenizer=pre_tokenizers.ByteLevel(
                add_prefix_space=file_prefix, use_regex=use_regex),
            config=config or {"tokenizer_class": "RobertaTokenizer"},
            edit=edit)
    return write


def _split_pipeline(pre, model="wordlevel", normalizer=None, config=None):
    """A WordLevel (each piece whole, so any boundary moves an id) or BPE
    model behind the pre-tokenizer ``pre()``."""
    def write(d):
        from tokenizers import models, trainers

        if model == "wordlevel":
            m = models.WordLevel(unk_token="<unk>")
            tr = trainers.WordLevelTrainer(special_tokens=SPECIALS)
        else:
            m = models.BPE(unk_token="<unk>")
            tr = trainers.BpeTrainer(vocab_size=700, special_tokens=SPECIALS)
        return _train(d, m, tr, normalizer=normalizer and normalizer(),
                      pre_tokenizer=pre(), config=config)
    return write


def _regex_split(pattern, behavior, invert=False, **kw):
    def pre():
        from tokenizers import Regex, pre_tokenizers

        return pre_tokenizers.Split(Regex(pattern), behavior, invert=invert)
    return _split_pipeline(pre, **kw)


def _pre(name, **args):
    def pre():
        from tokenizers import pre_tokenizers

        return getattr(pre_tokenizers, name)(**args)
    return pre


def _pre_seq(*parts):
    def pre():
        from tokenizers import pre_tokenizers

        return pre_tokenizers.Sequence([part() for part in parts])
    return pre


def _replace_regex(pattern, content):
    def make():
        from tokenizers import Regex, normalizers

        return normalizers.Replace(Regex(pattern), content)
    return make


def _norm(*steps):
    """A Sequence of ``(name, kwargs)`` normalizers."""
    def make():
        from tokenizers import normalizers

        return normalizers.Sequence([getattr(normalizers, n)(**a)
                                     for n, a in steps])
    return make


def _wordpiece(normalizer=None, config=None, max_chars=None,
               pre_tokenizer=None):
    def write(d):
        from tokenizers import models, normalizers, pre_tokenizers, trainers

        edit = None
        if max_chars is not None:
            def edit(spec):
                spec["model"]["max_input_chars_per_word"] = max_chars
        return _train(
            d, models.WordPiece(unk_token="[UNK]"), trainers.WordPieceTrainer(
                vocab_size=800, special_tokens=BERT_SPECIALS),
            normalizer=normalizer() if normalizer else
            normalizers.BertNormalizer(lowercase=False),
            pre_tokenizer=pre_tokenizer() if pre_tokenizer else
            pre_tokenizers.BertPreTokenizer(),
            config=config or {"tokenizer_class": "BertTokenizer",
                              "do_lower_case": False}, edit=edit)
    return write


def _bert_normalizer(**kw):
    def make():
        from tokenizers import normalizers

        return normalizers.BertNormalizer(**kw)
    return make


def _with_byte_pieces(every=3, fuse=False):
    """BPE on a small alphabet with ``<0xNN>`` pieces for two bytes in
    three (so some chars still fall to the unk token)."""
    def edit(spec):
        vocab = spec["model"]["vocab"]
        for b in range(256):
            if b % every:
                vocab.setdefault(f"<0x{b:02X}>", len(vocab))
        spec["model"].update(byte_fallback=True, fuse_unk=fuse)

    def write(d):
        from tokenizers import models, pre_tokenizers, trainers

        return _train(d, models.BPE(unk_token="<unk>"), trainers.BpeTrainer(
            vocab_size=400, special_tokens=SPECIALS, limit_alphabet=40),
            pre_tokenizer=pre_tokenizers.Whitespace(), edit=edit)
    return write


def _unigram_byte_fallback(d):
    """The synth XLM-R-shaped Unigram with ``<0xNN>`` pieces for two bytes
    in three and ``byte_fallback``."""
    spec = st.tokenizer_spec(3000, seed=1, charsmap=0)
    vocab = spec["model"]["vocab"]
    mask = vocab.pop()
    vocab += [[f"<0x{b:02X}>", -20.0] for b in range(256) if b % 3]
    vocab.append(mask)
    spec["added_tokens"][-1]["id"] = len(vocab) - 1
    spec["model"]["byte_fallback"] = True
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "XLMRobertaTokenizer"}))
    return d


def _roberta_synth(config=None):
    def write(d):
        st.write_roberta_like_tokenizer(d, n_merges=6000, seed=2)
        if config is not None:
            (d / "tokenizer_config.json").write_text(json.dumps(config))
        return d
    return write


def _mbert_synth(config=None):
    def write(d):
        st.write_mbert_like_tokenizer(d, n_pieces=12_000, seed=2)
        if config is not None:
            (d / "tokenizer_config.json").write_text(json.dumps(config))
        return d
    return write


LLAMA3 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
          r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _tiktoken_style(d):
    """Llama 3's Split regex, isolated, then ByteLevel without its own
    regex or prefix: the tiktoken-converted layout."""
    from tokenizers import Regex, models, pre_tokenizers, trainers

    return _train(d, models.BPE(), trainers.BpeTrainer(
        vocab_size=900, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()),
        pre_tokenizer=pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(LLAMA3), "isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False,
                                     use_regex=False)]),
        config={"tokenizer_class": "PreTrainedTokenizerFast",
                "bos_token": "<s>", "eos_token": "</s>"})


def _byte_level_normalizer(d):
    """The ByteLevel normalizer with a Split on its space char (``Ġ``),
    merged with the next piece."""
    from tokenizers import models, normalizers, pre_tokenizers, trainers

    return _train(d, models.BPE(), trainers.BpeTrainer(
        vocab_size=700, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()),
        normalizer=normalizers.ByteLevel(),
        pre_tokenizer=pre_tokenizers.Split("Ġ", "merged_with_next"))


CASES = {
    # 1. transformers' classes: defaults and rewrites
    "roberta_prefix_rewritten_false": _byte_level_bpe(file_prefix=True),
    "roberta_prefix_from_config": _byte_level_bpe(
        file_prefix=False, config={"tokenizer_class": "RobertaTokenizer",
                                   "add_prefix_space": True}),
    "roberta_fast_mask_from_config": _byte_level_bpe(
        config={"tokenizer_class": "RobertaTokenizerFast",
                "mask_token": "<mask>"},
        edit=lambda s: s.update(added_tokens=s["added_tokens"][:4])),
    "gpt2_no_cls_sep_pad": _byte_level_bpe(
        config={"tokenizer_class": "GPT2Tokenizer"}),
    "model_type_roberta": _byte_level_bpe(config={}),
    "bert_lowercase_rewritten": _wordpiece(
        config={"tokenizer_class": "BertTokenizer"}),
    "bert_strip_accents_rewritten": _wordpiece(
        config={"tokenizer_class": "BertTokenizer", "do_lower_case": False,
                "strip_accents": True, "tokenize_chinese_chars": False}),
    "bert_sequence_normalizer_kept": _wordpiece(
        normalizer=_norm(("NFD", {}), ("Lowercase", {}),
                         ("StripAccents", {})),
        config={"tokenizer_class": "BertTokenizer"}),
    # 2. ByteLevel
    "bytelevel_no_regex": _byte_level_bpe(
        use_regex=False, config={"tokenizer_class": "RobertaTokenizer",
                                 "add_prefix_space": True}),
    "bytelevel_normalizer": _byte_level_normalizer,
    "roberta_synth": _roberta_synth(),
    # 3-4. Onig regexes and the other pre-tokenizers
    "tiktoken_llama3_split": _tiktoken_style,
    "split_whitespace_removed": _regex_split(r"\s+", "removed"),
    "split_punct_isolated": _regex_split(r"[\p{P}\p{S}]", "isolated"),
    "split_merged_with_previous": _regex_split(r"\p{P}+",
                                               "merged_with_previous"),
    "split_merged_with_next": _regex_split(r"[\p{Lu}\d]",
                                           "merged_with_next"),
    "split_contiguous": _regex_split(r"\p{N}", "contiguous"),
    "split_invert": _regex_split(r"\w+|[^\w\s]+", "removed", invert=True),
    "split_lookahead_interval": _regex_split(
        r"\p{L}{1,3}(?=\p{L})|\P{L}", "isolated", model="bpe"),
    "split_string": _split_pipeline(_pre(
        "Split", pattern="-", behavior="merged_with_previous"), model="bpe"),
    "punctuation_contiguous": _split_pipeline(_pre(
        "Punctuation", behavior="contiguous")),
    "punctuation_isolated_bpe": _split_pipeline(_pre("Punctuation"),
                                                model="bpe"),
    "digits_individual": _split_pipeline(_pre(
        "Digits", individual_digits=True)),
    "digits_grouped": _split_pipeline(_pre("Digits")),
    "char_delimiter": _split_pipeline(_pre("CharDelimiterSplit",
                                           delimiter="a")),
    "bert_pre_tokenizer_wordlevel": _split_pipeline(_pre("BertPreTokenizer")),
    "unicode_scripts_wordlevel": _split_pipeline(_pre("UnicodeScripts")),
    "unicode_scripts_after_whitespace": _split_pipeline(_pre_seq(
        _pre("WhitespaceSplit"), _pre("UnicodeScripts")), model="bpe"),
    # 5. normalizers
    "bert_normalizer_lowercase": _wordpiece(
        normalizer=_bert_normalizer(lowercase=True),
        config={"tokenizer_class": "PreTrainedTokenizerFast",
                "unk_token": "[UNK]"}),
    "bert_normalizer_keep_accents": _wordpiece(
        normalizer=_bert_normalizer(lowercase=True, strip_accents=False),
        config={"tokenizer_class": "PreTrainedTokenizerFast",
                "unk_token": "[UNK]"}),
    "bert_normalizer_raw": _wordpiece(
        normalizer=_bert_normalizer(clean_text=False,
                                    handle_chinese_chars=False,
                                    lowercase=False, strip_accents=True),
        config={"tokenizer_class": "PreTrainedTokenizerFast",
                "unk_token": "[UNK]"}),
    "strip_accents_prepend_nmt": _split_pipeline(
        _pre("WhitespaceSplit"), model="bpe", normalizer=_norm(
            ("Nmt", {}), ("NFD", {}), ("StripAccents", {}),
            ("Prepend", {"prepend": "▁"}))),
    "replace_onig_regex": _split_pipeline(
        _pre("WhitespaceSplit"), model="bpe",
        normalizer=_replace_regex(r"\s+|\p{Pd}", "▁")),
    # 6. models
    "wordpiece_max_chars": _wordpiece(max_chars=8),
    "mbert_synth": _mbert_synth(),
    "mbert_synth_uncased": _mbert_synth(
        config={"tokenizer_class": "BertTokenizerFast"}),
    "wordlevel_whitespace": _split_pipeline(_pre("Whitespace")),
    # 7. byte fallback
    "bpe_byte_fallback": _with_byte_pieces(),
    "bpe_byte_fallback_fused": _with_byte_pieces(fuse=True),
    "unigram_byte_fallback": _unigram_byte_fallback,
    # 8. dropout 1.0: no merge is ever taken
    "bpe_dropout_one": _byte_level_bpe(dropout=1.0),
}


def _both(d):
    return JHFTokenizer(str(d)), HFTokenizer(str(d))


def _ids(tok, word):
    try:
        return tok.encode_word(word)
    except Exception as e:  # noqa: BLE001 (a refusal is compared too)
        return type(e)


def _assert_same(j, p, words):
    assert (p.cls_id, p.sep_id, p.pad_id, p.vocab_size) == (
        j.cls_id, j.sep_id, j.pad_id, j.vocab_size)
    bad = []
    for w in words:
        want, got = _ids(j, w), _ids(p, w)
        if want != got and not (isinstance(want, type) and isinstance(
                got, type)):
            bad.append((w, want, got))
    assert not bad, bad[:5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ids_equal_the_jax_tokenizer(case, tmp_path):
    j, p = _both(CASES[case](tmp_path / case))
    _assert_same(j, p, WORDS + TRAPS)
    rng = random.Random(0)
    texts = [" ".join(rng.sample(WORDS, 8)) for _ in range(60)] + [
        " ".join(rng.sample(TRAPS, 6)) for _ in range(40)]
    assert [p._tok.encode(t) for t in texts] == [
        j._tok.encode(t, add_special_tokens=False) for t in texts]


def test_the_rewrites_change_ids(tmp_path):
    """The ``add_prefix_space`` and ``do_lower_case`` rewrites are not
    no-ops here: the file as saved gives other ids than it does as
    ``transformers`` rebuilds it."""
    d = _byte_level_bpe(file_prefix=True)(tmp_path / "rob")
    saved = hf.TokenizerJson.from_file(d / "tokenizer.json")
    built, _ = hf.load_pretrained(d)
    assert saved.encode("Hello") != built.encode("Hello")
    d = _wordpiece(config={"tokenizer_class": "BertTokenizer"})(
        tmp_path / "bert")
    saved = hf.TokenizerJson.from_file(d / "tokenizer.json")
    built, _ = hf.load_pretrained(d)
    assert saved.encode(" Café") != built.encode(" Café")


def test_bert_class_without_a_normalizer_raises_in_both(tmp_path):
    d = _wordpiece(normalizer=lambda: None)(tmp_path / "bert")
    with pytest.raises(TypeError):
        JHFTokenizer(str(d))
    with pytest.raises(ValueError, match="normalizer"):
        HFTokenizer(str(d))


def test_full_size_synth_directories(tmp_path):
    """The card smoke's directories at their published sizes: RoBERTa's
    50,265 ids (50,004 merges, ``<mask>`` last) and mBERT's 119,547
    (``[UNK] [CLS] [SEP] [MASK]`` at 100-103), each with the JAX
    tokenizer's ids."""
    rob = st.write_roberta_like_tokenizer(tmp_path / "rob")
    bert = st.write_mbert_like_tokenizer(tmp_path / "bert")
    spec = json.loads((rob / "tokenizer.json").read_text())
    assert len(spec["model"]["merges"]) == 50_004
    for d, size, specials in ((rob, 50_265, (0, 2, 1)),
                              (bert, 119_547, (101, 102, 0))):
        j, p = _both(d)
        assert p.vocab_size == size
        assert (p.cls_id, p.sep_id, p.pad_id) == specials
        _assert_same(j, p, WORDS[:500] + TRAPS)
    assert HFTokenizer(str(rob)).encode_word("<mask>") == [50_264]


def test_bpe_dropout_draws(tmp_path):
    """Dropout 0.3: every draw concatenates back to the word from
    vocabulary pieces; the same seed gives the same ids and another seed
    other ones; a word keeps its first draw in the cache; and the mean
    piece count over 2,000 draws lies within 4 standard errors of the
    library's."""
    from tokenizers import Tokenizer

    d = _byte_level_bpe(dropout=0.3)(tmp_path / "drop")
    word, words = "visited", WORDS[::4]
    p0, p1 = HFTokenizer(str(d), seed=0), HFTokenizer(str(d), seed=0)
    merged = HFTokenizer(str(d))
    merged._tok.model.dropout = 0.0
    inv = {i: t for t, i in p0._tok.model.vocab.items()}
    inv.update({i: t for t, i in p0._tok.added.items()})
    ref = Tokenizer.from_file(str(d / "tokenizer.json"))
    for w in words:
        ids = p0.encode_word(w)
        assert all(i in inv for i in ids)
        assert "".join(inv[i] for i in ids) == "".join(
            inv[i] for i in merged.encode_word(w)), w
        assert p1.encode_word(w) == ids
    assert p0.encode_word(words[3]) is p0.encode_word(words[3])
    other = HFTokenizer(str(d), seed=1)
    assert [other.encode_word(w) for w in words] != [
        p0.encode_word(w) for w in words]
    mine = np.array([len(p0._tok.encode(" " + word)) for _ in range(2000)])
    lib = np.array([len(ref.encode(" " + word).ids) for _ in range(2000)])
    se = np.sqrt(mine.var() / len(mine) + lib.var() / len(lib))
    assert abs(mine.mean() - lib.mean()) < 4 * se, (mine.mean(), lib.mean())
    assert len(set(map(tuple, (p0._tok.encode(" " + word)
                               for _ in range(200))))) > 3


def test_onig_classes_match_the_library():
    """``\\s \\d \\w`` and every one-letter ``\\p{..}`` as the translator
    builds them against the library's Split on each code point that Python
    assigns, plus the U+001C trap and the classes' complements."""
    from tokenizers import Regex, pre_tokenizers

    import unicodedata

    cps = [cp for cp in range(0x110000) if not 0xD800 <= cp < 0xE000
           and unicodedata.category(chr(cp)) != "Cn"]
    # each char between two separators the class does not hold: a char of
    # the class is a piece of its own
    for pat, sep in ((r"\s", "a"), (r"\d", "a"), (r"\w", " "),
                     (r"[\w]", " "), (r"\p{L}", " "), (r"\p{N}", " "),
                     (r"\p{P}", " "), (r"\p{S}", " "), (r"\p{M}", " "),
                     (r"\p{Z}", "a"), (r"\p{C}", "a"), (r"\p{Lu}", " "),
                     (r"\p{Nd}", " "), (r"\S", " "), (r"\W", "a"),
                     (r"[\W]", "a"), (r"\P{L}", "a"),
                     (r"[^\s\p{L}\p{N}]", "a"), (r"[\W\d]", "a")):
        text = sep + sep.join(chr(cp) for cp in cps if chr(cp) != sep) + sep
        lib = pre_tokenizers.Split(Regex(pat), "isolated")
        want = {s for s, _ in lib.pre_tokenize_str(text)
                if len(s) == 1} - {sep}
        rx = hf.onig_regex(pat)
        got = {chr(cp) for cp in cps if rx.fullmatch(chr(cp))} - {sep}
        assert got == want, (pat, sorted(got ^ want)[:10])
    assert not hf.onig_regex(r"\s").search("\x1c\x1d\x1e\x1f")


def test_unicode_scripts_table_matches_the_library():
    """The script table against the library's ``UnicodeScripts`` on every
    code point: all of them in order (each beside its neighbours), and
    each assigned one between two chars of Latin, of Cyrillic, of Han and
    of Kana (read as Han), and after the first code point of its own
    class; the pieces must be equal."""
    from tokenizers import pre_tokenizers

    from kbner_tpu_torch.data import unicode_scripts as us

    import unicodedata

    lib = pre_tokenizers.UnicodeScripts()
    cps = [chr(cp) for cp in range(0x110000) if not 0xD800 <= cp < 0xE000]
    # the interleaved texts over what Python assigns (the in-order text
    # covers the rest)
    named = [c for c in cps if unicodedata.category(c) not in ("Cn", "Co")]
    first = {}
    for c in cps:
        first.setdefault(us.script_class(c), c)
    texts = ["".join(cps)] + ["".join(p + c for c in named) + p
                              for p in ("a", "д", "中", "あ")]
    texts.append("".join(first[us.script_class(c)] + c for c in named))
    for text in texts:
        want = [s for s, _ in lib.pre_tokenize_str(text)]
        got = [t for t, _, _ in hf._unicode_scripts(
            (text, list(range(len(text))), 0))]
        assert got == want


TABLES = {
    # component: (kind, tokenizers class, its arguments)
    "clean_text": ("normalizers", "BertNormalizer", dict(
        clean_text=True, handle_chinese_chars=False, strip_accents=False,
        lowercase=False)),
    "chinese_chars": ("normalizers", "BertNormalizer", dict(
        clean_text=False, handle_chinese_chars=True, strip_accents=False,
        lowercase=False)),
    "bert_strip_accents": ("normalizers", "BertNormalizer", dict(
        clean_text=False, handle_chinese_chars=False, strip_accents=True,
        lowercase=False)),
    "strip_accents": ("normalizers", "StripAccents", {}),
    "nmt": ("normalizers", "Nmt", {}),
    "byte_level": ("normalizers", "ByteLevel", {}),
    "punctuation": ("pre_tokenizers", "Punctuation", {}),
    "bert_pre_tokenizer": ("pre_tokenizers", "BertPreTokenizer", {}),
    "digits": ("pre_tokenizers", "Digits", {}),
}


@pytest.mark.parametrize("what", sorted(TABLES))
def test_character_tables_match_the_library(what):
    """Each component that reads a character table (the unicode_categories
    crate's, unicode-normalization's marks, Rust's ``is_numeric``, the CJK
    blocks, Nmt's and the byte alphabet's) against the library on every
    code point Python assigns, each between two ``a``."""
    import unicodedata

    import tokenizers

    kind, name, args = TABLES[what]
    lib = getattr(getattr(tokenizers, kind), name)(**args)
    named = [chr(cp) for cp in range(0x110000) if not 0xD800 <= cp < 0xE000
             and unicodedata.category(chr(cp)) != "Cn"]
    text = "a" + "a".join(named) + "a"
    spec = dict(args, type=name)
    if kind == "normalizers":
        got = hf.make_normalizer(spec)(text, list(range(len(text))), 0)[0]
        assert got == lib.normalize_str(text)
    else:
        got = [t for t, _, _ in hf.make_pre_tokenizer(spec)(
            (text, list(range(len(text))), 0))]
        assert got == [s for s, _ in lib.pre_tokenize_str(text)]


def test_unicode_16_letters_are_a_known_divergence():
    """Python 3.12's tables are Unicode 15.0: a letter that Unicode 16
    added (U+1C89) is in the library's ``\\p{Lu}`` and unassigned here
    (ROADMAP C lists it)."""
    from tokenizers import Regex, pre_tokenizers

    lib = pre_tokenizers.Split(Regex(r"\p{Lu}"), "isolated")
    assert [s for s, _ in lib.pre_tokenize_str("a\u1c89a")] == [
        "a", "\u1c89", "a"]
    assert not hf.onig_regex(r"\p{Lu}").search("\u1c89")


ONIG_CASES = [
    (r"\s+", ["a\x1cb c", " a  b ", "　x\xa0y"]),
    (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
     r"|\s+(?!\S)|\s+", ["it's  12 o'clock!!  ", "  Zürich\t\n x", "a  "]),
    (LLAMA3, ["I'LL see 12345 you\r\n\r\n  there", "HE'S", "K's"]),
    (r"a*", ["baab", "", "aaa"]),
    (r"a*|b", ["ab", "bab"]),
    (r"(?<=\d)(?=(\d{3})+\b)", ["1234567", "12 1234"]),
    (r"^\w|\w$", ["ab\ncd", "x"]),
    (r"\bfoo\b|\Bbar", ["foo foobar barbar", "foo"]),
    (r"[\x41-\x{5A}é]+|\t", ["ABCdé\tZ", "xyz"]),
    (r"(?<name>x)y|\.|[\]\-]", ["xy.-]", "a]"]),
    (r"\p{^L}+|\p{Lu}{2,}|\d{,2}", ["ABCd 12345", "--"]),
    (r"(?i:ſ)|(?>a+)b|x*+|y?+", ["Sſs", "aab", "xxxyy"]),
    (r"{|}|a{,}|a{2}", ["{a}", "aaa{,}"]),
]


@pytest.mark.parametrize("pat, texts", ONIG_CASES,
                         ids=[str(i) for i in range(len(ONIG_CASES))])
def test_onig_find_iter_matches_the_library(pat, texts):
    """The translated regex's matches, as ``onig_find_iter`` steps over
    them (an empty match right after the last one skipped), against the
    library's ``Split`` spans with the ``isolated`` and ``removed``
    behaviors."""
    from tokenizers import Regex, pre_tokenizers

    rx = hf.onig_regex(pat)
    for behavior in ("isolated", "removed", "merged_with_next",
                     "contiguous"):
        lib = pre_tokenizers.Split(Regex(pat), behavior)
        for text in texts:
            want = [s for s, _ in lib.pre_tokenize_str(text)]
            got = [t for t, _, _ in hf._split(
                (text, list(range(len(text))), 0),
                hf.onig_find_iter(rx, text), hf._behavior(behavior))]
            assert got == want, (pat, behavior, text)


REFUSED = {
    "backreference": r"(a)\1",
    "script property": r"\p{Han}+",
    "posix bracket": r"[[:alpha:]]",
    "class intersection": r"[a-z&&[^aeiou]]",
    "inline option mid-pattern": r"a(?i)b",
    "hex class escape": r"\h+",
    "lookbehind of two widths": r"(?<=a|bc)d",
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_onig_constructs_refused(what):
    """A construct the translator does not read raises
    ``NotImplementedError`` naming the regex, whatever the library makes
    of it."""
    with pytest.raises(NotImplementedError, match="Onig"):
        hf.onig_regex(REFUSED[what])


def test_port_reads_without_the_libraries(tmp_path):
    """The reader and both synth writers load with ``tokenizers``,
    ``transformers``, ``regex``, ``jax``, ``flax`` and ``kbner_tpu``
    blocked (the card machine has none of the first three)."""
    d = tmp_path / "dirs"
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tokenizers", "transformers", "regex",
                                  "jax", "flax", "kbner_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from kbner_tpu_torch.data import synth_tokenizer as st
from kbner_tpu_torch.data.subword import HFTokenizer
rob = HFTokenizer(str(st.write_roberta_like_tokenizer({str(d / 'r')!r},
                                                      n_merges=500)))
bert = HFTokenizer(str(st.write_mbert_like_tokenizer({str(d / 'b')!r},
                                                     n_pieces=2000)))
print(rob.encode_word("it's"), bert.encode_word("Café"))
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("tokenizers", "transformers", "regex", "jax", "flax",
              "kbner_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parent.parent).stdout
    assert out.strip().splitlines()[-1] == "[]"
