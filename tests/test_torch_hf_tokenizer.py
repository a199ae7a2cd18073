"""The port's ``tokenizer.json`` reader (``kbner_tpu_torch.data.HFTokenizer``)
against ``kbner_tpu.data.HFTokenizer``, which runs ``transformers``'
``AutoTokenizer`` over the ``tokenizers`` library. Each case writes its
directory under ``tmp_path`` (with ``tokenizers`` for the BPE fixture, with
the port's ``synth_tokenizer`` for the Unigram ones) and loads it with both;
ids, special ids and ``vocab_size`` must be equal, word for word, over ~2,000
seeded words (punctuation, digits, the empty string, fullwidth forms,
combining marks, Hangul, emoji with ZWJ, regional indicators, ``<mask>``,
``x<mask>``, ``<s>``).
"""

import json
import random

import numpy as np
import pytest

pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

from kbner_tpu.data import encode_batch as j_encode_batch  # noqa: E402
from kbner_tpu.data.conll import SentenceRecord as JRecord  # noqa: E402
from kbner_tpu.data.dictionary import Dictionary as JDictionary  # noqa: E402
from kbner_tpu.data.subword import HFTokenizer as JHFTokenizer  # noqa: E402
from kbner_tpu_torch.data import HFTokenizer  # noqa: E402
from kbner_tpu_torch.data import hf_tokenizer as hf  # noqa: E402
from kbner_tpu_torch.data import synth_tokenizer as st  # noqa: E402
from kbner_tpu_torch.data.conll import SentenceRecord  # noqa: E402
from kbner_tpu_torch.data.dictionary import Dictionary  # noqa: E402
from kbner_tpu_torch.data.encode import encode_batch  # noqa: E402

WORDS = st.sample_words(2000, seed=0)
NFKC_REPLACE = {"type": "Sequence", "normalizers": [
    {"type": "NFKC"},
    {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}


def _metaspace(**kw):
    return {"type": "Metaspace", "replacement": "▁", **kw}


def write_bpe_fixture(d):
    """``tests/test_hf_tokenizer.py``'s fixture: a BPE trained on three
    sentences behind the ``Whitespace`` pre-tokenizer."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    d.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<s>", "<pad>", "</s>", "<unk>"])
    tok.train_from_iterator(
        ["alice visited berlin yesterday",
         "acme corp is a company in new york",
         "the european union met in paris"], trainer)
    tok.save(str(d / "tokenizer.json"))
    json.dump({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
        "pad_token": "<pad>", "cls_token": "<s>", "sep_token": "</s>",
    }, open(d / "tokenizer_config.json", "w"))
    return d


def _unigram(normalizer=NFKC_REPLACE, pre_tokenizer=None, edit=None,
             config=None, n_pieces=3000, charsmap=0):
    def write(d):
        st.write_xlmr_like_tokenizer(
            d, n_pieces=n_pieces, seed=1, charsmap=charsmap,
            normalizer=normalizer, pre_tokenizer=pre_tokenizer)
        if edit is not None:
            spec = json.loads((d / "tokenizer.json").read_text())
            edit(spec)
            (d / "tokenizer.json").write_text(json.dumps(spec))
        for name, content in (config or {}).items():
            (d / name).write_text(json.dumps(content))
        return d
    return write


def _bpe_variant(d):
    """A BPE with a continuing-subword prefix, an end-of-word suffix and
    fused unknowns behind a Lowercase + Strip + NFD normalizer, trained on
    the fixture's sentences and the seeded words."""
    from tokenizers import (Tokenizer, models, normalizers, pre_tokenizers,
                            trainers)

    d.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
    tok.normalizer = normalizers.Sequence([
        normalizers.Lowercase(), normalizers.Strip(), normalizers.NFD()])
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        continuing_subword_prefix="##", end_of_word_suffix="</w>",
        limit_alphabet=80)
    tok.train_from_iterator(WORDS[::3] + [
        "alice visited berlin yesterday",
        "acme corp is a company in new york"], trainer)
    tok.save(str(d / "tokenizer.json"))
    json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
               "unk_token": "<unk>", "pad_token": "<pad>",
               "cls_token": "<s>", "sep_token": "</s>"},
              open(d / "tokenizer_config.json", "w"))
    return d


def _saved_by_transformers(d):
    """The Precompiled case as ``AutoTokenizer.save_pretrained`` writes
    it: ``added_tokens_decoder`` in ``tokenizer_config.json``."""
    from transformers import AutoTokenizer

    src = _unigram(normalizer=None, charsmap=300)(d.parent / "src")
    AutoTokenizer.from_pretrained(str(src), local_files_only=True
                                  ).save_pretrained(str(d))
    assert "added_tokens_decoder" in json.loads(
        (d / "tokenizer_config.json").read_text())
    return d


def _drop_mask(spec):
    spec["added_tokens"] = [t for t in spec["added_tokens"]
                            if t["content"] != "<mask>"]


def _normalized_mask(spec):
    for t in spec["added_tokens"]:
        if t["content"] == "<mask>":
            t.update(normalized=True, special=False)


CASES = {
    # (a) the BPE + Whitespace fixture of tests/test_hf_tokenizer.py
    "bpe_whitespace": write_bpe_fixture,
    "bpe_prefix_fused_lowercase": _bpe_variant,
    # (b) Unigram with NFKC + Replace under each Metaspace schema
    "unigram_always": _unigram(pre_tokenizer=_metaspace(
        prepend_scheme="always", split=True)),
    "unigram_first": _unigram(pre_tokenizer=_metaspace(
        prepend_scheme="first", split=True)),
    "unigram_never": _unigram(pre_tokenizer=_metaspace(
        prepend_scheme="never", split=True)),
    "unigram_always_nosplit": _unigram(pre_tokenizer=_metaspace(
        prepend_scheme="always", split=False)),
    "unigram_legacy_prefix": _unigram(pre_tokenizer=_metaspace(
        add_prefix_space=True)),
    "unigram_legacy_no_prefix": _unigram(pre_tokenizer=_metaspace(
        add_prefix_space=False, prepend_scheme="never")),
    "unigram_split_first": _unigram(pre_tokenizer={
        "type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            _metaspace(prepend_scheme="first", split=True)]}),
    "unigram_whitespace_nfd_lower": _unigram(
        normalizer={"type": "Sequence", "normalizers": [
            {"type": "NFD"}, {"type": "Lowercase"},
            {"type": "Replace", "pattern": {"String": "a"},
             "content": "aa"}]},
        pre_tokenizer={"type": "Sequence", "pretokenizers": [
            {"type": "Whitespace"}, _metaspace(prepend_scheme="always")]}),
    "unigram_nfkd_strip": _unigram(
        normalizer={"type": "Sequence", "normalizers": [
            {"type": "NFKD"}, {"type": "Strip", "strip_left": True,
                               "strip_right": False}, {"type": "NFC"}]},
        pre_tokenizer=_metaspace(prepend_scheme="first")),
    # (c) the synth Precompiled charsmap through the whole tokenizer
    "unigram_precompiled": _unigram(normalizer=None, charsmap=300),
    # the files beside tokenizer.json
    "mask_from_class_defaults": _unigram(edit=_drop_mask),
    "normalized_mask": _unigram(normalizer=None, charsmap=300,
                                edit=_normalized_mask),
    "saved_by_transformers": _saved_by_transformers,
    "special_tokens_map": _unigram(config={
        "tokenizer_config.json": {
            "tokenizer_class": "PreTrainedTokenizerFast"},
        "special_tokens_map.json": {
            "cls_token": "</s>", "sep_token": {"content": "<s>"},
            "pad_token": "<unk>", "unk_token": "<unk>",
            "mask_token": {"content": "<mask>", "lstrip": True},
            "additional_special_tokens": ["<extra>"]}}),
}


def _both(d):
    return JHFTokenizer(str(d)), HFTokenizer(str(d))


def _assert_same(j, p, words):
    assert (p.cls_id, p.sep_id, p.pad_id, p.vocab_size) == (
        j.cls_id, j.sep_id, j.pad_id, j.vocab_size)
    bad = [(w, j.encode_word(w), p.encode_word(w)) for w in words
           if j.encode_word(w) != p.encode_word(w)]
    assert not bad, bad[:5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ids_equal_the_jax_tokenizer(case, tmp_path):
    j, p = _both(CASES[case](tmp_path / case))
    _assert_same(j, p, WORDS)
    assert all(p.word_length(w) == len(p.encode_word(w)) for w in WORDS)
    # sentences as one text, through both libraries' encode
    rng = random.Random(0)
    texts = [" ".join(rng.sample(WORDS, 8)) for _ in range(100)]
    assert [p._tok.encode(t) for t in texts] == [
        j._tok.encode(t, add_special_tokens=False) for t in texts]


def test_precompiled_charsmap_matches_tokenizers():
    """(c) the synth charsmap's normalization against the library's
    ``normalizers.Precompiled`` on seeded strings: words, and random
    strings of its keys, bare letters, combining marks, ZWJ and jamo."""
    from tokenizers import normalizers

    mapping = st.nfkc_mappings(300, seed=1)
    assert sum(len(k) > 1 for k in mapping) >= 100   # multi-code-point keys
    blob = st.charsmap_blob(mapping)
    ref, mine = normalizers.Precompiled(blob), hf.Precompiled(blob)
    rng = random.Random(1)
    keys = sorted(mapping) + ["a", "e", " ", "́", "‍", "ｅ", "ᄀ", "ᅡ",
                              "©", "\r", "\n"]
    strings = WORDS + ["".join(rng.choice(keys) for _ in range(
        rng.randint(1, 6))) for _ in range(3000)]
    bad = [s for s in strings if ref.normalize_str(s) != mine.normalize_str(s)]
    assert not bad, bad[:5]


def test_graphemes_match_regex():
    """The port's UAX #29 clusters against ``regex``'s ``\\X`` on random
    strings of ASCII, combining marks, ZWJ, CR/LF, Hangul jamo and
    syllables, regional indicators, emoji and modifiers, a Prepend, a
    SpacingMark and Indic letters."""
    regex = pytest.importorskip("regex")
    pool = [chr(c) for c in list(range(0x20, 0x7F)) + list(range(0x300, 0x370))
            + [0x200D, 0x200C, 0x0D, 0x0A, 0x903, 0x600, 0x1100, 0x1161,
               0x11A8, 0xAC00, 0xAC01, 0x1F1E6, 0x1F1E7, 0x1F1E8, 0x1F468,
               0x1F469, 0x2764, 0xFE0F, 0x1F3FB, 0xA9, 0xE33, 0x102B, 0xAD,
               0x94D, 0x915, 0x937]]
    rng = random.Random(2)
    for _ in range(5000):
        s = "".join(rng.choice(pool) for _ in range(rng.randint(1, 8)))
        assert hf.graphemes(s) == regex.findall(r"\X", s), s


def test_full_xlmr_sized_directory(tmp_path):
    """(d) the 250,002-id synth directory the card smoke writes: XLM-R's
    layout (``<mask>`` at 250,001) and the same ids as the JAX tokenizer."""
    d = st.write_xlmr_like_tokenizer(tmp_path / "xlmr", n_pieces=249_997,
                                     seed=0)
    j, p = _both(d)
    assert p.vocab_size == 250_002
    assert p.encode_word("<mask>") == [250_001]
    assert (p.cls_id, p.pad_id, p.sep_id, p.unk_id) == (0, 1, 2, 3)
    _assert_same(j, p, WORDS)


@pytest.mark.parametrize("case", ["bpe_whitespace", "unigram_precompiled"])
def test_encode_batch_arrays_equal(case, tmp_path):
    """(e) ``encode_batch`` with each package's tokenizer gives the same
    arrays."""
    j, p = _both(CASES[case](tmp_path / case))
    rng = np.random.RandomState(3)
    tags = ["O", "S-PER", "B-LOC", "E-LOC"]
    sents = [[WORDS[i] or "x" for i in rng.randint(len(WORDS),
                                                   size=rng.randint(1, 30))]
             for _ in range(24)]
    gold = [[tags[i] for i in rng.randint(len(tags), size=len(s))]
            for s in sents]
    td, jtd = Dictionary(), JDictionary()
    for t in ["O", "S-PER", "B-LOC", "E-LOC", "S-X"]:
        td.add_item(t)
        jtd.add_item(t)
    mine = encode_batch([SentenceRecord(tokens=s, tags={"ner": g})
                         for s, g in zip(sents, gold)], p, td,
                        max_subtokens=128)
    ref = j_encode_batch([JRecord(tokens=s, tags={"ner": g})
                          for s, g in zip(sents, gold)], j, jtd,
                         max_subtokens=128)
    for k, v in ref.arrays().items():
        np.testing.assert_array_equal(mine.arrays()[k], v, err_msg=k)


UNSUPPORTED = {
    # (position, spec, what the error names)
    "normalizer": ("normalizer", {"type": "UnicodeFold"}, "UnicodeFold"),
    "sequence_member": ("normalizer", {"type": "Sequence", "normalizers": [
        {"type": "NFC"}, {"type": "UnicodeFold"}]}, "UnicodeFold"),
    "pre_tokenizer": ("pre_tokenizer", {"type": "UnicodeWords"},
                      "UnicodeWords"),
    "model": ("model", {"type": "Bigram", "vocab": {}}, "Bigram"),
    "regex": ("normalizer", {"type": "Replace", "pattern": {
        "Regex": r"(\w)\1"}, "content": "x"}, r"Onig construct \\1"),
    "split_regex": ("pre_tokenizer", {
        "type": "Split", "pattern": {"Regex": r"\p{Han}+"},
        "behavior": "Isolated", "invert": False}, "Han"),
    "split_behavior": ("pre_tokenizer", {
        "type": "Split", "pattern": {"String": " "},
        "behavior": "Scattered", "invert": False}, "Scattered"),
    "prepend_scheme": ("pre_tokenizer", _metaspace(prepend_scheme="sometimes"),
                       "prepend_scheme"),
}


@pytest.mark.parametrize("what", sorted(UNSUPPORTED))
def test_unsupported_types_raise(what, tmp_path):
    """What the reader does not read raises ``NotImplementedError`` naming
    it: an unknown type in each position, an Onig construct the regex
    translator refuses, an
    unknown split behavior and an unknown Metaspace scheme."""
    position, value, match = UNSUPPORTED[what]
    spec = st.tokenizer_spec(100, seed=0, charsmap=0)
    spec[position] = value
    with pytest.raises(NotImplementedError, match=match):
        hf.TokenizerJson(spec)


def test_legacy_metaspace_mismatch_raises_in_both(tmp_path):
    """``add_prefix_space: false`` under the default (or any other than
    ``never``) prepend scheme is refused by the library, and here."""
    d = _unigram(pre_tokenizer=_metaspace(add_prefix_space=False))(tmp_path)
    with pytest.raises(Exception, match="add_prefix_space"):
        JHFTokenizer(str(d))
    with pytest.raises(ValueError, match="add_prefix_space"):
        HFTokenizer(str(d))


def test_directory_without_tokenizer_json_raises(tmp_path):
    """A ``sentencepiece.bpe.model``-only directory is not read."""
    (tmp_path / "sentencepiece.bpe.model").write_bytes(b"\0" * 16)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        HFTokenizer(str(tmp_path))


def test_cli_train_test_parse_with_hf_tokenizer(tmp_path, capsys):
    """``tokenizer: {type: hf, dir}`` under ``cli train``, ``test`` and
    ``parse``: the port trains the toy config with a 1,000-id XLM-R-shaped
    tokenizer (the tiny encoder's own 1,000 rows), and the JAX CLI, from
    the port's checkpoint, prints the same test scores and parses the
    same files."""
    from pathlib import Path

    import yaml

    from kbner_tpu import cli as j_cli
    from kbner_tpu_torch import cli

    fix = Path(__file__).parent / "fixtures"
    tok = st.write_xlmr_like_tokenizer(tmp_path / "tok", n_pieces=995,
                                       seed=0)
    raw = yaml.safe_load((fix / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(fix / "ner_toy")
    raw["target_dir"] = str(tmp_path / "run")
    raw["train"].update(max_epochs=3)
    raw["tokenizer"] = {"type": "hf", "dir": str(tok)}
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    cli.main(["train", "--config", str(cfg), "--device", "cpu"])
    capsys.readouterr()
    scores = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (j_cli.main, [])):
        main(["test", "--config", str(cfg), *extra])
        out = capsys.readouterr().out
        scores.append(json.loads(out[out.index("{"):]))
    assert scores[0] == scores[1]
    parsed = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", j_cli.main, [])):
        main(["parse", "--config", str(cfg), "--target_dir",
              str(fix / "ner_toy"), "--out_dir", str(tmp_path / name),
              "--keep_order", *extra])
        parsed.append({p.name: p.read_text()
                       for p in sorted((tmp_path / name).iterdir())})
    assert parsed[0] == parsed[1] and len(parsed[0]) == 3
