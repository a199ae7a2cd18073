"""The named-corpus registry (counterpart of ``kbner_tpu/data/corpora.py``):
a dataset name resolves to its column format, file names, comment symbol,
tag layer and file format, under a local data root. Nothing is
downloaded; the files must be on disk.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    column_format: Dict[int, str]
    folder: str  # default subfolder under the data root
    train_file: str = "train.txt"
    dev_file: str = "dev.txt"
    test_file: str = "test.txt"
    comment_symbol: Optional[str] = None
    tag_layer: str = "ner"
    format: str = "column"  # or "conllu" (UD treebanks)


def _ud(treebank: str) -> CorpusEntry:
    """UD treebank entry (CoNLL-U files under the canonical release
    naming, e.g. ``ud_english/en_ewt-ud-train.conllu``) — the parsing
    targets' data source (reference ``flair/datasets.py:1006`` +
    UD_* corpus classes)."""
    code = treebank.split("_")[0]
    lang = {"en": "english", "de": "german", "fr": "french",
            "it": "italian", "nl": "dutch", "es": "spanish",
            "pt": "portuguese", "ja": "japanese"}.get(code, code)
    return CorpusEntry(
        column_format={}, folder=f"ud_{lang}",
        train_file=f"{treebank}-ud-train.conllu",
        dev_file=f"{treebank}-ud-dev.conllu",
        test_file=f"{treebank}-ud-test.conllu",
        tag_layer=None, format="conllu")


def _multiconer(lang: str) -> CorpusEntry:
    """SemEval-2022 MultiCoNER track layout (the KB-NER target datasets;
    reference config blocks, ``config/test.yaml:46-120``).

    Language tracks are 'XX-Name' (code before '-'); the MIX/MULTI
    tracks are 'MIX_Code_mixed'/'MULTI_Multilingual' (code before '_'),
    shipping as mix_train.conll / multi_train.conll."""
    code = lang.split("-")[0].split("_")[0].lower()
    return CorpusEntry(
        column_format={0: "text", 1: "pos", 2: "upos", 3: "ner"},
        folder=lang,
        train_file=f"{code}_train.conll",
        dev_file=f"{code}_dev.conll",
        test_file=f"{code}_test.conll",
        comment_symbol="# id",
    )


MULTICONER_TRACKS = [
    "BN-Bangla", "DE-German", "EN-English", "ES-Spanish", "FA-Farsi",
    "HI-Hindi", "KO-Korean", "NL-Dutch", "RU-Russian", "TR-Turkish",
    "ZH-Chinese", "MIX_Code_mixed", "MULTI_Multilingual",
]

CORPUS_REGISTRY: Dict[str, CorpusEntry] = {
    # CoNLL-02/03 NER (datasets.py:1646-2150)
    "CONLL_03": CorpusEntry(
        {0: "text", 1: "pos", 2: "chunk", 3: "ner"}, "conll_03",
        "eng.train", "eng.testa", "eng.testb"),
    "CONLL_03_GERMAN": CorpusEntry(
        {0: "text", 1: "lemma", 2: "pos", 3: "chunk", 4: "ner"},
        "conll_03_german", "deu.train", "deu.testa", "deu.testb"),
    "CONLL_03_DUTCH": CorpusEntry(
        {0: "text", 1: "pos", 2: "ner"}, "conll_03_dutch",
        "ned.train", "ned.testa", "ned.testb"),
    "CONLL_03_SPANISH": CorpusEntry(
        {0: "text", 1: "ner"}, "conll_03_spanish",
        "esp.train", "esp.testa", "esp.testb"),
    # WNUT emerging entities
    "WNUT_17": CorpusEntry(
        {0: "text", 1: "ner"}, "wnut_17",
        "wnut17train.conll", "emerging.dev.conll",
        "emerging.test.annotated"),
    # WikiAnn / PAN-X per-language silver NER
    "PANX": CorpusEntry({0: "text", 1: "ner"}, "panx"),
    # CoNLL-03 English layout variants (datasets.py:1696-1870)
    "CONLL_03_ENGLISH": CorpusEntry(
        {0: "text", 1: "pos", 2: "chunk", 3: "ner"}, "conll_03_english"),
    "CONLL_03_ENGLISH_DOC": CorpusEntry(
        {0: "text", 1: "pos", 2: "chunk", 3: "ner"},
        "conll_03_english_doc"),
    "CONLL_03_VIETNAMESE": CorpusEntry(
        {0: "text", 1: "chunk"}, "conll_03_vietnamese", tag_layer="chunk"),
    "CONLL_06_GERMAN": CorpusEntry(
        {0: "text", 1: "ner"}, "conll_06_german"),
    # chunking (datasets.py:2454-3013)
    "CHUNK_CONLL_03_ENGLISH": CorpusEntry(
        {0: "text", 2: "chunk"}, "conll_03_english", tag_layer="chunk"),
    "CONLL_2000": CorpusEntry(
        {0: "text", 1: "pos", 2: "chunk"}, "conll_2000",
        tag_layer="chunk"),
    # German / Basque / OntoNotes / mixed NER (datasets.py:3015-3251,
    # 2617-2737)
    "GERMEVAL": CorpusEntry(
        {1: "text", 2: "ner"}, "germeval", comment_symbol="#"),
    "NER_BASQUE": CorpusEntry({0: "text", 1: "ner"}, "ner_basque"),
    "ONTONOTE_ENG": CorpusEntry({0: "text", 1: "ner"}, "ontonote_eng"),
    "MIXED_NER": CorpusEntry({0: "text", 1: "ner"}, "mixed_ner"),
    "LOW10_NER": CorpusEntry({0: "text", 1: "ner"}, "low10_ner"),
    # twitter POS (datasets.py:1440-1613) — tag_layer None: plain upos,
    # no BIOES conversion
    "TWITTER": CorpusEntry(
        {0: "text", 1: "upos"}, "twitter", tag_layer=None),
    "ARK": CorpusEntry({0: "text", 1: "upos"}, "ark", tag_layer=None),
    "RITTER": CorpusEntry({0: "text", 1: "upos"}, "ritter",
                          tag_layer=None),
    # aspect extraction (datasets.py:2783-2914)
    "SEMEVAL16": CorpusEntry(
        {0: "text", 1: "ast"}, "semeval16", tag_layer="ast"),
    "SEMEVAL14_LAPTOP": CorpusEntry(
        {0: "text", 1: "ast"}, "semeval14_laptop", tag_layer="ast"),
    "SEMEVAL14_RESTAURANT": CorpusEntry(
        {0: "text", 1: "ast"}, "semeval14_restaurant", tag_layer="ast"),
    "SEMEVAL15_RESTAURANT": CorpusEntry(
        {0: "text", 1: "ast"}, "semeval15_restaurant", tag_layer="ast"),
    # slot filling / code-switching (datasets.py:2531-2950)
    "ATIS": CorpusEntry({0: "text", 1: "atis"}, "atis",
                        tag_layer="atis"),
    "CALCS": CorpusEntry({0: "text", 1: "lang", 2: "ner"}, "calcs"),
    # classification corpora (fastText __label__ format,
    # datasets.py:3061-3367, 4304-4392)
    "IMDB": CorpusEntry({}, "imdb", tag_layer=None, format="fasttext"),
    "NEWSGROUPS": CorpusEntry({}, "newsgroups", tag_layer=None,
                              format="fasttext"),
    "TREC_6": CorpusEntry({}, "trec_6", tag_layer=None,
                          format="fasttext"),
    "TREC_50": CorpusEntry({}, "trec_50", tag_layer=None,
                           format="fasttext"),
    "AG_NEWS": CorpusEntry({}, "ag_news", tag_layer=None,
                           format="fasttext"),
    "WASSA_ANGER": CorpusEntry({}, "wassa_anger", tag_layer=None,
                               format="fasttext"),
    "WASSA_FEAR": CorpusEntry({}, "wassa_fear", tag_layer=None,
                              format="fasttext"),
    "WASSA_JOY": CorpusEntry({}, "wassa_joy", tag_layer=None,
                             format="fasttext"),
    "WASSA_SADNESS": CorpusEntry({}, "wassa_sadness", tag_layer=None,
                                 format="fasttext"),
    # UD treebanks for the parsing targets (reference upos/dependency
    # corpus lists, config/test.yaml + flair/datasets.py:1006; zoo at
    # :3369-4303)
    "UD_ENGLISH": _ud("en_ewt"),
    "UD_GERMAN": _ud("de_gsd"),
    "UD_GERMAN_HDT": _ud("de_hdt"),
    "UD_FRENCH": _ud("fr_gsd"),
    "UD_ITALIAN": _ud("it_isdt"),
    "UD_DUTCH": _ud("nl_alpino"),
    "UD_SPANISH": _ud("es_gsd"),
    "UD_PORTUGUESE": _ud("pt_bosque"),
    "UD_JAPANESE": _ud("ja_gsd"),
    "UD_ROMANIAN": _ud("ro_rrt"),
    "UD_CATALAN": _ud("ca_ancora"),
    "UD_POLISH": _ud("pl_lfg"),
    "UD_CZECH": _ud("cs_pdt"),
    "UD_SLOVAK": _ud("sk_snk"),
    "UD_SWEDISH": _ud("sv_talbanken"),
    "UD_DANISH": _ud("da_ddt"),
    "UD_NORWEGIAN": _ud("no_bokmaal"),
    "UD_FINNISH": _ud("fi_tdt"),
    "UD_SLOVENIAN": _ud("sl_ssj"),
    "UD_CROATIAN": _ud("hr_set"),
    "UD_SERBIAN": _ud("sr_set"),
    "UD_BULGARIAN": _ud("bg_btb"),
    "UD_ARABIC": _ud("ar_padt"),
    "UD_HEBREW": _ud("he_htb"),
    "UD_TURKISH": _ud("tr_imst"),
    "UD_PERSIAN": _ud("fa_seraji"),
    "UD_RUSSIAN": _ud("ru_syntagrus"),
    "UD_HINDI": _ud("hi_hdtb"),
    "UD_INDONESIAN": _ud("id_gsd"),
    "UD_CHINESE": _ud("zh_gsd"),
    "UD_KOREAN": _ud("ko_kaist"),
    "UD_BASQUE": _ud("eu_bdt"),
    "UD_TAMIL": _ud("ta_ttb"),
    "TWEEBANK": _ud("en_tweebank"),
}
# WikiNER silver-standard NER, 8 languages (datasets.py:4434-4694)
for _wl, _wcode in (("ENGLISH", "en"), ("GERMAN", "de"), ("DUTCH", "nl"),
                    ("FRENCH", "fr"), ("ITALIAN", "it"), ("SPANISH", "es"),
                    ("PORTUGUESE", "pt"), ("POLISH", "pl"),
                    ("RUSSIAN", "ru")):
    CORPUS_REGISTRY[f"WIKINER_{_wl}"] = CorpusEntry(
        {0: "text", 1: "pos", 2: "ner"}, f"wikiner_{_wcode}",
        train_file=f"aij-wikiner-{_wcode}-wp3.train",
        dev_file=f"aij-wikiner-{_wcode}-wp3.dev",
        test_file=f"aij-wikiner-{_wcode}-wp3.test")
for _track in MULTICONER_TRACKS:
    CORPUS_REGISTRY[f"MULTICONER_{_track}"] = _multiconer(_track)
    CORPUS_REGISTRY[_track] = _multiconer(_track)


def corpus_spec(name: str, data_root: str | Path, **overrides):
    """Resolve a registry name to a ``config.CorpusSpec``.

    ``data_root`` is the local directory holding the dataset folders (the
    stand-in for the reference's flair cache). Keyword overrides replace
    any entry field (e.g. ``train_file``).
    """
    from ..config import CorpusSpec

    key = name.upper() if name.upper() in CORPUS_REGISTRY else name
    if key not in CORPUS_REGISTRY:
        raise KeyError(
            f"unknown corpus {name!r}; known: {sorted(CORPUS_REGISTRY)}")
    e = CORPUS_REGISTRY[key]
    fields = dict(
        name=name,
        data_folder=str(Path(data_root) / e.folder),
        column_format=dict(e.column_format),
        comment_symbol=e.comment_symbol,
        train_file=e.train_file,
        dev_file=e.dev_file,
        test_file=e.test_file,
        tag_to_bioes=e.tag_layer,
        format=e.format,
    )
    fields.update(overrides)
    return CorpusSpec(**fields)
