"""XLM-R encoder, the CRF sequence taggers and the ACE stack's embedders
(the package surface of ``kbner_tpu.models``; a tagger is built by its
constructor, ``SequenceTagger(config, device=, seed=)``, where the
reference calls ``init_tagger``)."""
from .xlmr import XLMRConfig, XLMREncoder, load_hf_checkpoint
from .tagger import SequenceTagger, StackedSequenceTagger, TaggerConfig
from .embedders import (
    BPEmbEmbedder,
    BPEVocab,
    CharBiLSTMEmbedder,
    CharLM,
    CharLMHead,
    ELMoEmbedder,
    EmbedderSpec,
    FlairLMEmbedder,
    StackedEmbedder,
    TransformerWordEmbedder,
    WordEmbedder,
)

__all__ = [
    "XLMRConfig",
    "XLMREncoder",
    "load_hf_checkpoint",
    "SequenceTagger",
    "StackedSequenceTagger",
    "TaggerConfig",
    "WordEmbedder",
    "CharBiLSTMEmbedder",
    "CharLM",
    "CharLMHead",
    "FlairLMEmbedder",
    "StackedEmbedder",
    "TransformerWordEmbedder",
    "EmbedderSpec",
    "ELMoEmbedder",
    "BPEmbEmbedder",
    "BPEVocab",
]
