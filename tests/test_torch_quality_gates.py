"""The port's parser and classifier quality gates against kbner_tpu's:
the pattern treebank and the topic corpus record for record (tokens,
``head``, ``deprel``, ``labels``) at three seeds, and each gate trained
on the CPU at the reference's sizes and settings to the reference's bar
(held-out UAS >= 0.9, accuracy >= 0.95). The models are drawn from the
port's own seeds, so the metrics need not equal JAX's; the bars do."""

import pytest
import torch

from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu_torch.data import quality_fixture


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(corpus):
    return [[(r.tokens, r.tags, r.labels) for r in split]
            for split in (corpus.train, corpus.dev_list[0],
                          corpus.test_list[0])]


@pytest.mark.parametrize("seed", [0, 3, 5])
@pytest.mark.parametrize("kind", ["parser", "classifier"])
def test_corpus_equals_reference(kind, seed):
    name = f"make_{kind}_quality_corpus"
    got = getattr(quality_fixture, name)(seed=seed)
    want = getattr(jquality, name)(seed=seed)
    assert got.corpora[0].name == want.corpora[0].name
    assert _records(got) == _records(want)


def test_parser_gate_reaches_reference_bar():
    uas = quality_fixture.run_parser_quality_gate(device="cpu")
    assert uas >= 0.9, f"parser quality gate failed: held-out UAS {uas:.4f}"


def test_classifier_gate_reaches_reference_bar():
    acc = quality_fixture.run_classifier_quality_gate(device="cpu")
    assert acc >= 0.95, f"classifier gate failed: held-out acc {acc:.4f}"
