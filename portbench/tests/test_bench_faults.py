"""The comparison that decides ``correct`` fails a run whose timed path is
broken underneath: a tag or a retrieved document altered where it is
produced, a context dropped in fusion, an optimizer step that leaves the
state unchanged, half of each batch left out of the loss. (One card: no
exchange between chips to leave out.) Each runs the harness at a tiny
size on the CPU, with the cell's own limits."""

import pytest
import torch

from . import bench_tiny

SERVE, TRAIN = "large.serve.exh", "large.finetune.b16"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("kb")


def test_sound_runs_are_correct(cache):
    for wl in (SERVE, TRAIN):
        out = bench_tiny.run(wl, cache)
        assert out["correct"], out["checks"]


def test_an_altered_tag_fails(cache, monkeypatch):
    from kbner_tpu_torch.models import tagger

    decode = tagger.crf_decode

    def altered(*a, **kw):
        tags, score = decode(*a, **kw)
        tags = tags.clone()
        tags[0, 0] = (tags[0, 0] + 1) % 25
        return tags, score

    monkeypatch.setattr(tagger, "crf_decode", altered)
    out = bench_tiny.run(SERVE, cache)
    assert not out["correct"]
    assert out["checks"]["viterbi_gap"]["value"] > \
        out["checks"]["viterbi_gap"]["limit"]


def test_an_altered_document_fails(cache, monkeypatch):
    from kbner_tpu_torch.retrieval import engine

    search = engine.RetrievalEngine.search

    def altered(self, *a, **kw):
        res = search(self, *a, **kw)
        for row in res:
            if row:
                row[-1].doc_id = (row[-1].doc_id + 1) % 3000
        return res

    monkeypatch.setattr(engine.RetrievalEngine, "search", altered)
    out = bench_tiny.run(SERVE, cache)
    assert not out["correct"]
    assert out["checks"]["retrieval_rank_gap"]["value"] > \
        out["checks"]["retrieval_rank_gap"]["limit"]


def test_a_dropped_context_fails(cache, monkeypatch):
    from kbner_tpu_torch.retrieval import fusion

    fuse = fusion.fuse_contexts

    def dropped(records, results, *a, **kw):
        return fuse(records, [r[1:] for r in results], *a, **kw)

    monkeypatch.setattr(fusion, "fuse_contexts", dropped)
    from kbner_tpu_torch import serve
    monkeypatch.setattr(serve, "fuse_contexts", dropped)
    out = bench_tiny.run(SERVE, cache)
    assert not out["correct"]
    assert out["checks"]["fusion_mismatches"]["value"] > 0


def test_a_step_that_leaves_the_state_unchanged_fails(cache, monkeypatch):
    from kbner_tpu_torch.train import optim

    monkeypatch.setattr(optim.FinetuneOptimizer, "step",
                        lambda self: True)
    out = bench_tiny.run(TRAIN, cache)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] >= 0.99


def test_half_the_batch_left_out_fails(cache, monkeypatch):
    from kbner_tpu_torch.models.tagger import SequenceTagger

    loss = SequenceTagger.loss

    def half(self, batch, *a, **kw):
        n = batch["input_ids"].shape[0] // 2
        return loss(self, {k: v[:n] if v.dim() else v
                           for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(SequenceTagger, "loss", half)
    out = bench_tiny.run(TRAIN, cache)
    assert not out["correct"]
    torch.set_num_threads(1)
