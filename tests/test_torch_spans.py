"""The port's stage spans (``kbner_tpu_torch/utils/spans.py``) on the serve
and train paths: off they keep nothing and change nothing; on, each
micro-batch or step is one tree of spans in the order the work runs, with
counts from the host arrays, the stage seconds ``serve(timings=)``
reports, and a ``record_function`` range of each name under
``torch.profiler``. A tiny engine and tagger, as
``tests/test_torch_serve.py`` builds them, on the CPU."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from kbner_tpu_torch.data import quality_fixture
from kbner_tpu_torch.data.conll import SentenceRecord
from kbner_tpu_torch.data.dictionary import Dictionary
from kbner_tpu_torch.data.encode import encode_batch, make_batches
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.retrieval.engine import RetrievalEngine
from kbner_tpu_torch.retrieval.fusion import fuse_contexts
from kbner_tpu_torch.retrieval.pipeline import build_kb_from_jsonl
from kbner_tpu_torch.serve import request_record, serve
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
from kbner_tpu_torch.utils import spans

VOCAB = 997
KB_ROWS = [
    ("Alice Smith", "Alice Smith is a software engineer who lives in Berlin ."),
    ("Berlin", "Berlin is the capital and largest city of Germany ."),
    ("Paris", "Paris is the capital of France ."),
    ("Acme Corp", "Acme Corp hired hundreds of engineers in New York last "
     "year for a new office ."),
    ("Germany", "Germany is a large country in Central Europe ."),
]
REQUESTS = [
    {"id": 0, "tokens": "Alice Smith lives in Berlin".split()},
    {"id": 1, "tokens": "Acme Corp opened an office in Paris".split()},
    {"id": 2, "text": "Germany is in Europe"},
    {"id": 3, "tokens": "Bob".split()},
    {"id": 4, "tokens": "the capital of France is Paris .".split()},
]
K = 2
BATCH = 2  # three encoded batches a micro-batch of five

SERVE_ORDER = ["kbner.serve.retrieve", "kbner.serve.fuse", "kbner.serve.tag",
               "kbner.serve.respond"]
RETRIEVE_ORDER = ["kbner.retrieve.analyze", "kbner.retrieve.score",
                  "kbner.retrieve.pull", "kbner.retrieve.materialize"]
TAG_ORDER = ["kbner.tag.encode"] + [
    "kbner.tag.upload", "kbner.tag.forward", "kbner.tag.crf",
    "kbner.tag.pull", "kbner.tag.render"] * 3
STEP_ORDER = ["kbner.train.upload", "kbner.train.forward", "kbner.train.crf",
              "kbner.train.backward", "kbner.train.optimizer"]
OPTIM_ORDER = ["kbner.optim.clip", "kbner.optim.update"]


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with spans off and none kept."""
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    path = tmp_path_factory.mktemp("kb") / "kb.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for i, (title, sentence) in enumerate(KB_ROWS):
            f.write(json.dumps({"title": title, "sentence": sentence,
                                "paragraph": sentence,
                                "url": f"https://example.org/{i}"}) + "\n")
    text, store, title = build_kb_from_jsonl(path)
    engine = RetrievalEngine(text, store=store, title_index=title,
                             device="cpu")
    tags = Dictionary.from_items(
        ["O", "B-PER", "E-PER", "S-LOC", "S-PER", "S-ORG", "B-ORG", "E-ORG",
         "<START>", "<STOP>"])
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB, max_position_embeddings=514), tags)
    tagger = SequenceTagger(cfg, device="cpu", seed=3).eval()
    yield engine, tagger, HashTokenizer(vocab_size=VOCAB), tags
    torch.set_num_threads(n)


def _serve(stack, requests=REQUESTS, timings=None):
    engine, tagger, tok, tags = stack
    return serve(requests, engine, tagger, tok, tags, k=K, batch_size=BATCH,
                 timings=timings)


def _traced(fn):
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    return out, spans.collect()


def _children(kept, parent):
    i = kept.index(parent)
    return [s for s in kept if s.parent == i]


def _one(kept, name):
    hit = [s for s in kept if s.name == name]
    assert len(hit) == 1, (name, hit)
    return hit[0]


# -- the trainer --------------------------------------------------------------

def _port_tagger(tags, seed=0):
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags, locked_dropout=0.0,
        word_dropout=0.0)
    return SequenceTagger(cfg, device="cpu", seed=seed)


def _fused(rec):
    """A record with retrieved context after ``<EOS>`` (tagged ``S-X``), so
    that the CRF drops the batch's trailing context columns."""
    ctx = ["context", "words", "of", "a", "document"] * 3
    return SentenceRecord(tokens=rec.tokens + ["<EOS>"] + ctx,
                          tags={"ner": rec.tags["ner"]
                                + ["S-X"] * (1 + len(ctx))})


@pytest.fixture(scope="module")
def train_setup():
    corpus = quality_fixture.make_quality_corpus(12, 2, 2, seed=1)
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(VOCAB)
    records = [_fused(r) for r in corpus.train[:6]]
    eb = encode_batch(records, tok, tags)
    return corpus, tags, tok, eb


def _train_step(train_setup):
    """One ``train_step`` from the seeded tagger: (loss, parameters)."""
    corpus, tags, tok, eb = train_setup
    trainer = FinetuneTrainer(_port_tagger(tags), corpus, tok, tags,
                              device="cpu")
    config = TrainConfig(learning_rate=1e-3, batch_size=6, max_epochs=1,
                         warmup_fraction=0.0)
    opt = trainer.make_optimizer(config)
    loss = trainer.train_step(eb, opt, config,
                              torch.Generator().manual_seed(5))
    return float(loss), {k: v.clone()
                         for k, v in trainer.model.state_dict().items()}


# -- off ----------------------------------------------------------------------

def test_off_span_is_the_shared_no_op(monkeypatch):
    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("an off span read the clock")

    monkeypatch.setattr(spans, "time", NoClock())
    monkeypatch.setattr(spans, "_profiler", None)
    a, b = spans.span("kbner.x"), spans.span("kbner.y", rows=3)
    assert a is b and not a
    with a as s:
        s.add("rows", 1)
    assert spans.current() is a
    assert spans.collect() == []


@pytest.mark.parametrize("path", ["serve", "train_step"])
def test_off_and_on_give_the_same_outputs(stack, train_setup, path):
    run = ((lambda: _serve(stack)) if path == "serve"
           else (lambda: _train_step(train_setup)))
    off = run()
    assert spans.collect() == []
    on, kept = _traced(run)
    assert kept
    if path == "serve":
        assert on == off
    else:
        assert on[0] == off[0]
        for name, t in off[1].items():
            assert torch.equal(on[1][name], t), name


@pytest.mark.parametrize("path", ["serve", "train_step"])
def test_spans_wait_for_no_device_value(stack, train_setup, monkeypatch,
                                        path):
    """Turning spans on adds no ``.cpu()``, ``.item()``, ``.tolist()`` or
    synchronize: every count comes from host values."""
    calls = {"n": 0}
    for owner, attr in ((torch.Tensor, "cpu"), (torch.Tensor, "item"),
                        (torch.Tensor, "tolist"),
                        (torch.cuda, "synchronize")):
        fn = getattr(owner, attr)

        def counted(*a, _fn=fn, **kw):
            calls["n"] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(owner, attr, counted)
    run = ((lambda: _serve(stack)) if path == "serve"
           else (lambda: _train_step(train_setup)))
    run()
    off = calls["n"]
    calls["n"] = 0
    _traced(run)
    assert calls["n"] == off > 0


# -- the serve tree -----------------------------------------------------------

def test_one_root_per_micro_batch_and_children_nest(stack):
    _, kept = _traced(lambda: [_serve(stack, REQUESTS[:3]),
                               _serve(stack, REQUESTS[3:])])
    roots = [s for s in kept if s.parent is None]
    assert [s.name for s in roots] == ["kbner.serve.batch"] * 2
    assert [s.unit for s in roots] == [0, 1]
    assert [s.counts for s in roots] == [{"requests": 3}, {"requests": 2}]
    for s in kept:
        assert s.start <= s.end
        if s.parent is not None:
            p = kept[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            assert s.unit == p.unit


@pytest.mark.parametrize("parent,order", [
    ("kbner.serve.batch", SERVE_ORDER),
    ("kbner.serve.retrieve", RETRIEVE_ORDER),
    ("kbner.serve.tag", TAG_ORDER),
])
def test_serve_children_in_the_order_the_work_runs(stack, parent, order):
    _, kept = _traced(lambda: _serve(stack))
    assert [s.name for s in _children(kept, _one(kept, parent))] == order


def test_serve_counts_match_the_host_arrays(stack):
    engine, tagger, tok, tags = stack
    _, kept = _traced(lambda: _serve(stack))
    # what predict encodes: the fused records of the micro-batch
    recs = [request_record(r) for r in REQUESTS]
    results = engine.search([" ".join(r.tokens) for r in recs], k=K)
    fused = fuse_contexts(recs, results, tok)
    batches = make_batches(fused, tok, None, BATCH)
    enc = _one(kept, "kbner.tag.encode").counts
    assert enc == {
        "rows": len(REQUESTS),
        "subtokens": int(sum(eb.attention_mask.sum() for eb in batches)),
        "slots": int(sum(eb.attention_mask.size for eb in batches))}
    assert enc["subtokens"] < enc["slots"]
    crf = [s for s in kept if s.name == "kbner.tag.crf"]
    # the span counts every word column of its batch (live or not)
    assert [s.counts["columns"] for s in crf] == \
        [eb.word_mask.shape[1] for eb in batches]
    assert sum(s.counts["words"] for s in kept
               if s.name == "kbner.tag.render") == \
        int(sum(eb.word_mask.sum() for eb in batches))
    assert _one(kept, "kbner.retrieve.analyze").counts == {
        "queries": len(REQUESTS),
        "terms": int(np.count_nonzero(
            engine.text_index.encode_queries(
                [" ".join(r.tokens) for r in recs])[1]))}
    assert _one(kept, "kbner.retrieve.score").counts == \
        {"docs": len(KB_ROWS)}
    n_docs = sum(len(r) for r in results)
    assert _one(kept, "kbner.retrieve.materialize").counts == \
        {"docs_returned": n_docs}
    assert _one(kept, "kbner.serve.fuse").counts == {"contexts": n_docs}


def test_crf_span_counts_the_live_columns(stack):
    """``kbner.tag.crf`` counts the word columns the Viterbi runs over:
    those some row of the batch leaves unmasked, and column 0."""
    engine, tagger, tok, tags = stack
    _, kept = _traced(lambda: _serve(stack))
    recs = [request_record(r) for r in REQUESTS]
    fused = fuse_contexts(recs, engine.search([" ".join(r.tokens)
                                               for r in recs], k=K), tok)
    batches = make_batches(fused, tok, None, BATCH)
    crf = [s.counts for s in kept if s.name == "kbner.tag.crf"]
    live = [eb.crf_mask.any(0) for eb in batches]
    for m in live:
        m[0] = True
    assert [c["live_columns"] for c in crf] == [int(m.sum()) for m in live]
    # the retrieved context after <EOS> is masked in every row
    assert all(c["live_columns"] < c["columns"] for c in crf)


def test_timings_are_the_stage_spans(stack):
    timings = {}
    _, kept = _traced(lambda: _serve(stack, timings=timings))
    for key in ("retrieve", "fuse", "tag"):
        assert timings[key] == _one(kept, f"kbner.serve.{key}").seconds
    # off, the same keys from the same clock
    off = {}
    _serve(stack, timings=off)
    assert sorted(off) == ["fuse", "retrieve", "tag"]
    assert all(v > 0 for v in off.values())


# -- the train tree -----------------------------------------------------------

@pytest.mark.parametrize("parent,order", [
    ("kbner.train.step", STEP_ORDER),
    ("kbner.train.optimizer", OPTIM_ORDER),
])
def test_train_step_tree(train_setup, parent, order):
    _, kept = _traced(lambda: _train_step(train_setup))
    assert kept[0].name == "kbner.train.step" and kept[0].parent is None
    assert [s.name for s in _children(kept, _one(kept, parent))] == order
    for s in kept[1:]:
        p = kept[s.parent]
        assert p.start <= s.start and s.end <= p.end


def test_train_counts_match_the_host_arrays(train_setup):
    _, _, _, eb = train_setup
    _, kept = _traced(lambda: _train_step(train_setup))
    assert _one(kept, "kbner.train.upload").counts == {
        "rows": eb.num_sentences, "subtokens": int(eb.attention_mask.sum()),
        "slots": eb.attention_mask.size}
    # the NLL's loop runs over the columns some sentence keeps (and the
    # first): the trailing context columns are dropped
    live = eb.crf_mask.any(0)
    live[0] = True
    cols = _one(kept, "kbner.train.crf").counts["columns"]
    assert cols == int(live.sum()) < eb.crf_mask.shape[1]


# -- the profiler's timeline --------------------------------------------------

@pytest.mark.parametrize("path", ["serve", "train_step"])
def test_spans_are_profiler_ranges(stack, train_setup, path):
    run = ((lambda: _serve(stack)) if path == "serve"
           else (lambda: _train_step(train_setup)))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, kept = _traced(run)
    names = {}
    for e in prof.events():
        names[e.name] = names.get(e.name, 0) + 1
    want = {}
    for s in kept:
        want[s.name] = want.get(s.name, 0) + 1
    assert {n: names.get(n, 0) for n in want} == want


def test_no_profiler_range_without_a_profiler(stack, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def rf(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", rf)
    _, kept = _traced(lambda: _serve(stack))
    assert kept and opened == []


def test_profile_window_trace_holds_the_spans(tmp_path):
    corpus = quality_fixture.make_quality_corpus(24, 4, 4, seed=1)
    tags = corpus.make_tag_dictionary("ner")
    trainer = FinetuneTrainer(_port_tagger(tags), corpus,
                              HashTokenizer(VOCAB), tags, device="cpu")
    trainer.train(tmp_path, TrainConfig(batch_size=8, max_epochs=1,
                                        profile_steps=1, profile_start=1))
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"kbner.train.step", "kbner.train.forward",
            "kbner.train.backward", "kbner.optim.update"} <= names
    # the window turned spans on for itself alone
    assert spans.span("kbner.x") is spans.span("kbner.y")
    assert spans.collect() == []


def test_threads_keep_their_own_trees():
    """Threads opening spans at once: each child's parent is its own
    thread's root, and every root has a number of its own."""
    n_threads, n_roots = 16, 200

    def work(t):
        for _ in range(n_roots):
            with spans.span(f"kbner.t{t}.root"):
                with spans.span(f"kbner.t{t}.child"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.enable()
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        spans.disable()
        sys.setswitchinterval(old)
    kept = spans.collect()
    assert len(kept) == 2 * n_threads * n_roots
    roots = [s for s in kept if s.parent is None]
    assert sorted(s.unit for s in roots) == list(range(len(roots)))
    for s in kept:
        if s.parent is not None:
            p = kept[s.parent]
            assert p.name == s.name.replace(".child", ".root")
            assert p.unit == s.unit


def test_each_thread_nests_its_own_spans():
    spans.enable()
    with spans.span("kbner.a"):
        t = threading.Thread(target=lambda: spans.span("kbner.b").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join()
        with spans.span("kbner.c"):
            pass
    spans.disable()
    kept = spans.collect()
    assert [(s.name, s.parent, s.unit) for s in kept] == [
        ("kbner.a", None, 0), ("kbner.b", None, 1), ("kbner.c", 0, 0)]
