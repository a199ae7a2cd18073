"""A cell at a size a CPU test can hold: the harness's run with its look
for a card skipped, a tiny XLM-R and a 3,000-document KB."""

import copy
import time

from portbench.harness import cell as cells

SERVE = dict(sentences=1024, warmup_batches=1, trace_batches=2)
TRAIN = dict(records=32, batch=4, block=4, warmup_steps=1, trace_steps=2)


def make(workload, cache, seed=2**31 + 5, seconds=1.0, trace=False):
    bench = cells.manifest()
    c = cells.make_cell(bench, workload, seed, seconds, trace,
                        time.perf_counter(), device="cpu")
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(vocab_size=1000, hidden_size=64,
                             num_hidden_layers=2, num_attention_heads=4,
                             intermediate_size=128)
    c.config["kb"].update(n_docs=3000, n_topics=60)
    c.traffic.update(SERVE if c.traffic["kind"] == "serve_backlog"
                     else TRAIN)
    c.cache = cache
    return bench, c


def run(workload, cache, **kw):
    import torch
    torch.set_num_threads(2)
    bench, c = make(workload, cache, **kw)
    out = cells.run(c, bench)
    out.pop("_ctx")
    return out
