"""Device milliseconds per micro-batch of the kernels launched under the
span around ``crf_decode`` (the name ``SequenceTagger.decode`` looks up)
in the profiled slice."""

LAYER, UNIT, SOURCE = "CRF", "ms", "device_trace"
MOVES, BETTER = "serve_sentences_per_s", "lower"


def read(ctx):
    if "sentences" not in ctx or "trace" not in ctx:
        return None
    tr = ctx["trace"]
    if "crf_decode" not in tr.under:
        return None
    return tr.under["crf_decode"] / tr.units * 1e3
