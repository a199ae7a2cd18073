"""The share of the profiled slice in which no operation ran on the
device."""

LAYER, UNIT, SOURCE = "device", "%", "device_trace"
MOVES, BETTER = "serve_sentences_per_s", "lower"


def read(ctx):
    if "sentences" not in ctx or "trace" not in ctx:
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
