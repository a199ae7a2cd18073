"""Device milliseconds per step of the kernels launched under the span
around the optimizer's ``step`` in the profiled slice."""

LAYER, UNIT, SOURCE = "optimizer", "ms", "device_trace"
MOVES, BETTER = "train_tokens_per_s", "lower"


def read(ctx):
    if "steps" not in ctx or "trace" not in ctx:
        return None
    tr = ctx["trace"]
    if "optimizer" not in tr.under:
        return None
    return tr.under["optimizer"] / tr.units * 1e3
