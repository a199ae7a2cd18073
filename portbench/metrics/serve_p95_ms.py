"""The 95th percentile over all requests of the window; a request's
latency runs from when its micro-batch is taken from the backlog to when
its response is returned."""

import numpy as np

UNIT, SOURCE, BETTER = "ms", "host_clock", "lower"


def read(ctx):
    if "latencies_ms" not in ctx:
        return None
    return float(np.percentile(ctx["latencies_ms"], 95))
