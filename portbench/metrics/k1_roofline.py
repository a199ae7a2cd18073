"""K1's share of its roofline: the least time of the traced slice's
launches (``rooflines/bm25_score.py``, from each launch's shapes) over the
profiler's device time of K1's kernel."""

from portbench.rooflines import bm25_score

LAYER, UNIT, SOURCE = "K1 kernel", "%", "device_trace"
MOVES, BETTER = "serve_sentences_per_s", "higher"


def read(ctx):
    launches = ctx.get("k1_launches")
    if not launches or "trace" not in ctx:
        return None
    seconds, n = ctx["trace"].kernel(bm25_score.KERNEL)
    if n == 0 or seconds <= 0:
        return None
    least = sum(bm25_score.least_seconds(
        L["Q"], L["Lq"], L["Ld"], L["N"], L["nonpad"]) for L in launches)
    return 100.0 * least * n / len(launches) / seconds
