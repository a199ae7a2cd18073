"""K1, ``kbner_tpu_torch/csrc/bm25_score.cu`` behind
``ops.bm25.bm25_score_block``: the least time a launch could take.

Counted from the launch's shapes, whatever kernel implements it: each
operand read once (the queries' ``[Q, Lq]`` int32 terms and float32
weights, the index's ``[Ld, N]`` int32 terms and float32 impacts) and the
``[Q, N]`` float32 scores written once, at the HBM rate; and one int32
lookup of each non-pad index slot per query at the int32 rate. The larger
of the two bounds it.
"""

from portbench.harness.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S

KERNEL = "bm25_score_kernel"  # the device kernel's name in a trace


def need(Q: int, Lq: int, Ld: int, N: int, nonpad: int) -> dict:
    return {"bytes": Q * Lq * 8 + Ld * N * 8 + Q * N * 4,
            "lookups": Q * nonpad}


def least_seconds(Q: int, Lq: int, Ld: int, N: int, nonpad: int) -> float:
    n = need(Q, Lq, Ld, N, nonpad)
    return max(n["bytes"] / HBM_BYTES_PER_S, n["lookups"] / INT32_OPS_PER_S)
