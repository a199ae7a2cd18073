"""The whole tagger's share of the bf16 dense peak over the window: the
FLOPs its inputs need (``2 N T + 4 L H sum S_b^2``; N the parameters
outside the embeddings, T the real subtokens, S_b each row's real length)
over the window's seconds times 989 TFLOP/s."""

from portbench.harness.peaks import BF16_FLOPS

LAYER, UNIT, SOURCE = "tagger", "%", "host_clock"
MOVES, BETTER = "serve_sentences_per_s", "higher"


def read(ctx):
    if "sentences" not in ctx or "flops" not in ctx:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * BF16_FLOPS)
