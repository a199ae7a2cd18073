"""Host milliseconds of the tag stage per micro-batch over the window, as
``serve(timings=)``'s ``tag`` key sums them (the stage ends with
its results on the host)."""

LAYER, UNIT, SOURCE = "tagger", "ms", "program_span"
MOVES, BETTER = "serve_sentences_per_s", "lower"


def read(ctx):
    if "stage_s" not in ctx or not ctx["batches"]:
        return None
    return ctx["stage_s"]["tag"] / ctx["batches"] * 1e3
