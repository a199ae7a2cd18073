"""Sentences answered by ``serve()`` over the whole window, over the
window's seconds."""

UNIT, SOURCE, BETTER = "sentences/s", "host_clock", "higher"


def read(ctx):
    if "sentences" not in ctx:
        return None
    return ctx["sentences"] / ctx["window_s"]
