"""Real (non-pad) subtokens trained over the whole window, over its
seconds; each step ends when its loss reaches the host."""

UNIT, SOURCE, BETTER = "tokens/s", "host_clock", "higher"


def read(ctx):
    if "tokens" not in ctx:
        return None
    return ctx["tokens"] / ctx["window_s"]
