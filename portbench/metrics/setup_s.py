"""Set-up: from process start to the first timed request or step
(loading, building, warming up)."""

UNIT, SOURCE, BETTER = "s", "host_clock", "lower"


def read(ctx):
    return ctx["setup_s"]
