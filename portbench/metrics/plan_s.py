"""The inspector's seconds of the cell's plans, summed (the program's own
``inspector_seconds``: forward and backward factor in PCG)."""


def read(ctx):
    return ctx.counters["plan_s"]
