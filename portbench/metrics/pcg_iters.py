"""CG iterations a solve, as ``cg_solve`` returns them, averaged over the
window's solves."""


def read(ctx):
    iters = ctx.counters["iters"]
    return sum(iters) / len(iters) if iters else None
