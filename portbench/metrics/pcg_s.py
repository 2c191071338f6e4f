"""Time to a converged x: the window's wall time over the CG solves it
completed that reached the configuration's ``cg.tol`` (as each reports its
residual), in seconds; a solve that stopped above it counts its time and
no answer."""


def read(ctx):
    tol = ctx.config["cg"]["tol"]
    converged = sum(1 for r in ctx.counters["relres"] if r <= tol)
    return ctx.window_s / converged if converged else None
