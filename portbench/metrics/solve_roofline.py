"""The traced solves' least time on this card over the device's busy time
in them, in %: the work counted from the benchmark's CSR
(``roofline.solve_work``, in the configuration's dtype), the busy time the
union of every device operation of the solves, whichever kernels they
are."""
from portbench import roofline


def _work(ctx):
    return roofline.solve_work(ctx.matrix, ctx.rhs_cols, ctx.config["dtype"]), ctx.segment.calls


def read(ctx):
    return roofline.share(ctx, *_work(ctx)) if ctx.segment else None


def detail(ctx):
    return roofline.detail(ctx, *_work(ctx))
