"""The traced CG solves' least time on this card over the device's busy
time in them, in %: the CG iterations they ran times one iteration's work
counted from the benchmark's CSR (``roofline.pcg_iteration_work``)."""
from portbench import roofline


def _work(ctx):
    return roofline.pcg_iteration_work(ctx.matrix), sum(ctx.traced_counters["iters"])


def read(ctx):
    return roofline.share(ctx, *_work(ctx)) if ctx.segment else None


def detail(ctx):
    return roofline.detail(ctx, *_work(ctx))
