"""Device operations a solve in the profiler's trace (gathers, padding,
the kernel), the median over the traced solves."""
import statistics


def read(ctx):
    seg = ctx.segment
    return float(statistics.median(seg.ops_per_call)) if seg and seg.device_events else None
