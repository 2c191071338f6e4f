"""1 - busy / wall over the traced calls, for ``idle_share.solve`` and
``idle_share.pcg``: busy is the union of the device operations' intervals
in the profiler's trace."""


def read(ctx):
    seg = ctx.segment
    return 1.0 - seg.busy_s / seg.window_s if seg and seg.device_events else None
