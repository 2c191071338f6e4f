"""The window's wall time over the solves it completed, in ms: each solve
is ``solve(b)`` then a device synchronisation, back to back."""


def read(ctx):
    return ctx.window_s / ctx.calls * 1e3
