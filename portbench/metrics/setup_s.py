"""Set-up: process start to the first timed call (imports, inputs, the
inspector, the kernels' build or load, the warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
