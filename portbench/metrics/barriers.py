"""Level barriers a call, for ``barriers.solve`` and ``barriers.pcg``: the
levels of the bound level order that the kernel walks
(``bound.describe()["n_levels"]``); in PCG an iteration's, the forward and
the backward factor's summed."""


def read(ctx):
    return ctx.counters["levels"]
