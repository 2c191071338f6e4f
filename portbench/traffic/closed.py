"""The closed loop: one caller, back to back. A mix that names this driver
(``"driver": "closed"``) gives ``rhs``, the right-hand sides of a call, and
``pool``, how many distinct calls are drawn: call i takes
``pool[i % pool]``, and a pool larger than a window's calls gives each call
a fresh right-hand side.
"""
from __future__ import annotations

import time

import torch

from portbench.inputs import SEED_MOD, rng


def make_pool(traffic: dict, n: int, seed: int, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f[pool, n] (one right-hand side a call) or f[pool, n, rhs] in the
    configuration's ``dtype``, drawn N(0, 1) on ``device`` by one generator
    seeded from ``seed``, in one call."""
    m, pool = int(traffic["rhs"]), int(traffic["pool"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, 2).integers(SEED_MOD)))
    shape = (pool, n) if m == 1 else (pool, n, m)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def rhs(pool: torch.Tensor, i: int) -> torch.Tensor:
    """The right-hand side of call ``i``."""
    return pool[i % len(pool)]


def drive(call, pool, seconds: float, device, keep):
    """Calls back to back until ``seconds`` have passed, each followed by a
    device synchronisation (the caller uses x next); ``keep(i, out)`` sees
    every answer. Each call is timed by CUDA events on the device, the
    window by the host clock. Returns (calls, window seconds, ms of each
    call)."""
    cuda = device.type == "cuda"
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2)) if cuda else (None, None)
    ms, i = [], 0
    t_start = time.perf_counter()
    while True:
        b = rhs(pool, i)
        if cuda:
            e0.record()
            out = call(b)
            e1.record()
            torch.cuda.synchronize(device)
            ms.append(e0.elapsed_time(e1))
        else:
            t = time.perf_counter()
            out = call(b)
            ms.append((time.perf_counter() - t) * 1e3)
        keep(i, out)
        i += 1
        elapsed = time.perf_counter() - t_start
        if elapsed >= seconds:
            return i, elapsed, ms
