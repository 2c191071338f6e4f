"""Where the port's tensors live: on the card unless the caller asks for
the CPU.

Every entry point that places tensors (``TriangularSolver.plan``,
``Backend.bind``, ``plan_arrays``, ``elastic_plan_arrays``,
``make_solver``, the kernel wrappers in ``kernels.ops``,
``kernels.spmv``, ``solver.cg``) takes ``device=None`` and resolves it
here. ``timed_us`` is the one clock of the timed solves.
"""
from __future__ import annotations

import time

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; without CUDA that raises instead of
    falling back to the CPU. Anything else is passed to ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch solves on the CUDA device by default and CUDA "
                "is not available; pass device='cpu' to solve on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def timed_us(fn, device: torch.device):
    """``(fn(), µs)``: the time of ``fn``'s work on ``device``, rounded to
    0.01 µs. On the card, CUDA events on the device's current stream around
    the call, then a wait for the end event (``elapsed_time``); on the CPU,
    the host clock around the call."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = fn()
        e1.record(stream)
        e1.synchronize()
        return out, round(e0.elapsed_time(e1) * 1e3, 2)
    t0 = time.perf_counter_ns()
    out = fn()
    return out, round((time.perf_counter_ns() - t0) / 1e3, 2)
