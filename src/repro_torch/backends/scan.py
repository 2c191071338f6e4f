"""Scan backend — the plain PyTorch executor behind the ``Backend``
protocol (step bodies in ``repro_torch.solver.executor``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends.base import (
    Backend,
    BoundSolve,
    expected_entry_count,
    masked_value_gather,
    numpy_dtype,
)
from repro_torch.backends.registry import register_backend
from repro_torch.device import resolve_device
from repro_torch.solver.executor import PlanArrays, plan_arrays, solve_with_plan


class ScanBoundSolve(BoundSolve):
    backend = "scan"

    def __init__(self, pa: PlanArrays, val_src, diag_src, *, n_entries):
        self._pa = pa
        self._val_src = val_src  # int32[T, k, W] on the device
        self._diag_src = diag_src  # int32[T, k] on the device
        self.n = pa.n
        self.n_entries = n_entries

    def solve(self, b):
        return solve_with_plan(self._pa, b)

    def update_values(self, data) -> "ScanBoundSolve":
        with obs.span(
            "backend.update_values", cat="backend", backend=self.backend
        ):
            data = self._check_data(data).astype(numpy_dtype(self._pa.vals.dtype))
            vals, diag = masked_value_gather(
                torch.from_numpy(data).to(self._pa.vals.device),
                self._val_src,
                self._pa.vals,
                self._diag_src,
                self._pa.diag,
            )
        return type(self)(
            self._pa._replace(vals=vals, diag=diag),
            self._val_src,  # index tensors shared, read-only
            self._diag_src,
            n_entries=self.n_entries,
        )

    def describe(self) -> dict:
        T, k, W = self._pa.col_idx.shape
        tensors = (*self._pa[:6], self._val_src, self._diag_src)
        return {
            "backend": self.backend,
            "n": self.n,
            "n_steps": T,
            "k": k,
            "W": W,
            "dtype": str(self._pa.vals.dtype).replace("torch.", ""),
            "device": str(self._pa.vals.device),
            "device_bytes": int(sum(t.numel() * t.element_size() for t in tensors)),
        }


@register_backend
class ScanBackend(Backend):
    """A loop of eager PyTorch steps over the plan (``kernels.ref``); on
    one device the superstep barriers are implicit in the step order."""

    name = "scan"
    bound_cls = ScanBoundSolve

    @staticmethod
    def plan_arrays(exec_plan, *, dtype, device):
        return plan_arrays(exec_plan, dtype=dtype, device=device)

    def bind(self, exec_plan, *, dtype=torch.float32, device=None) -> BoundSolve:
        numpy_dtype(dtype)
        device = resolve_device(device)
        with obs.span("backend.bind", cat="backend", backend=self.name,
                      n=exec_plan.n):
            if exec_plan.val_src is None or exec_plan.diag_src is None:
                raise ValueError("the plan carries no value-source maps")
            return self.bound_cls(
                self.plan_arrays(exec_plan, dtype=dtype, device=device),
                torch.as_tensor(np.asarray(exec_plan.val_src, np.int32)).to(device),
                torch.as_tensor(np.asarray(exec_plan.diag_src, np.int32)).to(device),
                n_entries=expected_entry_count(exec_plan),
            )
