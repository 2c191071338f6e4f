"""Scan backend — the plain PyTorch executor behind the ``Backend``
protocol (step bodies in ``repro_torch.solver.executor``). ``bind(slack=s)``
binds the elastic macro-step loop (``"elastic"`` capability)."""
from __future__ import annotations

import dataclasses

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
from repro_torch.core.elastic import elastic_transform
from repro_torch.device import resolve_device
from repro_torch.solver.executor import (
    PlanArrays,
    _pad_to_window,
    elastic_plan_arrays,
    plan_arrays,
    solve_with_elastic,
    solve_with_plan,
)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _device_bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


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

    def _refreshed(self, data):
        """(vals, diag) gathered from ``data`` on the bound's device."""
        arrays = self._arrays()
        with obs.span(
            "backend.update_values", cat="backend", backend=self.backend
        ):
            data = self._check_data(data).astype(numpy_dtype(arrays.vals.dtype))
            return masked_value_gather(
                torch.from_numpy(data).to(arrays.vals.device),
                self._val_src,
                arrays.vals,
                self._diag_src,
                arrays.diag,
            )

    def _arrays(self):
        return self._pa

    def update_values(self, data) -> "ScanBoundSolve":
        vals, diag = self._refreshed(data)
        return type(self)(
            self._pa._replace(vals=vals, diag=diag),
            self._val_src,  # index tensors shared, read-only
            self._diag_src,
            n_entries=self.n_entries,
        )

    def describe(self) -> dict:
        T, k, W = self._pa.col_idx.shape
        return {
            "backend": self.backend,
            "n": self.n,
            "n_steps": T,
            "k": k,
            "W": W,
            "dtype": _dtype_name(self._pa.vals),
            "device": str(self._pa.vals.device),
            "device_bytes": _device_bytes(
                (*self._pa[:6], self._val_src, self._diag_src)
            ),
        }


class ElasticScanBoundSolve(ScanBoundSolve):
    """The ``mode="elastic"`` scan bound: ``ceil(T / slack)`` macro-steps,
    each replaying its window's steps (``core.elastic``), bitwise-identical
    to ``ScanBoundSolve`` on the same plan."""

    def __init__(self, ea, elastic, val_src, diag_src, *, n_entries):
        self._ea = ea  # solver.executor.ElasticArrays
        self._elastic = elastic  # core.elastic.ElasticPlan certificate
        self._val_src = val_src  # int32[M, S, k, W] on the device (-1 padded)
        self._diag_src = diag_src  # int32[M, S, k] on the device (-1 padded)
        self.n = ea.n
        self.n_entries = n_entries

    def solve(self, b):
        return solve_with_elastic(self._ea, b)

    def _arrays(self):
        return self._ea

    def update_values(self, data) -> "ElasticScanBoundSolve":
        vals, diag = self._refreshed(data)
        return type(self)(
            self._ea._replace(vals=vals, diag=diag),
            self._elastic,
            self._val_src,  # index tensors shared, read-only
            self._diag_src,
            n_entries=self.n_entries,
        )

    def describe(self) -> dict:
        M, S, k, W = self._ea.col_idx.shape
        return {
            "backend": self.backend,
            "mode": "elastic",
            "n": self.n,
            "n_steps": self._ea.n_steps,
            "n_macro_steps": M,
            "slack": S,
            "slack_unit": "plan_steps",  # a macro-step's window
            "k": k,
            "W": W,
            "dtype": _dtype_name(self._ea.vals),
            "device": str(self._ea.vals.device),
            "device_bytes": _device_bytes(
                (*self._ea[:5], self._val_src, self._diag_src)
            ),
            # the certificate's barrier and step accounting
            "certificate": self._elastic.stats(),
        }


@register_backend
class ScanBackend(Backend):
    """A loop of eager PyTorch steps over the plan (``kernels.ref``); on
    one device the superstep barriers are implicit in the step order.
    ``bind(slack=s)`` binds the elastic macro-step loop."""

    name = "scan"
    bound_cls = ScanBoundSolve
    elastic_bound_cls = ElasticScanBoundSolve

    @staticmethod
    def plan_arrays(exec_plan, *, dtype, device):
        return plan_arrays(exec_plan, dtype=dtype, device=device)

    @staticmethod
    def elastic_arrays(exec_plan, *, dtype, device):
        """The first argument of ``elastic_bound_cls``: here the plan in
        macro-step layout (``ElasticArrays``)."""
        return elastic_plan_arrays(
            exec_plan, slack=exec_plan.elastic.slack, dtype=dtype, device=device
        )

    def capabilities(self):
        return ("elastic",)

    def bind(self, exec_plan, *, dtype=torch.float32, device=None, slack=0) -> BoundSolve:
        numpy_dtype(dtype)
        if slack > 0 and "elastic" not in self.capabilities():
            raise ValueError(
                f"backend {self.name!r} does not support slack={slack} "
                "(no 'elastic' capability)"
            )
        device = resolve_device(device)
        with obs.span("backend.bind", cat="backend", backend=self.name,
                      n=exec_plan.n, slack=slack):
            if exec_plan.val_src is None or exec_plan.diag_src is None:
                raise ValueError("the plan carries no value-source maps")
            n_entries = expected_entry_count(exec_plan)
            if slack > 0:
                return self._bind_elastic(
                    exec_plan, dtype=dtype, device=device, slack=slack,
                    n_entries=n_entries,
                )
            return self.bound_cls(
                self.plan_arrays(exec_plan, dtype=dtype, device=device),
                torch.as_tensor(np.asarray(exec_plan.val_src, np.int32)).to(device),
                torch.as_tensor(np.asarray(exec_plan.diag_src, np.int32)).to(device),
                n_entries=n_entries,
            )

    def _bind_elastic(self, exec_plan, *, dtype, device, slack, n_entries):
        ep = exec_plan.elastic
        if ep is None or ep.slack != slack:
            ep = elastic_transform(exec_plan, slack)
            exec_plan = dataclasses.replace(exec_plan, elastic=ep)
        M, S = ep.n_macro_steps, ep.slack
        pad = M * S - exec_plan.n_steps

        # the source maps ride the same window padding; -1 marks padding so
        # device-side refreshes leave those slots untouched
        def src(a):
            a = _pad_to_window(np.asarray(a, np.int32), pad, -1)
            return torch.as_tensor(a.reshape(M, S, *a.shape[1:])).to(device)

        return self.elastic_bound_cls(
            self.elastic_arrays(exec_plan, dtype=dtype, device=device),
            ep, src(exec_plan.val_src), src(exec_plan.diag_src), n_entries=n_entries,
        )
