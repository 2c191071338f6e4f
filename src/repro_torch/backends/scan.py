"""Scan backend — the plain PyTorch executor behind the ``Backend``
protocol (step bodies in ``repro_torch.solver.executor``). ``bind(slack=s)``
binds the elastic macro-step loop (``"elastic"`` capability). Timed
solves run in segments: one per superstep (bulk), one per macro-step
(elastic). The bulk bound also solves one rhs per plan of a width class
in one traversal, grouped, banked and over resident slots (``"grouped"``
and ``"slots"``); the elastic bound does not."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends.base import (
    Backend,
    BoundSolve,
    bind_checks,
    device_bytes,
    masked_value_gather,
    numpy_dtype,
)
from repro_torch.backends.registry import register_backend
from repro_torch.device import resolve_device
from repro_torch.solver import executor
from repro_torch.solver.executor import (
    PlanArrays,
    _pad_to_window,
    elastic_plan_arrays,
    plan_arrays,
    solve_with_elastic,
    solve_with_elastic_timed,
    solve_with_plan,
    solve_with_plan_timed,
)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class ScanBoundSolve(BoundSolve):
    backend = "scan"
    # the plain executor reads only the plan tensors, so plans of one
    # width class (equal shapes) share one traversal, a lane per plan
    supports_grouped = True

    def __init__(self, pa: PlanArrays, val_src, diag_src, *, n_entries):
        self._pa = pa
        self._val_src = val_src  # int32[T, k, W] on the device
        self._diag_src = diag_src  # int32[T, k] on the device
        self.n = pa.n
        self.n_entries = n_entries

    def solve(self, b):
        return solve_with_plan(self._pa, b)

    def solve_timed(self, b):
        """Per-superstep timed solve: one segment per non-empty superstep
        of the plan (``solver.executor.solve_with_plan_timed``)."""
        return solve_with_plan_timed(self._pa, b)

    # width-class grouping and resident slots ("grouped", "slots"): the
    # executor's plain grouped, banked and resident solves
    @classmethod
    def solve_grouped(cls, bounds, b_cols):
        return executor.solve_with_plan_group([b._pa for b in bounds], b_cols)

    @classmethod
    def stack_bank(cls, bounds, perms, invs):
        return executor.stack_plan_bank([b._pa for b in bounds], perms, invs)

    @classmethod
    def solve_bank(cls, bank, lane_idx, B):
        return executor.solve_with_bank(bank, lane_idx, B)

    @classmethod
    def blank_rhs(cls, n, slots, dtype, device):
        return executor.blank_rhs(n, slots, dtype, device)

    @classmethod
    def insert_lane(cls, B_res, lane, b):
        return executor.insert_lane(B_res, lane, b)

    @classmethod
    def extract_lane(cls, X, lane):
        return executor.extract_lane(X, lane)

    @classmethod
    def solve_resident(cls, bank, lane_idx, B_res):
        return executor.solve_resident(bank, lane_idx, B_res)

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
            "device_bytes": device_bytes(
                (*self._pa[:6], self._val_src, self._diag_src)
            ),
        }


class ElasticScanBoundSolve(ScanBoundSolve):
    """The ``mode="elastic"`` scan bound: ``ceil(T / slack)`` macro-steps,
    each replaying its window's steps (``core.elastic``), bitwise-identical
    to ``ScanBoundSolve`` on the same plan. It has no grouped twin, as in
    the JAX package: width-class grouping stays on the bulk bound, and the
    bank methods it would inherit raise."""

    supports_grouped = False
    solve_grouped = BoundSolve.__dict__["solve_grouped"]
    stack_bank = BoundSolve.__dict__["stack_bank"]
    solve_bank = BoundSolve.__dict__["solve_bank"]
    blank_rhs = BoundSolve.__dict__["blank_rhs"]
    insert_lane = BoundSolve.__dict__["insert_lane"]
    extract_lane = BoundSolve.__dict__["extract_lane"]
    solve_resident = BoundSolve.__dict__["solve_resident"]

    def __init__(self, ea, elastic, val_src, diag_src, *, n_entries):
        self._ea = ea  # solver.executor.ElasticArrays
        self._elastic = elastic  # core.elastic.ElasticPlan certificate
        self._val_src = val_src  # int32[M, S, k, W] on the device (-1 padded)
        self._diag_src = diag_src  # int32[M, S, k] on the device (-1 padded)
        self.n = ea.n
        self.n_entries = n_entries
        # runtime side of the elastic certificate: what timed solves
        # executed, reported by describe() next to the certificate's
        # prediction (fresh per bound: update_values starts a new history)
        self._runtime = {"timed_solves": 0, "macro_steps_executed": 0}

    def solve(self, b):
        return solve_with_elastic(self._ea, b)

    def solve_timed(self, b):
        """Per-macro-step timed solve; adds the macro-steps it executed to
        the bound's runtime telemetry (``describe()["runtime"]``)."""
        x, steps = solve_with_elastic_timed(self._ea, b)
        self._runtime["timed_solves"] += 1
        self._runtime["macro_steps_executed"] += len(steps)
        return x, steps

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
        cert = self._elastic.stats()
        rt = dict(self._runtime)
        if rt["timed_solves"]:
            rt["macro_steps_per_solve"] = round(
                rt["macro_steps_executed"] / rt["timed_solves"], 2
            )
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
            "device_bytes": device_bytes(
                (*self._ea[:5], self._val_src, self._diag_src)
            ),
            # the certificate's barrier and step accounting
            "certificate": cert,
            # certificate (predicted) vs timed solves (executed)
            "runtime": {
                **rt,
                "predicted_macro_steps": M,
                "predicted_barrier_fusion": cert.get("barrier_fusion"),
                "predicted_step_fusion": cert.get("step_fusion"),
            },
        }


@register_backend
class ScanBackend(Backend):
    """A loop of eager PyTorch steps over the plan (``kernels.ref``); on
    one device the superstep barriers are implicit in the step order.
    ``bind(slack=s)`` binds the elastic macro-step loop."""

    name = "scan"

    def capabilities(self):
        return ("grouped", "elastic", "slots")

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
            exec_plan, n_entries = bind_checks(exec_plan, slack)
            if slack > 0:
                return self._bind_elastic(exec_plan, dtype=dtype, device=device,
                                          n_entries=n_entries)
            return ScanBoundSolve(
                plan_arrays(exec_plan, dtype=dtype, device=device),
                torch.as_tensor(np.asarray(exec_plan.val_src, np.int32)).to(device),
                torch.as_tensor(np.asarray(exec_plan.diag_src, np.int32)).to(device),
                n_entries=n_entries,
            )

    def _bind_elastic(self, exec_plan, *, dtype, device, n_entries):
        ep = exec_plan.elastic
        M, S = ep.n_macro_steps, ep.slack
        pad = M * S - exec_plan.n_steps

        # the source maps ride the same window padding; -1 marks padding so
        # device-side refreshes leave those slots untouched
        def src(a):
            a = _pad_to_window(np.asarray(a, np.int32), pad, -1)
            return torch.as_tensor(a.reshape(M, S, *a.shape[1:])).to(device)

        return ElasticScanBoundSolve(
            elastic_plan_arrays(exec_plan, slack=S, dtype=dtype, device=device),
            ep, src(exec_plan.val_src), src(exec_plan.diag_src), n_entries=n_entries,
        )
