"""Distributed backend — the mesh executors behind the ``Backend`` protocol
(device work in ``repro_torch.solver.distributed`` and
``repro_torch.solver.rowsharded``; the mesh in ``repro_torch.mesh``).

Two mesh decompositions of one plan, as in the JAX package:

  * ``shard="model"`` (default): the k schedule cores are the positions of
    the mesh's ``model`` axis; every exchange round ends in an all-gather
    of the rows the round finished.
  * ``shard="rows"`` (capability ``"shard-rows"``): the plan's rows are
    partitioned into contiguous core blocks (``core.rowshard``), each
    position walks its shard's local plan on a resident x, and rounds
    exchange only the boundary values other shards read (the ring form).
    This also lifts the ``k <= model`` restriction.

Both run each position's share of a round as one range launch of the level
kernel (``kernels.sptrsv.sptrsv_level_range_cuda``) on the position's
stream; positions on the CPU take its plain version. Both execute
``bind(slack=s)`` elastically (capability ``"elastic"``): the elastic
certificate's fused superstep runs (``core.elastic``) become single
exchange rounds; ``slack`` counts supersteps here (``slack_unit``).
``describe()["exchange"]`` reports the rounds and the comm model with the
JAX package's keys.

A bound keeps no padded plan on the device: each position's level tensors
carry their value sources, gathered by the level order's ``perm`` at bind,
so ``update_values`` is one masked gather per position, bitwise a fresh
bind. Without ``jit`` there are no compiled variants, so the JAX bounds'
``compiled_batch_sizes`` has no counterpart and ``describe()`` leaves it
out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends.base import (
    Backend,
    BoundSolve,
    device_bytes,
    expected_entry_count,
    numpy_dtype,
)
from repro_torch.backends.registry import register_backend
from repro_torch.core.elastic import elastic_transform
from repro_torch.device import resolve_device, timed_us
from repro_torch.kernels.ops import refresh_level_values
from repro_torch.solver import distributed as dist
from repro_torch.solver import rowsharded as rows
from repro_torch.solver.executor import pad_rhs


def _dtype_name(np_dtype) -> str:
    return np.dtype(np_dtype).name


def _distinct(grid):
    """The distinct objects of a ``[data][model]`` grid, in order."""
    seen = {}
    for row in grid:
        for v in row:
            seen.setdefault(id(v), v)
    return list(seen.values())


def _refresh(plan_args, data: np.ndarray):
    """``plan_args`` with every position's values gathered from ``data``
    (already in the plan dtype) through its level-ordered sources — one
    gather per distinct ``RoundLevels``, the data copied once per device."""
    on_dev, new = {}, {}
    for rl in _distinct(plan_args):
        dev = rl.la.vals.device
        t = on_dev.get(str(dev))
        if t is None:
            t = on_dev[str(dev)] = torch.from_numpy(data).to(dev)
        new[id(rl)] = rl._replace(la=refresh_level_values(rl.la, rl.val_src, rl.diag_src, t))
    return [[new[id(v)] for v in row] for row in plan_args]


def _level_bytes(plan_args) -> int:
    return device_bytes(t for rl in _distinct(plan_args)
                        for t in (*rl.la[:8], rl.val_src, rl.diag_src))


def _launches_per_solve(plan_args, mesh) -> dict:
    """Range launches a solve makes: one per position and round where the
    position has levels; one right-hand side on data row 0, m on every
    data row."""
    row = sum(1 for rl in plan_args[0] for lo, hi in zip(rl.ranges[:-1], rl.ranges[1:])
              if hi > lo)
    return {"single": row, "mrhs": row * mesh.shape["data"]}


def _padded_cols(m: int, data_ax: int) -> int:
    return -(-m // data_ax) * data_ax


class _MeshBound(BoundSolve):
    """What both mesh bounds share: the home device (where ``b`` arrives and
    x returns), the checks and the timed rounds."""

    backend = "distributed"

    def _check_rhs(self, b) -> torch.Tensor:
        b = torch.as_tensor(b).to(device=self._home, dtype=self._dtype)
        if b.dim() not in (1, 2) or b.shape[0] != self.n:
            raise ValueError(f"b must be [n] or [n, m] with n={self.n}; got {tuple(b.shape)}")
        return b

    def _data(self, data) -> np.ndarray:
        return self._check_data(data).astype(self._np_dtype)

    def _timed_rounds(self, run, n_rounds, describe_round):
        """Time each round (``run(r)``: its launches and exchange) with
        ``device.timed_us`` under an ``executor.exchange_round`` span;
        ``describe_round(r)`` gives the step record's fields."""
        steps = []
        for r in range(n_rounds):
            rec = describe_round(r)
            with obs.span("executor.exchange_round", cat="executor", round=r,
                          supersteps=rec.pop("supersteps"), halo_bytes=rec["halo_bytes"]):
                busy, us = timed_us(lambda r=r: run(r), self._home)
            steps.append({"round": r, **rec, "launches": busy, "us": us})
        return steps



class DistributedBoundSolve(_MeshBound):
    """The ``shard="model"`` bound: a lane of the plan per model position,
    an all-gather after every exchange round."""

    def __init__(self, plan, spec, mesh, plan_args, gather_args, np_dtype, home, n_entries,
                 exchange_info=None):
        self._plan = plan  # the host plan, cores padded to the model axis
        self._spec = spec  # solver.distributed.DistPlanSpec
        self._solve = dist.build_distributed_solver(spec, mesh)
        self._mesh = mesh
        self._args = plan_args  # [data][model] RoundLevels
        self._gather = gather_args  # per round: GatherRound
        self._np_dtype = np.dtype(np_dtype)
        self._dtype = torch.float32 if self._np_dtype == np.float32 else torch.float64
        self._home = home
        self._exchange_info = exchange_info
        self.n = plan.n
        self.n_entries = n_entries

    def _b_rows(self, b):
        """``(b_pad, m)``: b f[n] padded with the scratch row, or B f[n, m]
        as f[mp, n+1] rows (the m-RHS kernel's column-major layout), mp a
        multiple of the data axis; m None for one right-hand side."""
        if b.dim() == 1:
            return pad_rhs(b), None
        m = b.shape[1]
        rows_ = b.new_zeros((_padded_cols(m, self._mesh.shape["data"]), self.n + 1))
        rows_[:m, : self.n] = b.T
        return rows_, m

    @staticmethod
    def _x(x, m, n):
        return x[:n] if m is None else x[:m, :n].T

    def solve(self, b):
        b_pad, m = self._b_rows(self._check_rhs(b))
        return self._x(self._solve(self._args, self._gather, b_pad), m, self.n)

    def solve_timed(self, b):
        """Per-round timed solve: each round (the launches and the
        all-gather) timed on the card with CUDA events (``timed_us``); the
        same bits as ``solve``. A step's ``halo_values`` follow the JAX
        package's comm model, k values per plan step of the round."""
        b_pad, m = self._b_rows(self._check_rhs(b))
        single = m is None
        bs, xs = dist.place_rhs(self._mesh, b_pad, single)
        used = dist.positions(self._mesh, single)
        spec, sb, eb = self._spec, self._spec.step_bounds, self._spec.exchange_bounds
        k = self._plan.k
        n_rhs = 1 if single else b_pad.shape[0]
        itemsize = self._np_dtype.itemsize

        def run(r):
            self._mesh.fork(used)
            busy = dist.run_round(self._mesh, self._args, self._gather, r, bs, xs, single)
            self._mesh.join(used)
            return busy

        def describe_round(r):
            steps = sb[eb[r + 1]] - sb[eb[r]]
            return {"supersteps": eb[r + 1] - eb[r], "n_steps": steps,
                    "halo_values": k * steps * n_rhs,
                    "halo_bytes": k * steps * n_rhs * itemsize}

        steps = self._timed_rounds(run, spec.n_rounds, describe_round)
        x = dist.collect(self._mesh, xs, single, self._home)
        return self._x(x, m, self.n), steps

    def update_values(self, data) -> "DistributedBoundSolve":
        with obs.span("backend.update_values", cat="backend", backend=self.backend):
            args = _refresh(self._args, self._data(data))
        return DistributedBoundSolve(
            self._plan, self._spec, self._mesh, args, self._gather, self._np_dtype, self._home,
            self.n_entries, exchange_info=self._exchange_info)

    def level_audit(self) -> list:
        """``(plan, order, rows, bounds, ranges)`` for each model position's
        bound level order: the plan it was built from (a lane of the plan),
        the rows that plan must finish, the exchange bounds (supersteps)
        and the round ranges — what ``analysis.verify_mesh_levels_report``
        audits after a bind. Built on demand, for the verifier."""
        plan, eb = self._plan, self._spec.exchange_bounds
        fin = dist.lane_rows(plan, range(plan.n_supersteps + 1))
        return [(dist.lane_plan(plan, p), rl.la.order,
                 np.concatenate([r[p] for r in fin]), eb, rl.ranges)
                for p, rl in enumerate(self._args[0])]

    def describe(self) -> dict:
        plan = self._plan
        n_sup = plan.n_supersteps
        rounds = self._spec.n_rounds
        # the comm model per position per RHS: every barrier gathers each
        # core's values for the run's steps -> k * T values per solve
        ag_values = int(plan.k * plan.n_steps)
        exchange = {
            "mode": "all_gather",
            "shard": "model",
            "rounds": rounds,
            "n_supersteps": n_sup,
            "executed_fusion": round(n_sup / max(rounds, 1), 4),
            "comm_values_per_solve": ag_values,
            "comm_bytes_per_solve": ag_values * self._np_dtype.itemsize,
        }
        if self._exchange_info:
            exchange.update(self._exchange_info)
        return {
            "backend": self.backend,
            "shard": "model",
            "n": self.n,
            "n_steps": plan.n_steps,
            "k": plan.k,
            "W": plan.W,
            "n_supersteps": n_sup,
            "dtype": _dtype_name(self._np_dtype),
            "mesh": dict(self._mesh.shape),
            "devices": sorted({str(d) for d in self._mesh.devices.ravel()}),
            "slack_unit": "supersteps",
            "n_levels": [rl.la.level_ptr.numel() - 1 for rl in self._args[0]],
            "launches_per_solve": _launches_per_solve(self._args, self._mesh),
            "device_bytes": _level_bytes(self._args) + device_bytes(
                t for g in self._gather for grid in (g.rows, g.all_rows)
                for t in _distinct(grid)),
            "exchange": exchange,
        }


class RowShardedBoundSolve(_MeshBound):
    """The ``shard="rows"`` bound: per-position local plans with resident
    x-shards and halo exchange (``core.rowshard`` partition,
    ``solver.rowsharded`` executor). ``update_values`` gathers new entry
    data through each shard's level-ordered GLOBAL entry sources — each
    local plan keeps the caller's entry ids, so a refactorization is one
    gather per position, no repartition."""

    def __init__(self, rsp, mesh, mode, plan_args, halo_args, np_dtype, home, n_entries,
                 exchange_info=None):
        self._rsp = rsp  # core.rowshard.RowShardPlan (host tensors)
        self._mesh = mesh
        self._mode = mode  # "ring" | "psum"
        self._spec = spec = rows.rowshard_spec(rsp, mode=mode)
        self._solve = rows.build_rowsharded_solver(spec, mesh)
        self._rounds = [rows.build_rowsharded_round(spec, mesh, r) for r in range(spec.n_rounds)]
        self._plan_args = plan_args  # [data][model] RoundLevels
        self._halo_args = halo_args  # per round but the last
        self._np_dtype = np.dtype(np_dtype)
        self._dtype = torch.float32 if self._np_dtype == np.float32 else torch.float64
        self._home = home
        self._exchange_info = exchange_info
        self.n = rsp.n
        self.n_entries = n_entries
        self._comm = rsp.comm_stats(self._np_dtype.itemsize)
        self._b_scatter = torch.as_tensor(rsp.b_scatter).to(home)
        self._x_gather = torch.as_tensor(rsp.x_gather).to(home)

    def _scatter_b(self, b):
        """``(b_loc, m)``: the rhs scattered into per-shard local slots,
        f[n_shards, slots] or f[n_shards, slots, mp] (mp a multiple of the
        data axis; halo and scratch slots zero); m None for one rhs."""
        rsp = self._rsp
        if b.dim() == 1:
            bl = b.new_zeros(rsp.n_shards * rsp.slots)
            bl[self._b_scatter] = b
            return bl.view(rsp.n_shards, rsp.slots), None
        m = b.shape[1]
        mp = _padded_cols(m, self._mesh.shape["data"])
        bl = b.new_zeros((rsp.n_shards * rsp.slots, mp))
        bl[self._b_scatter, :m] = b
        return bl.view(rsp.n_shards, rsp.slots, mp), m

    def _gather_x(self, out, m):
        """Stacked owned regions -> global row order (on the device)."""
        rsp = self._rsp
        if m is None:
            return out.reshape(rsp.n_shards * rsp.n_loc)[self._x_gather]
        return out.reshape(rsp.n_shards * rsp.n_loc, -1)[self._x_gather][:, :m]

    def _per_rhs(self) -> int:
        return (self._comm["halo_values_psum"] if self._mode == "psum"
                else self._comm["halo_values_per_solve"])

    def _count_comm(self, n_rhs: int):
        obs.counter_add("rowshard.halo_values", self._per_rhs() * n_rhs)
        obs.counter_add("rowshard.halo_bytes",
                        self._per_rhs() * n_rhs * self._np_dtype.itemsize)

    def solve(self, b):
        b_loc, m = self._scatter_b(self._check_rhs(b))
        self._count_comm(1 if m is None else b_loc.shape[2])
        with obs.span("rowshard.solve", cat="backend", n=self.n, n_shards=self._rsp.n_shards,
                      mode=self._mode, halo_bytes=self._comm["halo_bytes_per_solve"]):
            out = self._solve(self._plan_args, self._halo_args, b_loc)
            return self._gather_x(out, m)

    def solve_timed(self, b):
        """Per-exchange-round timed solve: each round (every shard's range
        launch and the halo exchange after it) timed on the card with CUDA
        events (``timed_us``) on the resident x-shards; the same bits as
        ``solve``."""
        rsp = self._rsp
        b_loc, m = self._scatter_b(self._check_rhs(b))
        single = m is None
        n_rhs = 1 if single else b_loc.shape[2]
        spec = self._spec
        bs, xs = rows.place_local_rhs(self._mesh, b_loc)
        self._count_comm(n_rhs)
        sb, eb = spec.step_bounds, spec.exchange_bounds
        itemsize = self._np_dtype.itemsize
        last = spec.n_rounds - 1

        def run(r):
            halo = self._halo_args[r] if r < last else None
            return self._rounds[r](self._plan_args, halo, bs, xs)

        def describe_round(r):
            hv = 0 if r == last else (rsp.rounds[r].ring_values if self._mode == "ring"
                                      else rsp.rounds[r].buf_size)
            return {"supersteps": eb[r + 1] - eb[r], "n_steps": sb[eb[r + 1]] - sb[eb[r]],
                    "halo_values": hv * n_rhs, "halo_bytes": hv * itemsize * n_rhs}

        steps = self._timed_rounds(run, spec.n_rounds, describe_round)
        out = rows.collect_owned(self._mesh, spec, xs, single, self._home)
        return self._gather_x(out, m), steps

    def update_values(self, data) -> "RowShardedBoundSolve":
        with obs.span("backend.update_values", cat="backend", backend=self.backend):
            args = _refresh(self._plan_args, self._data(data))
        return RowShardedBoundSolve(
            self._rsp, self._mesh, self._mode, args, self._halo_args, self._np_dtype,
            self._home, self.n_entries, exchange_info=self._exchange_info)

    def level_audit(self) -> list:
        """As ``DistributedBoundSolve.level_audit``, for each shard's local
        plan (it finishes the owned slots of its rows)."""
        rsp = self._rsp
        return [(rsp.shards[j], rl.la.order, rsp.local_slot[rsp.owner == j],
                 rsp.exchange_bounds, rl.ranges)
                for j, rl in enumerate(self._plan_args[0])]

    def describe(self) -> dict:
        rsp = self._rsp
        n_sup = len(rsp.step_bounds) - 1
        per = self._per_rhs()
        exchange = {
            "mode": self._mode,
            "shard": "rows",
            "rounds": rsp.n_rounds,
            "n_supersteps": n_sup,
            "executed_fusion": round(n_sup / max(rsp.n_rounds, 1), 4),
            "comm_values_per_solve": per,
            "comm_bytes_per_solve": per * self._np_dtype.itemsize,
            **{
                k: self._comm[k]
                for k in (
                    "halo_pairs",
                    "halo_values_per_solve",
                    "halo_bytes_per_solve",
                    "halo_values_max_round",
                    "allgather_values",
                    "allgather_bytes",
                    "halo_ratio",
                    "active_exchanges",
                )
            },
        }
        if self._exchange_info:
            exchange.update(self._exchange_info)
        halo_tables = [t for hr in self._halo_args for grid in hr
                       if isinstance(grid, list) for t in _distinct(grid)]
        return {
            "backend": self.backend,
            "shard": "rows",
            "n": self.n,
            "n_steps": rsp.T,
            "k": rsp.n_shards * rsp.k_local,
            "k_local": rsp.k_local,
            "W": rsp.W,
            "n_shards": rsp.n_shards,
            "n_loc": rsp.n_loc,
            "n_halo": rsp.n_halo,
            "n_supersteps": n_sup,
            "dtype": _dtype_name(self._np_dtype),
            "mesh": dict(self._mesh.shape),
            "devices": sorted({str(d) for d in self._mesh.devices.ravel()}),
            "slack_unit": "supersteps",
            "n_levels": [rl.la.level_ptr.numel() - 1 for rl in self._plan_args[0]],
            "launches_per_solve": _launches_per_solve(self._plan_args, self._mesh),
            "device_bytes": _level_bytes(self._plan_args) + device_bytes(halo_tables),
            "exchange": exchange,
        }


def _pad_cores(plan, model_ax: int):
    """Pad the plan's core axis UP to the mesh's ``model`` axis size so
    narrower schedules (e.g. serial's k=1 chains) shard cleanly — the
    executor assigns exactly one schedule core per model position, so k
    must end up equal to it. A plan with MORE cores than positions cannot
    be executed (each position walks one lane) and is rejected with a clear
    error. Padding lanes follow the plan's own protocol — row id n
    (scratch), self-gathers, val 0 / diag 1, source maps -1 — so their
    level orders are empty and they launch nothing."""
    k, kp = plan.k, model_ax
    if k > model_ax:
        raise ValueError(
            f"distributed backend: plan has k={k} schedule cores but the "
            f"mesh 'model' axis has only {model_ax} devices — schedule "
            f"with k <= mesh.shape['model'] (one core per device)"
        )
    if kp == k:
        return plan
    T, pad = plan.n_steps, kp - k

    def padk(a, fill):
        block = np.full((T, pad, *a.shape[2:]), fill, dtype=a.dtype)
        return np.concatenate([a, block], axis=1)

    return dataclasses.replace(
        plan,
        k=kp,
        row_ids=padk(plan.row_ids, plan.n),
        col_idx=padk(plan.col_idx, plan.n),
        vals=padk(plan.vals, 0),
        diag=padk(plan.diag, 1),
        accum=padk(plan.accum, False),
        val_src=None if plan.val_src is None else padk(plan.val_src, -1),
        diag_src=None if plan.diag_src is None else padk(plan.diag_src, -1),
    )


def _check_mesh(mesh):
    if mesh is None:
        raise ValueError("backend='distributed' requires a mesh")
    if sorted(mesh.shape) != ["data", "model"]:
        raise ValueError(f"the mesh needs 'data' and 'model' axes; got {tuple(mesh.shape)}")


@register_backend
class DistributedBackend(Backend):
    """BSP on a mesh of card positions: ``shard="model"`` — one
    all-gather per exchange round; ``shard="rows"`` — row partition with
    halo exchange. ``bind(slack=s)`` fuses certified superstep runs into
    single exchange rounds in either mode."""

    name = "distributed"

    def requires(self):
        return ("mesh",)

    def capabilities(self):
        return ("elastic", "shard-rows")

    def bind(self, exec_plan, *, dtype=torch.float32, device=None, slack=0, mesh=None,
             shard="model"):
        """Bind ``exec_plan`` on ``mesh`` (``repro_torch.mesh.make_mesh``).
        ``device`` is where ``b`` arrives and x returns (``None``: the
        mesh's first position's device)."""
        np_dtype = numpy_dtype(dtype)
        _check_mesh(mesh)
        if shard not in ("model", "rows"):
            raise ValueError(
                f"backend='distributed': unknown shard mode {shard!r} "
                "(expected 'model' or 'rows')"
            )
        if slack < 0:
            raise ValueError(f"slack must be >= 0; got {slack}")
        if exec_plan.val_src is None or exec_plan.diag_src is None:
            raise ValueError("the plan carries no value-source maps")
        home = mesh.devices.flat[0] if device is None else resolve_device(device)
        with obs.span("backend.bind", cat="backend", backend=self.name, n=exec_plan.n,
                      slack=slack, shard=shard):
            fused, info = None, None
            if slack > 0:
                ep = exec_plan.elastic
                fused = ep if ep is not None and ep.slack == slack else elastic_transform(
                    exec_plan, slack)
                info = {"slack": slack, "predicted_rounds": fused.n_fused_supersteps,
                        "predicted_fusion": fused.stats()["barrier_fusion"]}
            bind = self._bind_rows if shard == "rows" else self._bind_model
            return bind(exec_plan, dtype, np_dtype, mesh, home, fused, info)

    def _bind_model(self, exec_plan, dtype, np_dtype, mesh, home, fused, info):
        n_entries = expected_entry_count(exec_plan)
        plan = _pad_cores(exec_plan, mesh.shape["model"])
        bounds = None if fused is None else fused.fused_bounds
        spec = dist.dist_plan_spec(plan, exchange_bounds=bounds)
        eb = spec.exchange_bounds
        return DistributedBoundSolve(
            plan, spec, mesh, dist.dist_plan_args(plan, mesh, eb, dtype),
            dist.dist_exchange_args(plan, mesh, eb), np_dtype, home, n_entries,
            exchange_info=info)

    def _bind_rows(self, exec_plan, dtype, np_dtype, mesh, home, fused, info):
        from repro_torch.core.rowshard import partition_plan

        bounds = None if fused is None else fused.fused_bounds
        rsp = partition_plan(exec_plan, mesh.shape["model"], exchange_bounds=bounds)
        mode = "ring"  # bitwise-safe; psum is opt-in
        return RowShardedBoundSolve(
            rsp, mesh, mode, rows.rowshard_plan_args(rsp, mesh, dtype),
            rows.rowshard_halo_args(rsp, mesh, mode), np_dtype, home,
            expected_entry_count(exec_plan), exchange_info=info)
