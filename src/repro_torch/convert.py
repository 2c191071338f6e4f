"""Carry state into the port from plain numpy fields.

A plan or a matrix made elsewhere (for example by the JAX package, whose
dataclasses become dicts through ``dataclasses.asdict``) enters the port as
a dict of numpy arrays and scalars; nothing here imports that package.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.plan import ExecPlan
from repro_torch.core.schedule import Schedule
from repro_torch.sparse.csr import CSRMatrix

PLAN_FIELDS = (
    "n", "k", "W", "row_ids", "col_idx", "vals", "diag", "accum",
    "step_bounds", "val_src", "diag_src",
)


def exec_plan_from_numpy(fields: dict) -> ExecPlan:
    """An ``ExecPlan`` from its fields (``n, k, W`` and the plan arrays);
    arrays are copied, so the port never shares memory with the source."""
    missing = [f for f in PLAN_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"plan fields missing: {missing}")

    def arr(name):
        a = fields[name]
        return None if a is None else np.array(a, copy=True)

    return ExecPlan(
        n=int(fields["n"]),
        k=int(fields["k"]),
        W=int(fields["W"]),
        **{f: arr(f) for f in PLAN_FIELDS[3:]},
    )


def csr_from_numpy(n_rows: int, n_cols: int, indptr, indices, data) -> CSRMatrix:
    """A ``CSRMatrix`` from raw ``(indptr, indices, data)`` arrays, in the
    dtypes the port's inspector uses (int64 indices, float64 values)."""
    return CSRMatrix(
        int(n_rows),
        int(n_cols),
        np.array(indptr, dtype=np.int64),
        np.array(indices, dtype=np.int64),
        np.array(data, dtype=np.float64),
    )


def schedule_from_numpy(n, k, pi, sigma, rank, n_supersteps) -> Schedule:
    """A ``Schedule`` from its fields, field by field, in the dtypes the
    port's schedulers produce (int32 ``pi`` / ``sigma``, int64 ``rank``);
    arrays are copied. ``TriangularSolver.plan(sched=...)`` takes it."""
    return Schedule(
        n=int(n),
        k=int(k),
        pi=np.array(pi, dtype=np.int32),
        sigma=np.array(sigma, dtype=np.int32),
        rank=np.array(rank, dtype=np.int64),
        n_supersteps=int(n_supersteps),
    )


def lm_params_from_numpy(cfg, tree, device=None, dtype=None):
    """The port's parameter tree for ``cfg`` from a nested dict of numpy
    arrays (for example the JAX package's parameters through
    ``jax.tree_util.tree_map(np.asarray, params)``). Every key and shape is
    checked against ``param_specs(cfg)``: a missing, extra or misshaped
    leaf raises ``ValueError``. Arrays are copied, cast to ``dtype`` where
    one is given, and placed on ``device`` (the card unless
    ``device="cpu"``)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.common import tree_paths
    from repro_torch.models.lm import param_specs

    dev = resolve_device(device)
    want = tree_paths(param_specs(cfg))
    got = tree_paths(tree)
    missing = sorted("/".join(p) for p in want.keys() - got.keys())
    extra = sorted("/".join(p) for p in got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter leaves missing {missing}, extra {extra}")
    bad = sorted(f"{'/'.join(p)}: {np.shape(got[p])} != {want[p].shape}"
                 for p in want if tuple(np.shape(got[p])) != tuple(want[p].shape))
    if bad:
        raise ValueError(f"{cfg.name}: misshaped parameter leaves {bad}")

    def leaf(path):
        t = torch.from_numpy(np.array(got[path], copy=True))
        return t.to(device=dev, dtype=dtype or t.dtype)

    out: dict = {}
    for path in sorted(want):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(path)
    return out


def train_state_from_numpy(cfg, tree, device=None):
    """The port's ``TrainState`` for ``cfg`` from ``{"params", "opt_state":
    {"mu", "nu", "step"}}`` of numpy arrays (for example a JAX
    ``TrainState`` through ``{"params": s.params, "opt_state":
    s.opt_state}`` and ``np.asarray``). ``params``, ``mu`` and ``nu`` are
    checked as ``lm_params_from_numpy`` checks parameters, ``step`` must be
    a scalar, and a missing or extra key raises ``ValueError``. Arrays are
    copied (``step`` to int32) and placed on ``device`` (the card unless
    ``device="cpu"``)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.train.train_loop import TrainState

    def keys(node, want, where):
        if not isinstance(node, dict) or set(node) != want:
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"{cfg.name}: {where} must have the keys {sorted(want)}, "
                             f"got {got}")

    keys(tree, {"params", "opt_state"}, "a train state")
    opt = tree["opt_state"]
    keys(opt, {"mu", "nu", "step"}, "opt_state")
    if np.shape(opt["step"]) != ():
        raise ValueError(f"{cfg.name}: opt_state step must be a scalar, "
                         f"got shape {np.shape(opt['step'])}")
    dev = resolve_device(device)
    return TrainState(
        params=lm_params_from_numpy(cfg, tree["params"], device=dev),
        opt_state={
            "mu": lm_params_from_numpy(cfg, opt["mu"], device=dev),
            "nu": lm_params_from_numpy(cfg, opt["nu"], device=dev),
            "step": torch.tensor(int(opt["step"]), dtype=torch.int32, device=dev),
        },
    )
