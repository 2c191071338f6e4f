"""Quickstart for the PyTorch port: schedule and solve one sparse triangular
system through the ``repro_torch.pipeline`` front door.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

Without ``--device`` it runs on the card (the IC(0) factor of a 128 × 128
Poisson grid) and raises where CUDA is not available; ``--device cpu`` runs
the kernels' plain versions on a 64 × 64 grid (``--n``).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bsp_cost, check_validity, schedule_stats
from repro_torch.device import resolve_device
from repro_torch.pipeline import PlanCache, TriangularSolver, schedule
from repro_torch.solver import solve_lower_scipy
from repro_torch.sparse import dag_from_lower_csr, ichol0, poisson2d_matrix


def rel_err(x: torch.Tensor, ref: np.ndarray) -> float:
    return float(np.abs(x.cpu().double().numpy() - ref).max() / np.abs(ref).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--n", type=int, default=None,
                    help="grid side (default 128 on the card, 64 on the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    N = args.n or (128 if device.type == "cuda" else 64)

    # 1. a realistic matrix: IC(0) factor of a 2D Poisson problem
    L = ichol0(poisson2d_matrix(N))
    print(f"matrix: n={L.n_rows} nnz={L.nnz} device={device}")

    # 2. peek under the hood: the registry runs any strategy on the solve DAG
    dag = dag_from_lower_csr(L)
    sched = schedule(dag, 8, strategy="growlocal")
    check_validity(dag, sched)
    stats = schedule_stats(dag, sched)
    print(f"GrowLocal: {stats['n_supersteps']} supersteps, "
          f"modeled speed-up {stats['speedup_model']:.2f}x")
    for name in ("serial", "hdagg"):
        s = schedule(dag, 8, strategy=name)
        check_validity(dag, s)
        print(f"  vs {name:7s}: BSP cost ratio "
              f"{bsp_cost(dag, s) / bsp_cost(dag, sched):.2f}x")

    # 3. the one-call pipeline: plan (DAG -> schedule -> reorder -> compile ->
    #    bind) and solve; permutations are handled internally
    cache = PlanCache()
    solver = TriangularSolver.plan(L, strategy="growlocal", k=8, cache=cache, device=device)
    print(f"plan: {solver.exec_plan.stats()}")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(L.n_rows)
    x = solver.solve(b)

    # 4. verify against scipy
    x_ref = solve_lower_scipy(L, b)
    err = rel_err(x, x_ref)
    print(f"relative error vs scipy: {err:.2e}")
    assert err < 1e-3

    # 5. batched multi-RHS: one plan traversal solves all columns
    B = rng.standard_normal((L.n_rows, 4))
    X = solver.solve(B)
    for j in range(B.shape[1]):
        assert rel_err(X[:, j], solve_lower_scipy(L, B[:, j])) < 1e-3
    print(f"multi-RHS: solved {B.shape[1]} systems in one traversal")

    # 6. a second plan on the same pattern is a cache hit — no rescheduling
    TriangularSolver.plan(L, strategy="growlocal", k=8, cache=cache, device=device)
    print(f"cache: {cache.stats.as_dict()}")
    assert cache.stats.hits == 1

    # 7. or skip choosing altogether: strategy="auto" extracts DAG features,
    #    shortlists candidate configs by regime and scores them with the §2.2
    #    cost model — the whole selection is memoized per sparsity pattern
    #    (fresh cache here so the auto-built solver, not the step-3 entry,
    #    is what comes back — `selection` records how a solver was built)
    auto_cache = PlanCache()
    auto = TriangularSolver.plan(L, strategy="auto", k=8, cache=auto_cache, device=device)
    sel = auto.selection
    print(f"auto: regime={sel.regime!r} picked {sel.strategy!r} (slack "
          f"{sel.options.slack}) from "
          f"{[(s, round(c)) for s, c in sel.as_dict()['candidates']]}")
    assert rel_err(auto.solve(b), x_ref) < 1e-3
    best_cand = min(c for _, c in sel.as_dict()["candidates"])
    assert sel.cost <= best_cand  # the winner is the argmin of the shortlist
    # replanning is free: the selection memo + plan cache absorb everything
    TriangularSolver.plan(L, strategy="auto", k=8, cache=auto_cache, device=device)
    assert auto_cache.stats.selections == 1
    assert auto_cache.stats.selection_hits == 1
    print("OK")


if __name__ == "__main__":
    main()
