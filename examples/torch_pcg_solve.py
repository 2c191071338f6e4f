"""End-to-end use of the PyTorch port (the paper's motivating
application): IC(0)-preconditioned conjugate gradient on a 2D Poisson
system, with BOTH triangular solves per iteration executed from scheduled
plans by the CUDA kernels, and CG's matvec by the SpMV kernel.

This serves a batch of solve requests against one factorization — the
amortization regime of paper §7.7: a shared ``PlanCache`` means the
inspector (DAG -> schedule -> reorder -> compile) runs once for the
pattern; every later request hits the cache and skips it.

    PYTHONPATH=src python examples/torch_pcg_solve.py               # the card
    PYTHONPATH=src python examples/torch_pcg_solve.py --device cpu  # plain versions

Without ``--device`` it runs on the card and raises where CUDA is not
available; ``--device cpu`` runs the kernels' plain versions at a smaller
grid (``--n``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import PlanCache
from repro_torch.device import resolve_device
from repro_torch.solver import cg_solve, pcg_ichol
from repro_torch.sparse import poisson2d_matrix


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--n", type=int, default=None,
                    help="grid side (default 96 on the card, 32 on the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    N = args.n or (96 if device.type == "cuda" else 32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    A = poisson2d_matrix(N)
    rng = np.random.default_rng(0)
    print(f"system: n={A.n_rows} nnz={A.nnz} device={device}")

    # a stream of right-hand sides (requests) against the same pattern
    n_requests = 5
    rhs = [rng.standard_normal(A.n_rows) for _ in range(n_requests)]

    t0 = time.time()
    x0, it0, rr0 = cg_solve(A, rhs[0], tol=1e-6, maxiter=4000, device=device)
    sync()
    t_plain = time.time() - t0
    print(f"plain CG      : {it0:4d} iterations, relres {rr0:.1e}, {t_plain:.2f}s")

    # pinned to GrowLocal (pcg_ichol's default is the autotuner, "auto")
    cache = PlanCache()
    t0 = time.time()
    x1, it1, rr1, info = pcg_ichol(A, rhs[0], k=8, strategy="growlocal", tol=1e-6,
                                   maxiter=4000, cache=cache, device=device)
    sync()
    t_pcg_first = time.time() - t0
    print(f"growlocal PCG : {it1:4d} iterations, relres {rr1:.1e}, "
          f"{t_pcg_first:.2f}s (includes the one-time IC(0) and inspector)")
    print(f"  schedules: fwd {info['fwd_strategy']} "
          f"({info['fwd_supersteps']} supersteps) / bwd {info['bwd_strategy']} "
          f"({info['bwd_supersteps']} supersteps)")
    assert it1 < it0
    np.testing.assert_allclose(x1.cpu().numpy(), x0.cpu().numpy(), rtol=2e-2, atol=2e-3)

    # remaining requests amortize the inspector through the plan cache
    t0 = time.time()
    for b in rhs[1:]:
        x, it, rr, info = pcg_ichol(A, b, k=8, strategy="growlocal", tol=1e-6,
                                    maxiter=4000, cache=cache, device=device)
        assert rr < 1e-4
    sync()
    t_rest = (time.time() - t0) / (n_requests - 1)
    print(f"amortized request latency: {t_rest:.2f}s "
          f"(vs {t_plain:.2f}s unpreconditioned)")
    print(f"plan cache: {info['cache']}")
    assert info["cache"]["misses"] == 2  # fwd + bwd, planned exactly once
    assert info["cache"]["hits"] == 2 * (n_requests - 1)
    print("OK")


if __name__ == "__main__":
    main()
