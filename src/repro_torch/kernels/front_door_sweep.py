"""The front door's ordered solve beside the gathers it replaces, on the
card (CUDA events and the host clock, one process, one call).

    PYTHONPATH=src python3 -m repro_torch.kernels.front_door_sweep \\
        --parent-src DIR [--out FILE.jsonl] [--reps 20]

Builds ``csrc/sptrsv.cu`` as it ships (one library for both level orders)
and, from ``--parent-src`` (a directory with the previous commit's
``sptrsv.cu``, ``level.cuh``, ``rn.cuh`` and, where it has one,
``sptrsv_elastic.cu``), the parent's, which have no ordered solve. On the
benchmark's shapes:

  er      ER n = 100,000, p = 1e-4, growlocal, k = 8, bulk, float32, m = 1
          and m = 32
  nb      NB n = 100,000, p = 0.14, B = 10, funnel-gl, elastic, slack 8
          (the plan ``strategy="auto"`` picks there), float64, m = 1
  pfwd,   the IC(0) factor pair of the 512 x 512 Poisson grid, growlocal,
  pbwd    k = 8, bulk, float32, m = 1

it times, in the order parent, change, change, parent (median of ``reps``
calls after 3 warm-ups each turn):

  kernel_parent    the parent's unordered walk alone on b in plan row
                   order (x zeroed once, outside the clock)
  kernel_unordered this build's unordered walk alone, the same call (the
                   bank and range launches and the timed solves run it)
  kernel_ordered   this build's ordered solve alone (one cooperative
                   launch: b moved into plan row order, the walk, x moved
                   back) on b in the caller's row order, x and the scratch
                   allocated once
  solve_gather     the front door's path before: b gathered, padded, the
                   unordered kernel on a zeroed x, x sliced and gathered
                   back, as ``solve()`` then a synchronize (host clock)
  solve_ordered    ``TriangularSolver.solve`` now, then a synchronize

Every answer is held bitwise: the ordered x against the gathered one and
the parent kernel's x against this build's. It also counts the ordered
launches of the timed front-door solves (one a solve). Writes one JSON
object per line to stdout and to ``--out``; exits non-zero where a check
fails or no CUDA device is present.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, sptrsv
from repro_torch.kernels.level_sweep import bits_equal, median_ms, nvcc_job
from repro_torch.solver.executor import pad_rhs

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the unordered entries of both builds: the level tensors but level_ptr,
# the chunk table, level count, W, stage layout (and m, rows), b, x, stream
_SINGLE = [_P] * 8 + [_I] * 4 + [_P] * 3
_COLS = [_P] * 8 + [_I] * 5 + [_I64] + [_P] * 3


def _cells():
    """name -> (solver, m values): the benchmark's shapes on the card."""
    from repro_torch import TriangularSolver, factor_pair
    from repro_torch.sparse import erdos_renyi_lower, ichol0, narrow_band_lower, poisson2d_matrix

    er = TriangularSolver.plan(erdos_renyi_lower(100_000, 1e-4, seed=0), strategy="growlocal",
                               k=8)
    nb = TriangularSolver.plan(narrow_band_lower(100_000, 0.14, 10, seed=0),
                               strategy="funnel-gl", mode="elastic", slack=8,
                               dtype=torch.float64)
    fwd, bwd = factor_pair(ichol0(poisson2d_matrix(512)), strategy="growlocal", k=8)
    return {"er": (er, (None, 32)), "nb": (nb, (None,)), "pfwd": (fwd, (None,)),
            "pbwd": (bwd, (None,))}


class _Unordered:
    """One build's unordered entry of a solver's walk, ``prefix`` naming
    it in ``lib``: ``call(b_pad, x)``."""

    def __init__(self, lib, prefix, solver, m):
        kind = "single" if m is None else "mrhs"
        la = solver.bound._la
        self.fn = getattr(lib, f"{prefix}_{kind}_{_SUFFIX[la.vals.dtype]}")
        self.fn.argtypes, self.fn.restype = (_SINGLE if m is None else _COLS), _I
        ch = la.chunks
        self.args = (*[t.data_ptr() for t in la[:6]], ch.chunk_ptr.data_ptr(),
                     ch.level_chunk.data_ptr(), la.level_ptr.numel() - 1, la.col_idx.shape[1],
                     ch.stage_bytes, ch.n_stages)
        self.m, self.rows = m, la.n + 1

    def __call__(self, b, x):
        """b and x f[n + 1] or column-major f[m, n + 1]."""
        shape = () if self.m is None else (self.m, self.rows)
        err = self.fn(*self.args, *shape, b.data_ptr(), x.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"unordered walk: CUDA error {err}")
        return x


def _host_ms(fn, warmup=3, reps=20):
    """Median ms of ``fn()`` then a synchronize, on the host clock (the
    benchmark's ``solve_ms`` spelling)."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, required=True,
                    help="directory with the previous sptrsv.cu (sptrsv_elastic.cu) and headers")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("front_door_sweep: no CUDA device", file=sys.stderr)
        return 2
    out = args.out.open("w") if args.out else None
    t_start = time.perf_counter()

    def emit(rec):
        rec["t_s"] = round(time.perf_counter() - t_start, 1)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    dev = torch.device("cuda")
    work = build.BUILD_DIR.parent / "front_door_sweep"
    work.mkdir(parents=True, exist_ok=True)
    src = args.parent_src.resolve()
    # a parent with its own elastic library builds that too
    names = ["sptrsv"] + (["sptrsv_elastic"] if (src / "sptrsv_elastic.cu").exists() else [])
    jobs = [(name, src / f"{name}.cu", work) for name in names]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        shipped = pool.submit(build.load, "sptrsv")
        built = list(pool.map(nvcc_job, jobs))
        lib_new = shipped.result()
    parent = {}
    for name, rc, sec, so, log in built:
        emit({"build": f"parent_{name}", "rc": rc, "s": round(sec, 2)})
        if rc != 0:
            print(log[-3000:], file=sys.stderr)
            return 1
        parent[name] = ctypes.CDLL(str(so))

    t0 = time.perf_counter()
    cells = _cells()
    emit({"plans_s": round(time.perf_counter() - t0, 1)})
    failed = []
    for cell, (solver, ms) in cells.items():
        elastic = solver.info()["mode"] == "elastic"
        par = "sptrsv_elastic" if elastic and "sptrsv_elastic" in parent else "sptrsv"
        bound, n, dtype = solver.bound, solver.n, solver.dtype
        for m in ms:
            rng = np.random.default_rng(34)
            b = torch.as_tensor(rng.standard_normal(n if m is None else (n, m)), dtype=dtype,
                                device=dev)
            b_plan = pad_rhs(b[solver._perm])
            b_in = b_plan if m is None else b_plan.T.contiguous()
            x_par, x_new = torch.zeros_like(b_in), torch.zeros_like(b_in)
            unordered = {"kernel_parent": (_Unordered(parent[par], par, solver, m), x_par),
                         "kernel_unordered": (_Unordered(lib_new, "sptrsv", solver, m), x_new)}
            cols = 1 if m is None else m
            out_o = torch.empty_like(b)
            scratch = b.new_empty(2 * cols * (n + 1))
            walk = bound._walk
            kind = walk.single if m is None else walk.mrhs
            # the C entry alone (uncounted: the counter is the front door's)
            entry = sptrsv._entry(kind, dtype)
            grid = min(max(cols, sptrsv.ORDERED_SPREAD), sptrsv.ordered_columns(walk))
            ordered_args = (*walk.args, cols, grid, n, walk.perm, b.data_ptr(), out_o.data_ptr(),
                            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

            def ordered():
                if entry(*ordered_args):
                    raise RuntimeError("ordered walk: launch failed")

            calls = {name: (lambda f=f, x=x: f(b_in, x)) for name, (f, x) in unordered.items()}
            calls["kernel_ordered"] = ordered
            calls["solve_gather"] = lambda: bound.solve(b[solver._perm])[solver._inv]
            calls["solve_ordered"] = lambda: solver.solve(b)
            # the answers, before any timing
            for name in calls:
                calls[name]()
            torch.cuda.synchronize()
            x_gather = calls["solve_gather"]()
            checks = {
                "parent_vs_unordered": bits_equal(x_par, x_new),
                "ordered_vs_gather": bits_equal(out_o, x_gather),
                "solve_vs_gather": bits_equal(solver.solve(b), x_gather),
                "front_door": bound.describe()["front_door"] == "ordered",
            }
            sptrsv.reset_launches()
            timed = {name: [] for name in calls}
            for turn in ("parent", "change", "change", "parent"):
                names = list(calls) if turn == "parent" else list(calls)[::-1]
                for name in names:
                    if name.startswith("kernel"):
                        timed[name].append(median_ms(calls[name], reps=args.reps))
                    else:
                        timed[name].append(_host_ms(calls[name], reps=args.reps))
            # one ordered launch a front-door solve: 4 turns of 3 + reps
            checks["ordered_launches_equal_solves"] = (
                sptrsv.launches[kind] == 4 * (3 + args.reps))
            rec = {"cell": cell, "m": m, "dtype": str(dtype).replace("torch.", ""),
                   "mode": solver.info()["mode"], "levels": bound.describe()["n_levels"],
                   "staging": bound._la.chunks.stats(), "grid": grid, "checks": checks,
                   "launches": {k: v for k, v in sptrsv.launches.items() if v},
                   "ms": {name: statistics.median(v) for name, v in timed.items()},
                   "ms_turns": timed}
            k_par, k_ord = rec["ms"]["kernel_parent"], rec["ms"]["kernel_ordered"]
            rec["kernel_ordered_over_parent"] = k_ord / k_par
            emit(rec)
            if not all(checks.values()):
                failed.append((cell, m, checks))
    emit({"done": True, "failed": failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
