#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure ends the run with a non-zero exit:

  env        card name and power limit (nvidia-smi), torch, nvcc version
  build      compile every csrc/*.cu with nvcc for sm_90a, from the sources,
             one nvcc per source, all at once
  kernels    on ER and NB matrices of n=2,000, each kernel against its plain
             version run on the CPU, bitwise: the bulk SpTRSV kernels, both
             level walks of the bulk order (k in {8, 32}, width in {None,
             2}, single RHS and m in {5, 64, 300}, the latter a block per
             column; the largest ulp gap to the plain version run on the
             card is reported), the elastic kernels (the level walk over
             runs of slack supersteps; k in {8, 32}, slack in {1, 8},
             single RHS and m in {5, 64}; also bitwise-equal to the bulk
             plain version) and the SpMV kernel (ER, NB and a matrix with
             dense rows, width in {None, 2}, float32 and float64; also
             bitwise-equal to the padded-ELL product with the split rows
             summed in order, the definition it keeps)
  main_path  the paper's synthetic sets at n=100,000 (§6.2.4 ER p=1e-4,
             §6.2.5 NB p=0.14 B=10, seed 0; NB with a dominant diagonal, as
             its own values overflow float32): TriangularSolver.plan(L) with
             every default (cuda, growlocal, k=8, kernel backend), solve b
             f[n] and B f[n, 32], numeric_update, solve again, then
             factor_pair on IC(0) of a 128x128 Poisson grid; every answer
             bitwise-equal to the plain version on the CPU
  main_path_elastic   TriangularSolver.plan(L, mode="elastic") on the same
             matrices, the same b, B and numeric_update: every answer
             bitwise-equal to the bulk answers above; the barrier counts
             (supersteps, the elastic level order's levels, and the
             certificate's readiness waves the TPU kernel walks)
  main_path_spmv      spmv(L, x) on the same matrices, against scipy in f64
             and bitwise the CPU plain version; one launch a call
  pcg        pcg_ichol(A, b, k=8, tol=1e-6, maxiter=2000) on the 512x512
             Poisson grid (n=262,144; IC(0) factor of 785,408 entries),
             float32, kernel backend, b from --seed: recurrence relres
             < 1e-6, true residual (float64, host) < 1e-4, fewer iterations
             than plain CG on the card, launch counts exact (2(iters+1)
             single-RHS solves, iters SpMVs: one launch a matvec), a second
             request through the
             same PlanCache plans nothing; bwd(fwd(r)) and the matvec
             bitwise their CPU plain versions; at 64x64 the card's PCG
             against the CPU plain PCG (float64 iterations equal, float32
             within one, x within 1e-3). Reports the host seconds of IC(0)
             and of each plan, wall seconds, ms per iteration (CUDA events)
             beside its byte bound, fwd, bwd and matvec ms per launch (fwd
             and bwd also with L2 emptied before each launch), and
             a torch.profiler window of 20 iterations (device time by
             kernel, the device's idle share)
             Each main-path phase sets the launch counters to 0 just before
             it and reads them just after; its kernels must have launched.
  timing     CUDA events on the main-path plans: kernel (3 warm-ups, median
             of 20), plain version on the card (SpTRSV once, SpMV median of
             5), the library yardstick (torch.triangular_solve on a
             sparse-CSR L for SpTRSV, the sparse-CSR matvec for SpMV; never
             called by the port), and the byte/operation bound of the H100
             data sheet for the real entries (padding left out; the padded
             plan's byte bound and padding share are printed beside it).
             SpMV, on ER, NB and PCG's A: the whole product spmv() returns
             (EllOperator(A)(x)) eager, as the replay of a CUDA graph of one
             call and of 100 calls (per call), its device operations (the
             nodes of a CUDA graph that captures one call, read through the
             driver API), which must be one launch of the kernel, and its
             device time from torch.profiler over 200 eager calls (after
             200 traced and dropped), which must record no other operation;
             the same for L_csr @ x; the bound share and the layout's
             lane-idle share. The single-RHS
             line also reports the level order: its host seconds, levels
             (= block barriers), widest level, the supersteps and the DAG's
             longest path beside them; the m-RHS line adds its column
             blocks and the time of the column-major copy of b that its
             call makes; the elastic lines report the levels
             of the order over runs of slack supersteps and its slack

then the ``kernels`` summary line (the path launches include the pcg
phase's), the nvidia-smi line, and last ``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, outside the tensor cores
# kernel name -> (TPU kernel it replaces, CUDA source of its entry point,
# launch counter, the kernel's body: file and function)
_LEVEL_1, _LEVEL_M = "level.cuh::sptrsv_level_kernel", "level.cuh::sptrsv_level_cols_kernel"
KERNELS = {
    "sptrsv_single": ("src/repro/kernels/sptrsv.py:52", "sptrsv.cu", "single", _LEVEL_1),
    "sptrsv_mrhs": ("src/repro/kernels/sptrsv.py:98", "sptrsv.cu", "mrhs", _LEVEL_M),
    "sptrsv_elastic_single": (
        "src/repro/kernels/sptrsv.py:146", "sptrsv_elastic.cu", "elastic_single", _LEVEL_1),
    "sptrsv_elastic_mrhs": (
        "src/repro/kernels/sptrsv.py:232", "sptrsv_elastic.cu", "elastic_mrhs", _LEVEL_M),
    "spmv": ("src/repro/kernels/spmv.py:32", "spmv.cu", "spmv", "spmv.cu::spmv_sliced_kernel"),
}
KERNEL_REPLACES = {name: k[0] for name, k in KERNELS.items()}
MAIN_M = 32
# the pcg phase: poisson2d_matrix(512), (n, nnz(A), nnz(IC(0) factor))
PCG_GRID = 512
PCG_SIZES = (262_144, 1_308_672, 785_408)
PCG_TOL = 1e-6
PCG_MAXITER = 2000
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj["elapsed_s"] = round(time.perf_counter() - T_START, 1)
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def profile_iterations(run, n_iter=20) -> dict:
    """``run(n_iter)`` (that many CG iterations) under ``torch.profiler``:
    the device time of each kernel, summed by name, against the elapsed
    time of CUDA events around the run, whence the device's idle share.
    The profiler slows the host, so the profiled iteration is slower than
    an unprofiled one; a profiler that records no device time gives
    ``device_busy_ms`` 0 (then read only ``ms_per_iter``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(2)  # warm-up outside the window
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        run(n_iter)
        e1.record()
        e1.synchronize()
    elapsed = e0.elapsed_time(e1)
    kernels = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        kernels.append({"name": evt.key[:80], "count": evt.count, "ms": us / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    busy = sum(k["ms"] for k in kernels)
    return {"iters": n_iter, "elapsed_ms": elapsed, "ms_per_iter": elapsed / n_iter,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / elapsed,
            "kernels": len(kernels), "launches": sum(k["count"] for k in kernels),
            "top": kernels[:10]}


def pcg_phase(args, dev, cuda_times, bitwise_equal, max_abs, main_err, card) -> dict:
    """IC(0)-preconditioned CG at full width on the card (see the module
    docstring); returns the phase's record, which it has emitted."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import obs
    from repro_torch.kernels import spmv, sptrsv
    from repro_torch.kernels.ops import level_plan_arrays
    from repro_torch.solver import cg_solve, pcg_ichol
    from repro_torch.solver.cg import _csr_matvec_fn
    from repro_torch.solver.executor import pad_rhs
    from repro_torch.sparse import ichol0, poisson2d_matrix

    def sync():
        torch.cuda.synchronize()

    A = poisson2d_matrix(PCG_GRID)
    n = A.n_rows
    t0 = time.perf_counter()
    lf = ichol0(A)
    ichol_s = time.perf_counter() - t0
    require((n, A.nnz, lf.nnz) == PCG_SIZES, f"pcg system: {(n, A.nnz, lf.nnz)}")
    rng = np.random.default_rng(args.seed)
    b1, b2, r = (rng.standard_normal(n) for _ in range(3))
    kw = dict(k=8, tol=PCG_TOL, maxiter=PCG_MAXITER)  # float32, kernel backend, the card
    cache = repro_torch.PlanCache()

    def request(b):
        """One pcg_ichol request, traced, its launch counters set to 0 just
        before it and read just after; checks the counts are exact."""
        buf = obs.TraceBuffer("pcg")
        sptrsv.reset_launches()
        spmv.reset_launches()
        t0 = time.perf_counter()
        with obs.tracing(buf):
            x, iters, relres, info = pcg_ichol(A, b, cache=cache, **kw)
        sync()
        wall = time.perf_counter() - t0
        launches = {**sptrsv.launches, **spmv.launches}
        # z0 = M(b), then one M(r) per iteration: two solves each; one
        # matvec per iteration
        want = {"single": 2 * (iters + 1), "mrhs": 0, "elastic_single": 0,
                "elastic_mrhs": 0, "spmv": iters}
        require(launches == want, f"pcg launches {launches}, want {want}")
        require(x.device.type == dev.type and x.dtype == torch.float32 and x.shape == (n,)
                and bool(torch.isfinite(x).all()), "pcg output")
        require(relres < PCG_TOL, f"pcg relres {relres} after {iters} iterations")
        true = float(np.linalg.norm(b - A.to_scipy() @ x.double().cpu().numpy())
                     / np.linalg.norm(b))
        require(true < 1e-4, f"pcg true residual {true} (float64, host)")
        return x, iters, relres, info, buf, wall, launches, true

    x1, iters1, relres1, info1, buf1, wall1, launches, true1 = request(b1)
    require(info1["cache"]["misses"] == 2 and info1["cache"]["hits"] == 0, f"{info1['cache']}")
    plan_s = [(sp.t1_ns - sp.t0_ns) / 1e9 for sp in buf1.spans() if sp.name == "cache.build"]
    require(len(plan_s) == 2, "the first request plans fwd and bwd")
    # a second request with a new b: the cache hits twice and plans nothing
    _, iters2, relres2, info2, buf2, wall2, _, true2 = request(b2)
    require(info2["cache"]["misses"] == 2 and info2["cache"]["hits"] == 2, f"{info2['cache']}")
    require(not [sp.name for sp in buf2.spans()
                 if sp.name == "cache.build" or sp.name.startswith("inspector.")],
            "the second request planned")

    # plain CG on the card takes more iterations
    t0 = time.perf_counter()
    _, cg_iters, cg_relres = cg_solve(A, b1, tol=PCG_TOL, maxiter=5000)
    sync()
    cg_wall = time.perf_counter() - t0
    require(iters1 < cg_iters, f"pcg {iters1} iterations, plain cg {cg_iters}")

    # one preconditioner application, bitwise the CPU plain version's
    fwd, bwd = repro_torch.factor_pair(lf, k=8, cache=cache)  # the requests' pair
    t0 = time.perf_counter()
    fwd_c, bwd_c = repro_torch.factor_pair(lf, k=8, backend="scan", device="cpu")
    cpu_plan_s = time.perf_counter() - t0
    z = bwd(fwd(r))
    sync()
    z_c = bwd_c(fwd_c(r))
    require(bitwise_equal(z, z_c), "bwd(fwd(r)) != CPU plain version")
    main_err["sptrsv_single"] = max(main_err["sptrsv_single"], max_abs(z, z_c))
    # CG's matvec at this shape, against its plain version on the CPU
    op = _csr_matvec_fn(A, torch.float32, dev)
    xs = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    y = op(xs.to(dev))
    sync()
    y_c = _csr_matvec_fn(A, torch.float32, "cpu")(xs)
    require(bitwise_equal(y, y_c), "matvec != CPU plain version")
    main_err["spmv"] = max(main_err["spmv"], max_abs(y, y_c))

    # CG alone, CUDA events around it: ms per iteration
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    _, iters3, _ = cg_solve(A, b1, precond=lambda res: bwd(fwd(res)), tol=PCG_TOL,
                            maxiter=PCG_MAXITER)
    e1.record()
    e1.synchronize()
    cg_pass_wall = time.perf_counter() - t0
    ms_per_iter = e0.elapsed_time(e1) / iters3
    profiled = profile_iterations(lambda n_iter: cg_solve(
        A, b1, precond=lambda res: bwd(fwd(res)), tol=0.0, maxiter=n_iter))
    # the pieces of an iteration, timed alone at these shapes
    la_f = level_plan_arrays(fwd.exec_plan, device=dev)
    la_b = level_plan_arrays(bwd.exec_plan, device=dev)
    r_pad = pad_rhs(torch.as_tensor(r, dtype=torch.float32)).to(dev)
    xs = xs.to(dev)
    rt = torch.as_tensor(r, dtype=torch.float32, device=dev)

    def med(fn):
        return statistics.median(cuda_times(fn, 3, 20))

    fwd_ms = med(lambda: sptrsv.sptrsv_level_cuda(*la_f[:7], r_pad))
    bwd_ms = med(lambda: sptrsv.sptrsv_level_cuda(*la_b[:7], r_pad))
    # the same launches with L2 emptied before each (a write of twice its
    # 50 MB), as a solve inside CG may find it after the other factor,
    # A and the vectors have passed through
    flush = torch.empty(100 * 2**20 // 4, dtype=torch.float32, device=dev)

    def cold(fn, reps=20):
        out = []
        for _ in range(reps):
            flush.fill_(1.0)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    fwd_cold_ms = cold(lambda: sptrsv.sptrsv_level_cuda(*la_f[:7], r_pad))
    bwd_cold_ms = cold(lambda: sptrsv.sptrsv_level_cuda(*la_b[:7], r_pad))
    del flush
    spmv_ms = med(lambda: op(xs))  # the matvec: one launch of the SpMV kernel
    precond_ms = med(lambda: bwd(fwd(rt)))  # the front door: gathers included
    # per-iteration bound: L read twice (fwd, bwd), A once (value, column,
    # row pointers, 4 bytes each), and the CG vectors of a fused
    # iteration: p read, Ap written (matvec); x, p, r, Ap read, x, r
    # written (updates); r read, y written, y read, z written (the
    # solves); z, p read, p written: 15 vectors of n floats
    l_bytes = lf.nnz * 8 + (n + 1) * 4
    a_bytes = A.nnz * 8 + (n + 1) * 4
    vec_bytes = 15 * n * 4
    bound_us = (2 * l_bytes + a_bytes + vec_bytes) / HBM_BYTES_PER_S * 1e6

    # a small grid: the card's PCG against the CPU plain PCG
    small = []
    A_s = poisson2d_matrix(64)
    b_s = rng.standard_normal(A_s.n_rows)
    for dtype in (torch.float64, torch.float32):
        xg, ig, rg, _ = pcg_ichol(A_s, b_s, dtype=dtype, **kw)
        # the CPU plain PCG: the kernels' plain versions (bitwise the scan's)
        xc, ic, rc, _ = pcg_ichol(A_s, b_s, dtype=dtype, device="cpu", **kw)
        xg, xc = xg.cpu().double().numpy(), xc.double().numpy()
        # the dots reduce in another order on the card: float64 counts
        # equal, float32 within one
        same_iters = abs(ig - ic) <= (0 if dtype == torch.float64 else 1)
        close = bool(np.allclose(xg, xc, rtol=1e-3, atol=1e-3 * np.abs(xc).max()))
        small.append({"dtype": str(dtype).replace("torch.", ""), "iters": ig, "iters_cpu": ic,
                      "relres": rg, "relres_cpu": rc,
                      "max_rel_gap": float(np.abs(xg - xc).max() / np.abs(xc).max())})
        require(same_iters and close, f"pcg card vs CPU plain at 64x64: {small[-1]}")

    rec = {"phase": "pcg", "grid": PCG_GRID, "n": n, "nnz_A": A.nnz, "nnz_L": lf.nnz,
           "seed": args.seed, "dtype": "float32", "backend": "kernel", "k": 8,
           "tol": PCG_TOL, "ichol_s": ichol_s, "plan_s": {"fwd": plan_s[0], "bwd": plan_s[1]},
           "inspector_s": {"fwd": fwd.inspector_seconds, "bwd": bwd.inspector_seconds},
           "cpu_plain_pair_plan_s": cpu_plan_s,
           "iters": iters1, "relres": relres1, "true_relres_f64": true1,
           "pcg_wall_s": wall1, "second_request": {
               "iters": iters2, "relres": relres2, "true_relres_f64": true2,
               "pcg_wall_s": wall2, "cache": info2["cache"]},
           "cg_iters": cg_iters, "cg_relres": cg_relres, "cg_wall_s": cg_wall,
           "cg_pass": {"iters": iters3, "wall_s": cg_pass_wall},
           "ms_per_iter": ms_per_iter, "profile": profiled,
           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "spmv_ms": spmv_ms,
           "l2_flushed": {"fwd_ms": fwd_cold_ms, "bwd_ms": bwd_cold_ms},
           "precond_ms": precond_ms, "spmv_lane_idle_share": op.lane_idle_share,
           "rest_ms": ms_per_iter - fwd_ms - bwd_ms - spmv_ms,
           "levels": {"fwd": fwd.bound.describe()["n_levels"],
                      "bwd": bwd.bound.describe()["n_levels"]},
           "supersteps": {"fwd": fwd.n_supersteps, "bwd": bwd.n_supersteps},
           "bound_us_per_iter": bound_us, "bound_by": "bytes",
           "bound_bytes": {"L_twice": 2 * l_bytes, "A": a_bytes, "vectors": vec_bytes},
           "launches": launches, "bitwise_precond_vs_cpu_plain": True,
           "bitwise_matvec_vs_cpu_plain": True, "small_grid_vs_cpu_plain": small, **card}
    emit(rec)
    return rec


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--seed", type=int, default=0, help="seed of the pcg phase's right-hand sides")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch
    from repro_torch.core import elastic_transform
    from repro_torch.kernels import build, spmv, sptrsv
    from repro_torch.kernels.levels import level_order
    from repro_torch.kernels.ops import elastic_kernel_arrays, level_plan_arrays
    from repro_torch.kernels.ref import (
        spmv_ell_rows_ref,
        spmv_sliced_ref,
        sptrsv_level_ref,
        sptrsv_ref,
    )
    from repro_torch.solver.executor import pad_rhs, plan_arrays
    from repro_torch.sparse import (
        csr_from_coo,
        dag_from_lower_csr,
        erdos_renyi_lower,
        ichol0,
        narrow_band_lower,
        poisson2d_matrix,
    )
    from repro_torch.sparse.dag import longest_path_length

    dev = torch.device("cuda")

    # ------------------------------------------------------------ env
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0].strip()
    nvcc_line = [ln for ln in run([build.nvcc_path(), "--version"]).splitlines()
                 if "release" in ln][0].strip()
    card = {"nvidia_smi": smi}
    emit({"phase": "env", **card, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_line})

    # ---------------------------------------------------------- build
    sources = sorted(build.CSRC.glob("*.cu"))
    require({s.name for s in sources} >= {k[1] for k in KERNELS.values()},
            f"missing kernel sources in {build.CSRC}")
    for src in sources:
        build.library_path(src).unlink(missing_ok=True)  # build from the sources

    def timed_build(src):
        t0 = time.perf_counter()
        _, log = build.build(src)
        return time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        built = list(pool.map(timed_build, sources))
    build_s = time.perf_counter() - t0
    for src in sources:
        build.load(src.stem)
    emit({"phase": "build", "flags": " ".join(build.NVCC_FLAGS),
          "seconds": round(build_s, 3),
          "sources": [{"source": str(src.relative_to(ROOT)), "seconds": round(sec, 3),
                       "ptxas": [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                                 if "registers" in ln]}
                      for src, (sec, log) in zip(sources, built)]})

    def bits(t):
        t = t.detach().cpu().contiguous()
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64).long()

    def bitwise_equal(a, b) -> bool:
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

    def ulp_gap(a, b) -> int:
        ia, ib = bits(a), bits(b)
        sign = 1 << (31 if a.dtype == torch.float32 else 63)
        mono = lambda i: torch.where(i < 0, -(i & (sign - 1)), i)  # noqa: E731
        return int((mono(ia) - mono(ib)).abs().max()) if ia.numel() else 0

    def max_abs(a, b) -> float:
        d = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
        return float(d.max()) if d.numel() else 0.0

    def cuda_times(fn, warmup, reps):
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return out

    # -------------------------------------------------------- kernels
    small = {"er": erdos_renyi_lower(2000, 5e-3, seed=0),
             "nb": narrow_band_lower(2000, 0.14, 10, seed=0)}
    sptrsv.reset_launches()
    cells = []
    for gen_name, L in small.items():
        for k in (8, 32):
            for width in (None, 2):
                plan = repro_torch.TriangularSolver.plan(
                    L, k=k, width=width, device="cpu").exec_plan
                pa_cpu = plan_arrays(plan, device="cpu")
                la_gpu = level_plan_arrays(plan, device=dev)
                rng = np.random.default_rng(k)
                for m in (None, 5, 64, 300):
                    b = torch.as_tensor(rng.standard_normal(
                        2000 if m is None else (2000, m)), dtype=torch.float32)
                    b_pad = pad_rhs(b)
                    x_cpu = sptrsv_ref(*pa_cpu[:5], b_pad)
                    # one block for b f[n+1], a block per column for f[n+1, m]
                    x_gpu = sptrsv.sptrsv_level_cuda(*la_gpu[:7], b_pad.to(dev))
                    x_plain_gpu = sptrsv_level_ref(*la_gpu[:7], b_pad.to(dev))
                    torch.cuda.synchronize()
                    same = bitwise_equal(x_gpu, x_cpu)
                    cells.append({"matrix": gen_name, "k": k, "W": plan.W,
                                  "T": plan.n_steps, "m": m, "bitwise": same,
                                  "levels": int(la_gpu.level_ptr.numel() - 1),
                                  "ulp_vs_plain_on_card": ulp_gap(x_gpu, x_plain_gpu)})
                    require(same, f"kernel != CPU plain version at {cells[-1]}")
    emit({"phase": "kernels", "names": ["sptrsv_single", "sptrsv_mrhs"],
          "launches": dict(sptrsv.launches), "cells": len(cells),
          "all_bitwise_vs_cpu_plain": all(c["bitwise"] for c in cells),
          "max_ulp_vs_plain_on_card": max(c["ulp_vs_plain_on_card"] for c in cells),
          "detail": cells})

    sptrsv.reset_launches()
    cells = []
    for gen_name, L in small.items():
        for k in (8, 32):
            plan = repro_torch.TriangularSolver.plan(L, k=k, device="cpu").exec_plan
            pa_cpu = plan_arrays(plan, device="cpu")
            for slack in (1, 8):
                plan_e = dataclasses.replace(plan, elastic=elastic_transform(plan, slack))
                la_cpu = elastic_kernel_arrays(plan_e, device="cpu")
                la_gpu = elastic_kernel_arrays(plan_e, device=dev)
                rng = np.random.default_rng(k + slack)
                for m in (None, 5, 64):
                    b_pad = pad_rhs(torch.as_tensor(rng.standard_normal(
                        2000 if m is None else (2000, m)), dtype=torch.float32))
                    x_cpu = sptrsv_level_ref(*la_cpu[:7], b_pad)
                    x_bulk = sptrsv_ref(*pa_cpu[:5], b_pad)
                    x_gpu = sptrsv.sptrsv_elastic_cuda(*la_gpu[:7], b_pad.to(dev))
                    torch.cuda.synchronize()
                    same = bitwise_equal(x_gpu, x_cpu)
                    cells.append({"matrix": gen_name, "k": k, "slack": slack, "W": plan.W,
                                  "T": plan.n_steps, "supersteps": plan.n_supersteps,
                                  "levels": int(la_gpu.level_ptr.numel() - 1),
                                  "waves": int(plan_e.elastic.n_waves.sum()),
                                  "m": m, "bitwise": same,
                                  "bitwise_vs_bulk": bitwise_equal(x_gpu, x_bulk)})
                    require(same and cells[-1]["bitwise_vs_bulk"],
                            f"elastic kernel != CPU plain versions at {cells[-1]}")
    emit({"phase": "kernels", "names": ["sptrsv_elastic_single", "sptrsv_elastic_mrhs"],
          "launches": {key: sptrsv.launches[key] for key in ("elastic_single", "elastic_mrhs")},
          "cells": len(cells), "all_bitwise_vs_cpu_plain": True,
          "all_bitwise_vs_bulk_plain": True, "detail": cells})

    spmv.reset_launches()
    cells = []
    er = small["er"]  # with three dense rows, which split into many pieces
    dense = [np.full(i, i) for i in (500, 1000, 1999)]
    arrow = csr_from_coo(
        2000, 2000, np.concatenate([er.row_of_entry(), *dense]),
        np.concatenate([er.indices, *[np.arange(i) for i in (500, 1000, 1999)]]),
        np.random.default_rng(8).uniform(-1, 1, er.nnz + 3499))
    for gen_name, L in {**small, "arrow": arrow}.items():
        for width in (None, 2):
            for dtype in (torch.float32, torch.float64):
                np_dtype = np.float32 if dtype == torch.float32 else np.float64
                lay = spmv.sliced_from_csr(L, width=width, dtype=np_dtype)
                host = [torch.from_numpy(a) for a in lay[:4]]
                x = torch.as_tensor(np.random.default_rng(3).standard_normal(L.n_cols),
                                    dtype=dtype)
                y_gpu = spmv.spmv_sliced_cuda(*(t.to(dev) for t in host), lay.width, x.to(dev))
                torch.cuda.synchronize()
                y_cpu = spmv_sliced_ref(*host, lay.width, x)
                col_idx, vals, row_map = spmv.ell_from_csr(L, width=width, dtype=np_dtype)
                y_def = spmv_ell_rows_ref(torch.from_numpy(col_idx), torch.from_numpy(vals),
                                          torch.from_numpy(row_map), x)
                cells.append({"matrix": gen_name, "dtype": str(dtype).replace("torch.", ""),
                              "W": lay.width, "pieces": int(col_idx.shape[0]),
                              "split_rows": int((lay.row_len > lay.width).sum()),
                              "lane_idle_share": lay.lane_idle_share(),
                              "bitwise": bitwise_equal(y_gpu, y_cpu),
                              "bitwise_vs_ell_definition": bitwise_equal(y_gpu, y_def)})
                require(cells[-1]["bitwise"] and cells[-1]["bitwise_vs_ell_definition"],
                        f"spmv kernel != CPU plain version at {cells[-1]}")
    require(spmv.launches["spmv"] == len(cells), f"spmv launches {spmv.launches}")
    emit({"phase": "kernels", "names": ["spmv"], "launches": dict(spmv.launches),
          "cells": len(cells), "all_bitwise_vs_cpu_plain": True,
          "all_bitwise_vs_ell_definition": True, "detail": cells})

    # ------------------------------------------------------ main_path
    import scipy.sparse.linalg as spla

    def dominant(L, data):
        """``data`` with each diagonal entry set to +-(1 + the sum of its
        row's |off-diagonals|): the solve's |x| is then bounded by
        max|b| however deep the DAG."""
        rows = L.row_of_entry()
        on_diag = L.indices == rows
        off = np.bincount(rows, weights=np.where(on_diag, 0.0, np.abs(data)),
                          minlength=L.n_rows)
        out = np.array(data, dtype=np.float64)
        out[on_diag] = np.where(data[on_diag] < 0, -1.0, 1.0) * (1.0 + off[rows[on_diag]])
        return out

    mats = {}
    t0 = time.perf_counter()
    mats["er"] = erdos_renyi_lower(100_000, 1e-4, seed=0)
    nb = narrow_band_lower(100_000, 0.14, 10, seed=0)
    # the paper's NB values make |x| grow past float32 along the 10^4-step
    # deep chains (inf, then NaN); keep its pattern, make it dominant
    mats["nb"] = dataclasses.replace(nb, data=dominant(nb, nb.data))
    lf = ichol0(poisson2d_matrix(128))
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(2025)
    main_err = {"sptrsv_single": 0.0, "sptrsv_mrhs": 0.0}
    solvers, rows, inputs, answers = {}, [], {}, {}
    sptrsv.reset_launches()  # the main path's launches start here
    spmv.reset_launches()
    for name, L in mats.items():
        n = L.n_rows
        t0 = time.perf_counter()
        gpu = repro_torch.TriangularSolver.plan(L)  # every default
        plan_s = time.perf_counter() - t0
        require(gpu.device.type == "cuda" and gpu.backend == "kernel", "defaults")
        cpu = repro_torch.TriangularSolver.plan(L, device="cpu", backend="scan")
        b = rng.standard_normal(n)
        B = rng.standard_normal((n, MAIN_M))
        new_data = dominant(L, L.data * rng.uniform(0.5, 1.5, L.nnz))
        inputs[name] = (b, B, new_data)
        row = {"matrix": name, "n": n, "nnz": L.nnz, "plan_s": round(plan_s, 3),
               **{key: gpu.info()["plan"][key] for key in ("n_steps", "n_supersteps", "W", "k")},
               "n_levels": gpu.bound.describe()["n_levels"]}
        for stage in ("initial", "numeric_update"):
            if stage == "numeric_update":
                gpu.numeric_update(new_data)
                cpu.numeric_update(new_data)
            for kname, rhs in (("sptrsv_single", b), ("sptrsv_mrhs", B)):
                x = gpu.solve(rhs)
                torch.cuda.synchronize()
                x_ref = cpu.solve(rhs)
                require(x.device.type == "cuda" and x.shape == x_ref.shape, "shape")
                require(bool(torch.isfinite(x).all()), f"{name} {stage}: non-finite x")
                require(bitwise_equal(x, x_ref),
                        f"{name} {stage} {kname}: kernel != CPU plain version")
                main_err[kname] = max(main_err[kname], max_abs(x, x_ref))
                answers[(name, stage, kname)] = x
            if stage == "initial":
                A = L.to_scipy().tocsr()
                x64 = spla.spsolve_triangular(A, b, lower=True)
                x = gpu.solve(b).double().cpu().numpy()
                row["relerr_vs_scipy_f64"] = float(
                    np.linalg.norm(x - x64) / np.linalg.norm(x64))
        rows.append(row)
        solvers[name] = gpu
    fwd, bwd = repro_torch.factor_pair(lf)
    fwd_c, bwd_c = repro_torch.factor_pair(lf, device="cpu", backend="scan")
    r = rng.standard_normal(lf.n_rows)
    z = bwd.solve(fwd.solve(r))
    torch.cuda.synchronize()
    require(bitwise_equal(z, bwd_c.solve(fwd_c.solve(r))), "factor_pair != CPU plain")
    A = lf.to_scipy().tocsr()
    zz = z.double().cpu().numpy()
    pcg_relres = float(np.linalg.norm(A @ (A.T @ zz) - r) / np.linalg.norm(r))
    main_launches = dict(sptrsv.launches)
    for kname in ("sptrsv_single", "sptrsv_mrhs"):
        require(main_launches[KERNELS[kname][2]] > 0,
                f"{kname} was not launched on the main path")
    # why NB carries a dominant diagonal: its own values, same plan
    x_paper = solvers["nb"].clone_with_values(nb.data).solve(rng.standard_normal(nb.n_rows))
    nb_paper_finite = bool(torch.isfinite(x_paper).all())
    emit({"phase": "main_path", "matrices": rows, "generate_s": round(gen_s, 3),
          "factor_pair": {"n": lf.n_rows, "nnz": lf.nnz,
                          "steps": [fwd.exec_plan.n_steps, bwd.exec_plan.n_steps],
                          "bitwise_vs_cpu_plain": True,
                          "relres_LLt_f64": pcg_relres},
          "launches": main_launches, "bitwise_vs_cpu_plain": True,
          "nb_with_paper_values_finite": nb_paper_finite,
          "max_abs_err": main_err, **card})

    # --------------------------------------------- main_path_elastic
    sptrsv.reset_launches()  # the elastic path's launches start here
    elastic_solvers, rows = {}, []
    for name, L in mats.items():
        b, B, new_data = inputs[name]
        t0 = time.perf_counter()
        el = repro_torch.TriangularSolver.plan(L, mode="elastic")
        plan_s = time.perf_counter() - t0
        require(el.device.type == "cuda" and el.bound.backend == "kernel"
                and el.info()["mode"] == "elastic", "elastic defaults")
        for stage in ("initial", "numeric_update"):
            if stage == "numeric_update":
                el.numeric_update(new_data)
            for kname, rhs in (("sptrsv_elastic_single", b), ("sptrsv_elastic_mrhs", B)):
                x = el.solve(rhs)
                torch.cuda.synchronize()
                # the bulk answer, itself bitwise-equal to the CPU plain version
                x_bulk = answers[(name, stage, kname.replace("elastic_", ""))]
                require(bitwise_equal(x, x_bulk),
                        f"{name} {stage} {kname}: elastic kernel != bulk answer")
                main_err[kname] = max(main_err.get(kname, 0.0), max_abs(x, x_bulk))
        ep = el.exec_plan.elastic
        # one block barrier per level of the order over runs of slack
        # supersteps; the certificate's waves are what the TPU kernel walks
        rows.append({"matrix": name, "plan_s": round(plan_s, 3), "slack": ep.slack,
                     "n_steps": ep.n_steps, "n_supersteps": ep.n_supersteps,
                     # both bulk kernels walk the bulk level order
                     "barriers_bulk": solvers[name].bound.describe()["n_levels"],
                     "barriers_elastic": el.bound.describe()["n_levels"],
                     "waves_certificate": int(ep.n_waves.sum()),
                     "mean_waves_per_tile": float(ep.n_waves.mean())})
        elastic_solvers[name] = el
    elastic_launches = dict(sptrsv.launches)
    for kname in ("sptrsv_elastic_single", "sptrsv_elastic_mrhs"):
        require(elastic_launches[KERNELS[kname][2]] > 0,
                f"{kname} was not launched on the elastic path")
    require(elastic_launches["single"] == elastic_launches["mrhs"] == 0,
            "the elastic path launched a bulk kernel")
    emit({"phase": "main_path_elastic", "matrices": rows, "launches": elastic_launches,
          "bitwise_vs_bulk": True, "max_abs_err": {
              k: main_err[k] for k in ("sptrsv_elastic_single", "sptrsv_elastic_mrhs")},
          **card})

    # ------------------------------------------------ main_path_spmv
    spmv.reset_launches()  # the SpMV path's launches start here
    rows = []
    spmv_x = {}
    for name, L in mats.items():
        x = rng.standard_normal(L.n_cols)
        spmv_x[name] = x
        y = spmv.spmv(L, x)  # float32 on the card
        torch.cuda.synchronize()
        y_cpu = spmv.spmv(L, x, device="cpu")
        y64 = L.to_scipy() @ x
        yy = y.double().cpu().numpy()
        rel = float(np.linalg.norm(yy - y64) / np.linalg.norm(y64))
        require(y.device.type == "cuda" and y.shape == (L.n_rows,)
                and bool(torch.isfinite(y).all()), f"{name}: spmv output")
        require(bitwise_equal(y, y_cpu), f"{name}: spmv != CPU plain version")
        require(rel <= 1e-5, f"{name}: spmv relative error {rel} vs scipy f64")
        main_err["spmv"] = max(main_err.get("spmv", 0.0), max_abs(y, y_cpu))
        rows.append({"matrix": name, "n": L.n_rows, "nnz": L.nnz,
                     "relerr_vs_scipy_f64": rel,
                     "max_abs_vs_scipy_f64": float(np.abs(yy - y64).max())})
    spmv_launches = dict(spmv.launches)
    require(spmv_launches["spmv"] == len(mats), f"spmv launches {spmv_launches}: one a call")
    emit({"phase": "main_path_spmv", "matrices": rows, "launches": spmv_launches,
          "bitwise_vs_cpu_plain": True, "max_abs_err": main_err["spmv"], **card})
    path_launches = {**main_launches, **{k: elastic_launches[k] for k in (
        "elastic_single", "elastic_mrhs")}, **spmv_launches}

    # ------------------------------------------------------------ pcg
    pcg = pcg_phase(args, dev, cuda_times, bitwise_equal, max_abs, main_err, card)
    # the kernels' path launches add this path's
    path_launches["single"] += pcg["launches"]["single"]
    path_launches["spmv"] += pcg["launches"]["spmv"]

    # --------------------------------------------------------- timing
    def graph_ms(fn, reps):
        """Median ms of replaying a CUDA graph that holds ``fn``'s launches:
        the device's time without the host's launch path (wrapper checks,
        ctypes), which an eager call of a short kernel is bound by;
        (None, error text) where capture is refused."""
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return statistics.median(cuda_times(g.replay, 3, reps)), None
        except RuntimeError as e:
            return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    def library_ms(L, values, rhs, x_port):
        """Median ms of torch.triangular_solve on L's pattern with
        ``values`` as sparse CSR, and the relative gap of its answer to the
        port's ``solve(rhs)`` on the same values (it must solve the same
        system); (None, None, error text) where it is refused."""
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                Lc = torch.sparse_csr_tensor(
                    torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                    torch.as_tensor(values, dtype=torch.float32),
                    size=(L.n_rows, L.n_cols),
                ).to(dev)
                Bd = rhs.reshape(L.n_rows, -1).contiguous()
                ts = cuda_times(lambda: torch.triangular_solve(Bd, Lc, upper=False), 1, 5)
                x_lib = torch.triangular_solve(Bd, Lc, upper=False)[0]
            ref = x_port.reshape(x_lib.shape).double()
            gap = float((x_lib.double() - ref).norm() / ref.norm())
            return statistics.median(ts), gap, None
        except (RuntimeError, NotImplementedError, TypeError) as e:
            return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    def plan_work(plan, esize):
        """What this run's data needs of a solve, padding left out: the
        plan's real entries (index and value), real lane steps (row,
        diagonal, accum flag) and finishing rows."""
        real = plan.row_ids < plan.n
        entries = int((plan.val_src >= 0).sum())
        lane_steps = int(real.sum())
        return {"entries": entries, "finishes": int((real & ~plan.accum).sum()),
                "bytes": entries * (4 + esize) + lane_steps * (4 + esize + 1),
                "padding_share": 1.0 - entries / plan.col_idx.size}

    def bound(nbytes, ops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS * 1e3
        return {"bound_us": max(bytes_ms, ops_ms) * 1e3,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "ops": ops}

    def rhs_pad(n, m):
        shape = (n + 1,) if m is None else (n + 1, m)
        return torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(dev)

    timing = {}
    for name, gpu in solvers.items():
        plan = gpu.exec_plan
        t0 = time.perf_counter()
        order = level_order(plan)
        level_s = time.perf_counter() - t0
        la = level_plan_arrays(plan, device=dev, order=order)
        esize = la.vals.element_size()
        work = plan_work(plan, esize)
        stats = order.stats()
        for kname, m in (("sptrsv_single", None), ("sptrsv_mrhs", MAIN_M)):
            b_pad = rhs_pad(gpu.n, m)
            # both walk the bulk level order: one block for b f[n+1], a
            # block per column of a column-major copy (timed with it) for
            # f[n+1, m]
            ms = statistics.median(cuda_times(lambda: sptrsv.sptrsv_level_cuda(*la[:7], b_pad),
                                              3, 20))
            x = sptrsv.sptrsv_level_cuda(*la[:7], b_pad)
            # the plain version once: it launches tens of operations per level
            x_plain = []
            plain = cuda_times(lambda: x_plain.append(sptrsv_level_ref(*la[:7], b_pad)), 0, 1)
            require(bitwise_equal(x, x_plain[0]), f"{name} {kname}: timed kernel != plain")
            # the library solves L itself (caller row order), so it is
            # checked against the front door's answer, not the plan's
            rhs = b_pad[:-1].contiguous()
            lib, lib_gap, lib_err = library_ms(
                mats[name], gpu.source_values, rhs, gpu.solve(rhs))
            cols = 1 if m is None else m
            # the bound is the solve's data alone, the same for every layout:
            # the plan's real work, b read and x written
            rhs_bytes = 2 * gpu.n * cols * esize
            # the kernel's arrays as it reads them, padding slots included
            plan_total = (sum(t.numel() * t.element_size() for t in la[:7])
                          + 2 * b_pad.numel() * b_pad.element_size())
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1,
                   **bound(work["bytes"] + rhs_bytes,
                           2 * (work["entries"] + work["finishes"]) * cols),
                   "entries": work["entries"], "padding_share": work["padding_share"],
                   "bound_padded_plan_us": plan_total / HBM_BYTES_PER_S * 1e6,
                   "padded_plan_bytes": plan_total,
                   # one block barrier per level (per column block for m RHS)
                   "barriers": order.n_levels, "levels": order.n_levels,
                   "level_width_max": stats["level_width_max"],
                   "supersteps": plan.n_supersteps, "level_order_s": level_s,
                   "plain_ms": statistics.median(plain),
                   "plain_reps": len(plain), "library_ms": lib,
                   "library": "torch.triangular_solve(B, L_csr, upper=False)",
                   "library_rel_gap_to_port": lib_gap,
                   "library_error": lib_err, **card}
            if m is None:
                rec.update(stats, dag_longest_path=longest_path_length(
                    dag_from_lower_csr(mats[name])))
            else:  # the wrapper's column-major copy of b, part of ms
                copy_in = cuda_times(lambda: b_pad.T.contiguous(), 3, 20)
                rec.update(blocks=cols, copy_in_ms=statistics.median(copy_in))
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    for name, el in elastic_solvers.items():
        plan = el.exec_plan
        ep = plan.elastic
        t0 = time.perf_counter()
        order = level_order(plan, slack=ep.slack)
        level_s = time.perf_counter() - t0
        la = level_plan_arrays(plan, device=dev, order=order)
        esize = la.vals.element_size()
        work = plan_work(plan, esize)
        for kname, m in (("sptrsv_elastic_single", None), ("sptrsv_elastic_mrhs", MAIN_M)):
            b_pad = rhs_pad(el.n, m)  # the bulk timing's right-hand side
            ms = statistics.median(cuda_times(
                lambda: sptrsv.sptrsv_elastic_cuda(*la[:7], b_pad), 3, 20))
            x = sptrsv.sptrsv_elastic_cuda(*la[:7], b_pad)
            # the plain version once: it launches tens of operations per level
            x_plain = []
            plain = cuda_times(lambda: x_plain.append(sptrsv_level_ref(*la[:7], b_pad)), 0, 1)
            require(bitwise_equal(x, x_plain[0]), f"{name} {kname}: timed kernel != plain")
            cols = 1 if m is None else m
            bulk = timing[(name, kname.replace("elastic_", ""))]
            stats = order.stats()
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1,
                   # the solve's data alone, as for the bulk lines
                   **bound(work["bytes"] + 2 * el.n * cols * esize,
                           2 * (work["entries"] + work["finishes"]) * cols),
                   "entries": work["entries"], "slack": ep.slack,
                   # one block barrier per level (per column block for m RHS)
                   "levels": order.n_levels, "barriers": order.n_levels,
                   "level_width_max": stats["level_width_max"],
                   "levels_per_run": stats["levels_per_run"], "level_order_s": level_s,
                   "supersteps": ep.n_supersteps, "waves_certificate": int(ep.n_waves.sum()),
                   "barriers_bulk": bulk["barriers"],
                   "bulk_ms": bulk["ms"], "ms_over_bulk": ms / bulk["ms"],
                   "plain_ms": statistics.median(plain), "plain_reps": len(plain),
                   # the same system and right-hand side as the bulk record
                   "library_ms": bulk["library_ms"], "library": bulk["library"],
                   "library_error": bulk["library_error"], **card}
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    def graph_nodes(fn):
        """The device operations of one call of ``fn``, exactly: the nodes
        of a CUDA graph that captures the call, as (node type, kernel name)
        read through the driver API (a kernel's name is mangled)."""
        import ctypes

        cu = ctypes.CDLL("libcuda.so.1")

        def check(rc, what):
            require(rc == 0, f"{what} returned CUDA driver error {rc}")

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            fn()
        handle = ctypes.c_void_p(g.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * count.value)()
        check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
        # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, 3 host, ...
        kinds = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host"}
        out = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            name = None
            if kind.value == 0:
                # CUDA_KERNEL_NODE_PARAMS_v2 starts with the CUfunction
                params = (ctypes.c_byte * 256)()
                check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
                      "cuGraphKernelNodeGetParams_v2")
                func = ctypes.c_void_p.from_buffer(params, 0)
                cname = ctypes.c_char_p()
                check(cu.cuFuncGetName(ctypes.byref(cname), func), "cuFuncGetName")
                name = cname.value.decode()
            out.append((kinds.get(kind.value, str(kind.value)), name))
        del g
        return out

    def profiled_calls(fn, reps=200):
        """``reps`` eager calls of ``fn`` under torch.profiler: the device
        operations it records, by name, with their count and mean time, and
        the device time of a call (the means summed); ``device_ms`` None
        where it records no device time. The profiler may drop device
        events (on the H100 it has recorded 197 and 198 of 200 launches
        of one kernel), so a count here is a lower bound and only the means
        are read; ``graph_nodes`` counts a call's operations exactly."""
        from torch.profiler import ProfilerActivity, profile, schedule

        # a warm-up step, traced and dropped, then the window
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ops = {}
        for evt in prof.key_averages():
            # the step's own range ("ProfilerStep#1") is an annotation the
            # profiler mirrors on the device timeline, not an operation
            if str(evt.device_type).endswith("CUDA") and not evt.key.startswith("ProfilerStep"):
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = getattr(evt, "self_cuda_time_total", 0.0)
                ops[evt.key[:80]] = {"count": evt.count, "ms": us / 1e3,
                                     "mean_ms": us / 1e3 / evt.count}
        return {"reps": reps, "ops": ops,
                "events_recorded": sum(o["count"] for o in ops.values()),
                "device_ms": sum(o["mean_ms"] for o in ops.values()) if ops else None}

    def graph_calls_ms(fn, calls=100):
        """Per call: a CUDA graph of ``calls`` calls replayed, the device's
        time for back-to-back calls without the host's launch path."""
        ms, err = graph_ms(lambda: [fn() for _ in range(calls)], 20)
        return (ms / calls if ms is not None else None), err

    spmv_mats = {**mats, "pcg_A": poisson2d_matrix(PCG_GRID)}
    for name, L in spmv_mats.items():
        op = spmv.EllOperator(L)  # float32 on the card: what spmv() binds
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(L.n_cols),
                            dtype=torch.float32, device=dev)
        ms = statistics.median(cuda_times(lambda: op(x), 3, 20))
        op_graph_ms, op_graph_err = graph_ms(lambda: op(x), 20)
        op_graph100_ms, _ = graph_calls_ms(lambda: op(x))
        # the whole product is one device operation a call: the kernel
        nodes = graph_nodes(lambda: op(x))
        require(len(nodes) == 1 and nodes[0][0] == "kernel"
                and "spmv_sliced_kernel" in nodes[0][1],
                f"{name}: a spmv call is not one launch of the kernel: {nodes}")
        prof = profiled_calls(lambda: op(x))
        # the profiler may miss events but never invents them: every device
        # operation it saw is the kernel, at most one a call
        require(not prof["ops"] or (prof["events_recorded"] <= prof["reps"] and all(
            "spmv_sliced_kernel" in k for k in prof["ops"])),
            f"{name}: the spmv calls ran other device operations: {prof['ops']}")
        plain = cuda_times(lambda: spmv_sliced_ref(*op.layout[:5], x), 1, 5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Lc = torch.sparse_csr_tensor(
                torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                torch.as_tensor(L.data, dtype=torch.float32), size=(L.n_rows, L.n_cols),
            ).to(dev)
            lib = cuda_times(lambda: Lc @ x, 1, 5)
            lib_graph_ms, lib_graph_err = graph_ms(lambda: Lc @ x, 20)
            lib_graph100_ms, _ = graph_calls_ms(lambda: Lc @ x)
            lib_prof = profiled_calls(lambda: Lc @ x)
            try:
                lib_ops = len(graph_nodes(lambda: Lc @ x))
            except RuntimeError:  # capture refused, as graph_ms records
                lib_ops = None
            y_lib = (Lc @ x).double().cpu().numpy()
        y64 = L.to_scipy() @ x.double().cpu().numpy()
        lay = op.layout
        # the function's data: each real entry's column and value, row_len
        # and slice_ptr read once, x read once, y written once (the stored
        # padding is never read)
        esize = 4
        nbytes = (L.nnz * (4 + esize) + lay.row_len.numel() * 4 + lay.slice_ptr.numel() * 8
                  + (L.n_cols + L.n_rows) * esize)
        work = bound(nbytes, 2 * L.nnz)
        device_ms = prof["device_ms"] if prof["device_ms"] is not None else op_graph100_ms
        rec = {"matrix": name, "kernel": "spmv", "n": L.n_rows, "nnz": L.nnz, "W": lay.width,
               "slots": int(lay.col.numel()), "lane_idle_share": op.lane_idle_share,
               "split_rows": int((lay.row_len > lay.width).sum()),
               "ms": ms, "graph_ms": op_graph_ms, "graph_error": op_graph_err,
               "graph100_ms_per_call": op_graph100_ms, "device_ms": device_ms,
               "device_ms_from": "profiler" if prof["device_ms"] is not None else "graph100",
               "profile": prof, "launches_per_call": len(nodes), **work,
               "bound_share": work["bound_us"] / 1e3 / device_ms if device_ms else None,
               "plain_ms": statistics.median(plain), "plain_reps": len(plain),
               "library_ms": statistics.median(lib), "library": "L_csr @ x",
               "library_graph_ms": lib_graph_ms, "library_graph_error": lib_graph_err,
               "library_graph100_ms_per_call": lib_graph100_ms,
               "library_device_ms": lib_prof["device_ms"],
               "library_ops_per_call": lib_ops,
               "library_relerr_vs_scipy_f64": float(
                   np.linalg.norm(y_lib - y64) / np.linalg.norm(y64)), **card}
        timing[(name, "spmv")] = rec
        emit({"phase": "timing", **rec})

    summary = []
    for kname, (replaces, source, counter, body) in KERNELS.items():
        rec = timing[("er", kname)]
        summary.append({
            "name": kname, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "body": f"src/repro_torch/csrc/{body}",
            "replaces": replaces, "launches": path_launches[counter],
            "max_abs_err": main_err[kname], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_us"] / 1e3, "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
