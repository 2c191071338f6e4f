#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:

  env        card name and power limit (nvidia-smi), torch, nvcc version
  build      compile every csrc/*.cu with nvcc for sm_90a, from the sources,
             one nvcc per source, all at once
  kernels    on ER and NB matrices of n=2,000, each kernel against its plain
             version run on the CPU, bitwise: the bulk SpTRSV kernels (k in
             {8, 32}, width in {None, 2}, single RHS and m in {5, 64, 300};
             the largest ulp gap to the plain version run on the card is
             reported), the elastic kernels (k in {8, 32}, slack in {1, 8},
             single RHS and m in {5, 64}; also bitwise-equal to the bulk
             plain version) and the SpMV kernel (width in {None, 2})
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
             (supersteps against readiness waves)
  main_path_spmv      spmv(L, x) on the same matrices, against scipy in f64
             Each main-path phase sets the launch counters to 0 just before
             it and reads them just after; its kernels must have launched.
  timing     CUDA events on the main-path plans: kernel (3 warm-ups, median
             of 20; for SpMV also the replay of a CUDA graph of the call,
             its device time without the host's launch path), plain version
             on the card (the elastic one once), the
             library yardstick (torch.triangular_solve on a sparse-CSR L for
             SpTRSV, the sparse-CSR matvec for SpMV; never called by the
             port), and the byte/operation bound of the H100 data sheet for
             the real entries (padding left out; the padded plan's byte
             bound and padding share are printed beside it)

then the ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
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
# kernel name -> (TPU kernel it replaces, CUDA source, launch counter)
KERNELS = {
    "sptrsv_single": ("src/repro/kernels/sptrsv.py:52", "sptrsv.cu", "single"),
    "sptrsv_mrhs": ("src/repro/kernels/sptrsv.py:98", "sptrsv.cu", "mrhs"),
    "sptrsv_elastic_single": (
        "src/repro/kernels/sptrsv.py:146", "sptrsv_elastic.cu", "elastic_single"),
    "sptrsv_elastic_mrhs": (
        "src/repro/kernels/sptrsv.py:232", "sptrsv_elastic.cu", "elastic_mrhs"),
    "spmv": ("src/repro/kernels/spmv.py:32", "spmv.cu", "spmv"),
}
KERNEL_REPLACES = {name: k[0] for name, k in KERNELS.items()}
MAIN_M = 32
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch
    from repro_torch.core import elastic_transform
    from repro_torch.kernels import build, spmv, sptrsv
    from repro_torch.kernels.ops import (
        elastic_kernel_args,
        elastic_kernel_arrays,
        kernel_plan_arrays,
    )
    from repro_torch.kernels.ref import sptrsv_elastic_ref, sptrsv_ref, spmv_ell_ref
    from repro_torch.solver.executor import pad_rhs, plan_arrays
    from repro_torch.sparse import (
        erdos_renyi_lower,
        ichol0,
        narrow_band_lower,
        poisson2d_matrix,
    )

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
                pa_gpu = kernel_plan_arrays(plan, device=dev)
                pa_plain_gpu = plan_arrays(plan, device=dev)
                rng = np.random.default_rng(k)
                for m in (None, 5, 64, 300):
                    b = torch.as_tensor(rng.standard_normal(
                        2000 if m is None else (2000, m)), dtype=torch.float32)
                    b_pad = pad_rhs(b)
                    x_cpu = sptrsv_ref(*pa_cpu[:5], b_pad)
                    x_gpu = sptrsv.sptrsv_cuda(*pa_gpu[:6], b_pad.to(dev))
                    x_plain_gpu = sptrsv_ref(*pa_plain_gpu[:5], b_pad.to(dev))
                    torch.cuda.synchronize()
                    same = bitwise_equal(x_gpu, x_cpu)
                    cells.append({"matrix": gen_name, "k": k, "W": plan.W,
                                  "T": plan.n_steps, "m": m, "bitwise": same,
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
                args_cpu = elastic_kernel_args(*elastic_kernel_arrays(plan_e, device="cpu"))
                args_gpu = elastic_kernel_args(*elastic_kernel_arrays(plan_e, device=dev))
                rng = np.random.default_rng(k + slack)
                for m in (None, 5, 64):
                    b_pad = pad_rhs(torch.as_tensor(rng.standard_normal(
                        2000 if m is None else (2000, m)), dtype=torch.float32))
                    x_cpu = sptrsv_elastic_ref(*args_cpu, b_pad)
                    x_bulk = sptrsv_ref(*pa_cpu[:5], b_pad)
                    x_gpu = sptrsv.sptrsv_elastic_cuda(*args_gpu, b_pad.to(dev))
                    torch.cuda.synchronize()
                    same = bitwise_equal(x_gpu, x_cpu)
                    cells.append({"matrix": gen_name, "k": k, "slack": slack, "W": plan.W,
                                  "T": plan.n_steps, "waves": int(plan_e.elastic.n_waves.sum()),
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
    for gen_name, L in small.items():
        for width in (None, 2):
            col_idx, vals, _ = spmv.ell_from_csr(L, width=width)
            c, v = torch.from_numpy(col_idx), torch.from_numpy(vals)
            x_pad = pad_rhs(torch.as_tensor(
                np.random.default_rng(3).standard_normal(L.n_cols), dtype=torch.float32))
            y_cpu = spmv_ell_ref(c, v, x_pad)
            y_gpu = spmv.spmv_cuda(c.to(dev), v.to(dev), x_pad.to(dev))
            torch.cuda.synchronize()
            same = bitwise_equal(y_gpu, y_cpu)
            cells.append({"matrix": gen_name, "R": int(c.shape[0]), "W": int(c.shape[1]),
                          "split_rows": int(c.shape[0] - L.n_rows), "bitwise": same})
            require(same, f"spmv kernel != CPU plain version at {cells[-1]}")
    emit({"phase": "kernels", "names": ["spmv"], "launches": dict(spmv.launches),
          "cells": len(cells), "all_bitwise_vs_cpu_plain": True, "detail": cells})

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
               **{key: gpu.info()["plan"][key] for key in ("n_steps", "n_supersteps", "W", "k")}}
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
        rows.append({"matrix": name, "plan_s": round(plan_s, 3), "slack": ep.slack,
                     "n_steps": ep.n_steps, "n_macro_steps": ep.n_macro_steps,
                     "barriers_bulk": ep.n_supersteps, "barriers_elastic": int(ep.n_waves.sum()),
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
    require(spmv_launches["spmv"] > 0, "spmv was not launched on its path")
    emit({"phase": "main_path_spmv", "matrices": rows, "launches": spmv_launches,
          "bitwise_vs_cpu_plain": True, "max_abs_err": main_err["spmv"], **card})
    path_launches = {**main_launches, **{k: elastic_launches[k] for k in (
        "elastic_single", "elastic_mrhs")}, **spmv_launches}

    # --------------------------------------------------------- timing
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
        pa = kernel_plan_arrays(plan, device=dev)
        plan_bytes = sum(t.numel() * t.element_size() for t in pa[:6])
        esize = pa.vals.element_size()
        work = plan_work(plan, esize)
        for kname, m in (("sptrsv_single", None), ("sptrsv_mrhs", MAIN_M)):
            b_pad = rhs_pad(gpu.n, m)
            args = (*pa[:6], b_pad)
            ms = statistics.median(cuda_times(lambda: sptrsv.sptrsv_cuda(*args), 3, 20))
            pa_plain = plan_arrays(gpu.exec_plan, device=dev)
            plain = cuda_times(lambda: sptrsv_ref(*pa_plain[:5], b_pad), 1, 3)
            # the library solves L itself (caller row order), so it is
            # checked against the front door's answer, not the plan's
            rhs = b_pad[:-1].contiguous()
            lib, lib_gap, lib_err = library_ms(
                mats[name], gpu.source_values, rhs, gpu.solve(rhs))
            cols = 1 if m is None else m
            rhs_bytes = 2 * gpu.n * cols * esize  # b read, x written
            # the padded plan as the kernel reads it, padding included
            plan_total = plan_bytes + 2 * b_pad.numel() * b_pad.element_size()
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1,
                   **bound(work["bytes"] + pa.step_bounds.numel() * 4 + rhs_bytes,
                           2 * (work["entries"] + work["finishes"]) * cols),
                   "entries": work["entries"], "padding_share": work["padding_share"],
                   "bound_padded_plan_us": plan_total / HBM_BYTES_PER_S * 1e6,
                   "padded_plan_bytes": plan_total,
                   "barriers": plan.n_supersteps,
                   "plain_ms": statistics.median(plain),
                   "plain_reps": len(plain), "library_ms": lib,
                   "library": "torch.triangular_solve(B, L_csr, upper=False)",
                   "library_rel_gap_to_port": lib_gap,
                   "library_error": lib_err, **card}
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    for name, el in elastic_solvers.items():
        plan = el.exec_plan
        ep = plan.elastic
        args = elastic_kernel_args(*elastic_kernel_arrays(plan, device=dev))
        esize = args[4].element_size()
        work = plan_work(plan, esize)
        wave_bytes = (args[0].numel() + args[1].numel()) * 4
        for kname, m in (("sptrsv_elastic_single", None), ("sptrsv_elastic_mrhs", MAIN_M)):
            b_pad = rhs_pad(el.n, m)  # the bulk timing's right-hand side
            ms = statistics.median(cuda_times(
                lambda: sptrsv.sptrsv_elastic_cuda(*args, b_pad), 3, 20))
            x = sptrsv.sptrsv_elastic_cuda(*args, b_pad)
            # the plain version once: it launches tens of operations per wave
            x_plain = []
            plain = cuda_times(lambda: x_plain.append(sptrsv_elastic_ref(*args, b_pad)), 0, 1)
            require(bitwise_equal(x, x_plain[0]), f"{name} {kname}: timed kernel != plain")
            cols = 1 if m is None else m
            bulk = timing[(name, kname.replace("elastic_", ""))]
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1,
                   **bound(work["bytes"] + wave_bytes + 2 * el.n * cols * esize,
                           2 * (work["entries"] + work["finishes"]) * cols),
                   "entries": work["entries"], "slack": ep.slack,
                   "barriers": int(ep.n_waves.sum()), "barriers_bulk": ep.n_supersteps,
                   "bulk_ms": bulk["ms"], "ms_over_bulk": ms / bulk["ms"],
                   "plain_ms": statistics.median(plain), "plain_reps": len(plain),
                   # the same system and right-hand side as the bulk record
                   "library_ms": bulk["library_ms"], "library": bulk["library"],
                   "library_error": bulk["library_error"], **card}
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    for name, L in mats.items():
        col_idx, vals, _ = spmv.ell_from_csr(L)
        c, v = torch.from_numpy(col_idx).to(dev), torch.from_numpy(vals).to(dev)
        x = torch.as_tensor(spmv_x[name], dtype=torch.float32, device=dev)
        x_pad = pad_rhs(x)
        ms = statistics.median(cuda_times(lambda: spmv.spmv_cuda(c, v, x_pad), 3, 20))
        kernel_graph_ms, kernel_graph_err = graph_ms(lambda: spmv.spmv_cuda(c, v, x_pad), 20)
        plain = cuda_times(lambda: spmv_ell_ref(c, v, x_pad), 1, 5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Lc = torch.sparse_csr_tensor(
                torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                torch.as_tensor(L.data, dtype=torch.float32), size=(L.n_rows, L.n_cols),
            ).to(dev)
            lib = cuda_times(lambda: Lc @ x, 1, 5)
            lib_graph_ms, lib_graph_err = graph_ms(lambda: Lc @ x, 20)
            y_lib = (Lc @ x).double().cpu().numpy()
        y64 = L.to_scipy() @ spmv_x[name]
        R, W = col_idx.shape
        # each real entry (column and value) and x read once, y written once
        rec = {"matrix": name, "kernel": "spmv", "R": R, "W": W, "ms": ms,
               "graph_ms": kernel_graph_ms, "graph_error": kernel_graph_err,
               "launches_per_solve": 1,
               **bound(L.nnz * 8 + (L.n_cols + 1) * 4 + R * 4, 2 * L.nnz),
               "padding_share": 1.0 - L.nnz / (R * W),
               "plain_ms": statistics.median(plain), "plain_reps": len(plain),
               "library_ms": statistics.median(lib), "library": "L_csr @ x",
               "library_graph_ms": lib_graph_ms, "library_graph_error": lib_graph_err,
               "library_relerr_vs_scipy_f64": float(
                   np.linalg.norm(y_lib - y64) / np.linalg.norm(y64)), **card}
        timing[(name, "spmv")] = rec
        emit({"phase": "timing", **rec})

    summary = []
    for kname, (replaces, source, counter) in KERNELS.items():
        rec = timing[("er", kname)]
        summary.append({
            "name": kname, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
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
