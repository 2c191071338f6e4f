#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:

  env        card name and power limit (nvidia-smi), torch, nvcc version
  build      compile csrc/sptrsv.cu with nvcc for sm_90a, from the sources
  kernels    both SpTRSV kernels on ER and NB matrices of n=2,000, k in
             {8, 32}, width in {None, 2}, single RHS and m in {5, 64, 300}:
             bitwise-equal to the plain version run on the CPU; the largest
             ulp gap to the plain version run on the card is reported
  main_path  the paper's synthetic sets at n=100,000 (§6.2.4 ER p=1e-4,
             §6.2.5 NB p=0.14 B=10, seed 0; NB with a dominant diagonal, as
             its own values overflow float32): TriangularSolver.plan(L) with
             every default (cuda, growlocal, k=8, kernel backend), solve b
             f[n] and B f[n, 32], numeric_update, solve again, then
             factor_pair on IC(0) of a 128x128 Poisson grid; every answer
             bitwise-equal to the plain version on the CPU; the launch
             counters must have risen
  timing     CUDA events on the main-path plans: kernel (3 warm-ups, median
             of 20), plain version on the card, torch.triangular_solve on a
             sparse-CSR L (the library yardstick, never called by the port),
             and the byte/operation bound of the H100 data sheet for the
             plan's real entries (padding left out; the padded plan's byte
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, outside the tensor cores
KERNEL_REPLACES = {
    "sptrsv_single": "src/repro/kernels/sptrsv.py:52",
    "sptrsv_mrhs": "src/repro/kernels/sptrsv.py:98",
}
MAIN_M = 32


def emit(obj) -> None:
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
    from repro_torch.kernels import build, sptrsv
    from repro_torch.kernels.ops import kernel_plan_arrays
    from repro_torch.kernels.ref import sptrsv_ref
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
    src = build.CSRC / "sptrsv.cu"
    build.library_path(src).unlink(missing_ok=True)  # build from the sources
    t0 = time.perf_counter()
    build.load("sptrsv")
    build_s = time.perf_counter() - t0
    regs = [ln.split(":", 1)[1].strip() for ln in build.build_log("sptrsv").splitlines()
            if "registers" in ln]
    emit({"phase": "build", "source": str(src.relative_to(ROOT)),
          "flags": " ".join(build.NVCC_FLAGS), "seconds": round(build_s, 3),
          "ptxas": regs})

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
    sptrsv.reset_launches()
    cells = []
    for gen_name, L in (("er", erdos_renyi_lower(2000, 5e-3, seed=0)),
                        ("nb", narrow_band_lower(2000, 0.14, 10, seed=0))):
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
    solvers, rows = {}, []
    sptrsv.reset_launches()  # the main path's launches start here
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
    for kname, key in (("sptrsv_single", "single"), ("sptrsv_mrhs", "mrhs")):
        require(main_launches[key] > 0, f"{kname} was not launched on the main path")
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

    timing = {}
    for name, gpu in solvers.items():
        plan = gpu.exec_plan
        pa = kernel_plan_arrays(plan, device=dev)
        plan_bytes = sum(t.numel() * t.element_size() for t in pa[:6])
        T, k, W = pa.col_idx.shape
        esize = pa.vals.element_size()
        # what this run's data needs: the plan's real entries and real lane
        # steps; padding gathers the scratch slot and is left out
        entries = int((plan.val_src >= 0).sum())
        real = plan.row_ids < plan.n
        lane_steps = int(real.sum())
        finishes = int((real & ~plan.accum).sum())
        padding_share = 1.0 - entries / (T * k * W)
        data_bytes = (entries * (4 + esize) + lane_steps * (4 + esize + 1)
                      + pa.step_bounds.numel() * 4)
        for kname, m in (("sptrsv_single", None), ("sptrsv_mrhs", MAIN_M)):
            shape = (gpu.n + 1,) if m is None else (gpu.n + 1, m)
            b_pad = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(dev)
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
            nbytes = data_bytes + rhs_bytes
            ops = 2 * (entries + finishes) * cols  # fma; subtract and divide
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / FP32_FLOPS * 1e3
            # the padded plan as the kernel reads it, padding included
            plan_total = plan_bytes + 2 * b_pad.numel() * b_pad.element_size()
            rec = {"matrix": name, "kernel": kname, "m": cols, "ms": ms,
                   "launches_per_solve": 1, "bound_us": max(bytes_ms, ops_ms) * 1e3,
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "bytes": nbytes, "ops": ops, "entries": entries,
                   "padding_share": padding_share,
                   "bound_padded_plan_us": plan_total / HBM_BYTES_PER_S * 1e6,
                   "padded_plan_bytes": plan_total,
                   "plain_ms": statistics.median(plain),
                   "plain_reps": len(plain), "library_ms": lib,
                   "library": "torch.triangular_solve(B, L_csr, upper=False)",
                   "library_rel_gap_to_port": lib_gap,
                   "library_error": lib_err, **card}
            timing[(name, kname)] = rec
            emit({"phase": "timing", **rec})

    summary = []
    for kname in ("sptrsv_single", "sptrsv_mrhs"):
        rec = timing[("er", kname)]
        summary.append({
            "name": kname, "route": "cuda", "source": "src/repro_torch/csrc/sptrsv.cu",
            "replaces": KERNEL_REPLACES[kname],
            "launches": main_launches["single" if kname == "sptrsv_single" else "mrhs"],
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
