"""Variants of the level-ordered single-RHS SpTRSV kernel, timed side by side
on the card (CUDA events, one process, one call).

    PYTHONPATH=src python3 -m repro_torch.kernels.level_sweep \\
        [--parent-src PATH/sptrsv.cu] [--out FILE.jsonl]

Builds ``csrc/sptrsv.cu`` and these variants of its level kernel, all at
once (one nvcc each):

  t1024    the kernel as shipped: one block of 1,024 threads
  t512     the same with 512 threads
  t256     the same with 256 threads
  pf1024   1,024 threads; each thread loads its first vertex bounds of the
           next level before the current level's barrier
  bar1024  the level loop's barriers alone, no solve: what the barriers
           cost by themselves

and, given ``--parent-src``, the previous design of the single-RHS kernel
(a ``sptrsv.cu`` whose ``sptrsv_single_*`` entry points take the plan's
``step_bounds`` and walk one serial chain per lane). Every variant but
``bar1024`` is held bitwise against the plain version ``sptrsv_ref`` on
the CPU, on small ER / NB plans and on the n = 100,000 main-path plans
(ER p = 1e-4; NB p = 0.14, B = 10 with a dominant diagonal; growlocal,
k = 8); the run exits non-zero where one differs. Timing on the large
plans: median of 20 after 3 warm-ups, in the order parent, variants,
variants reversed, parent; the library yardstick is
``torch.triangular_solve`` on the sparse-CSR L. One JSON object per line
on stdout (and into ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, sptrsv
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import kernel_plan_arrays, level_plan_arrays
from repro_torch.kernels.ref import sptrsv_level_ref, sptrsv_ref
from repro_torch.pipeline import TriangularSolver
from repro_torch.solver.executor import pad_rhs, plan_arrays
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

_LAUNCH = "sptrsv_level_kernel<T><<<1, kMaxThreads,"
_HEAD = "template <typename T>\n__global__ void sptrsv_level_kernel("
_NEXT = "template <typename T>\n__global__ void sptrsv_mrhs_kernel("
_SIGNATURE = """template <typename T>
__global__ void sptrsv_level_kernel(
    const int32_t* __restrict__ row_ids, const int32_t* __restrict__ col_idx,
    const T* __restrict__ vals, const T* __restrict__ diag,
    const uint8_t* __restrict__ accum, const int32_t* __restrict__ vert_ptr,
    const int32_t* __restrict__ level_ptr, int n_levels, int W,
    const T* __restrict__ b, T* x) {
"""
_PREFETCH = _SIGNATURE + """  const int tid = threadIdx.x;
  int v0 = __ldg(level_ptr);
  int v1 = n_levels > 0 ? __ldg(level_ptr + 1) : v0;
  int p0 = 0, p1 = 0;
  if (v0 + tid < v1) { p0 = __ldg(vert_ptr + v0 + tid); p1 = __ldg(vert_ptr + v0 + tid + 1); }
  for (int lv = 0; lv < n_levels; ++lv) {
    const int v2 = lv + 2 <= n_levels ? __ldg(level_ptr + lv + 2) : v1;
    int q0 = 0, q1 = 0;
    if (v1 + tid < v2) { q0 = __ldg(vert_ptr + v1 + tid); q1 = __ldg(vert_ptr + v1 + tid + 1); }
    for (int v = v0 + tid; v < v1; v += blockDim.x) {
      if (v != v0 + tid) { p0 = __ldg(vert_ptr + v); p1 = __ldg(vert_ptr + v + 1); }
      T acc = T(0);
      for (int p = p0; p < p1; ++p) {
        const int32_t* c = col_idx + static_cast<int64_t>(p) * W;
        const T* a = vals + static_cast<int64_t>(p) * W;
#pragma unroll 4
        for (int w = 0; w < W; ++w) acc = rn::fma(__ldg(a + w), x[__ldg(c + w)], acc);
        if (!__ldg(accum + p)) {
          const int32_t r = __ldg(row_ids + p);
          x[r] = rn::finish(__ldg(b + r), acc, __ldg(diag + p));
        }
      }
    }
    __syncthreads();
    v0 = v1; v1 = v2; p0 = q0; p1 = q1;
  }
}

"""
_BARRIERS = _SIGNATURE + """  int v0 = __ldg(level_ptr);
  for (int lv = 0; lv < n_levels; ++lv) {
    const int v1 = __ldg(level_ptr + lv + 1);
    if (threadIdx.x == 0 && v1 < v0) x[0] = T(1);  // never true; keeps the loads
    __syncthreads();
    v0 = v1;
  }
}

"""
LEVEL_VARIANTS = ("t1024", "t512", "t256", "pf1024")


def variant_sources() -> dict:
    """Source text of each variant of ``csrc/sptrsv.cu``."""
    src = (build.CSRC / "sptrsv.cu").read_text()
    if _LAUNCH not in src or _HEAD not in src or _NEXT not in src:
        raise RuntimeError("csrc/sptrsv.cu no longer has the level kernel this sweep edits")
    k0, k1 = src.index(_HEAD), src.index(_NEXT)
    return {
        "t1024": src,
        "t512": src.replace(_LAUNCH, "sptrsv_level_kernel<T><<<1, 512,"),
        "t256": src.replace(_LAUNCH, "sptrsv_level_kernel<T><<<1, 256,"),
        "pf1024": src[:k0] + _PREFETCH + src[k1:],
        "bar1024": src[:k0] + _BARRIERS + src[k1:],
    }


def _nvcc(item):
    name, source, out_dir = item
    so = out_dir / f"lib{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(source)],
        capture_output=True, text=True,
    )
    return name, proc.returncode, time.perf_counter() - t0, so, proc.stdout + proc.stderr


def _dominant(L, data):
    """``data`` with each diagonal entry set to sign · (1 + the row's
    off-diagonal absolute sum), the smoke's NB values."""
    rows = L.row_of_entry()
    on_diag = L.indices == rows
    off = np.bincount(rows, weights=np.where(on_diag, 0.0, np.abs(data)), minlength=L.n_rows)
    out = np.array(data, dtype=np.float64)
    out[on_diag] = np.where(data[on_diag] < 0, -1.0, 1.0) * (1.0 + off[rows[on_diag]])
    return out


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    iv = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(a.view(iv), b.view(iv)))


def _median_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, help="the previous design's sptrsv.cu")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("level_sweep: no CUDA device", file=sys.stderr)
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

    work = build.BUILD_DIR.parent / "level_sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, text in variant_sources().items():
        path = work / f"{name}.cu"
        path.write_text(text)
        jobs.append((name, path, work))
    if args.parent_src:
        jobs.append(("parent", args.parent_src.resolve(), work))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(_nvcc, jobs))
    libs = {}
    for name, rc, sec, so, log in built:
        emit({"build": name, "rc": rc, "s": round(sec, 2),
              "ptxas": [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                        if "registers" in ln or "error" in ln][:8]})
        if rc != 0:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(so))

    P, I = ctypes.c_void_p, ctypes.c_int

    def entry(name, dtype):
        fn = getattr(libs[name], "sptrsv_single_f32" if dtype == torch.float32 else "sptrsv_single_f64")
        fn.argtypes = [P] * 6 + [I, I, I, P, P, P] if name == "parent" else [P] * 7 + [I, I, P, P, P]
        fn.restype = I
        return fn

    def run_level(name, la, b_pad):
        x = torch.zeros_like(b_pad)
        err = entry(name, b_pad.dtype)(
            *[t.data_ptr() for t in la[:7]], la.level_ptr.numel() - 1, la.col_idx.shape[1],
            b_pad.data_ptr(), x.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return x

    def run_parent(pa, b_pad):
        x = torch.zeros_like(b_pad)
        T, k, W = pa.col_idx.shape
        err = entry("parent", b_pad.dtype)(
            *[t.data_ptr() for t in pa[:6]], pa.step_bounds.numel() - 1, k, W,
            b_pad.data_ptr(), x.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent: CUDA error {err}")
        return x

    def check(plan, la, pa, b_pad):
        ref = sptrsv_ref(*plan_arrays(plan, dtype=b_pad.dtype, device="cpu")[:5], b_pad.cpu())
        res = {v: _bits_equal(run_level(v, la, b_pad), ref) for v in LEVEL_VARIANTS}
        res["wrapper"] = _bits_equal(sptrsv.sptrsv_level_cuda(*la[:7], b_pad), ref)
        if "parent" in libs:
            res["parent"] = _bits_equal(run_parent(pa, b_pad), ref)
        return res, ref

    ok = True
    small = {"er": erdos_renyi_lower(2000, 5e-3, seed=0),
             "nb": narrow_band_lower(2000, 0.14, 10, seed=0),
             "wide": erdos_renyi_lower(20000, 2e-5, seed=1)}
    for gname, L in small.items():
        for k, width in ((8, None), (32, 2)):
            plan = TriangularSolver.plan(L, k=k, width=width, device="cpu", backend="scan").exec_plan
            for dtype in (torch.float32, torch.float64):
                b_pad = pad_rhs(torch.as_tensor(
                    np.random.default_rng(k).standard_normal(L.n_rows), dtype=dtype)).to(dev)
                la = level_plan_arrays(plan, dtype=dtype, device=dev)
                pa = kernel_plan_arrays(plan, dtype=dtype, device=dev)
                res, _ = check(plan, la, pa, b_pad)
                ok &= all(res.values())
                emit({"cell": gname, "k": k, "W": plan.W, "dtype": str(dtype),
                      "levels": la.level_ptr.numel() - 1, "bitwise": res})

    nb = narrow_band_lower(100_000, 0.14, 10, seed=0)
    mats = {"er": erdos_renyi_lower(100_000, 1e-4, seed=0),
            "nb": dataclasses.replace(nb, data=_dominant(nb, nb.data))}
    for name, L in mats.items():
        t0 = time.perf_counter()
        solver = TriangularSolver.plan(L, device="cpu", backend="scan")
        plan = solver.exec_plan
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        order = level_order(plan)
        order_s = time.perf_counter() - t0
        la = level_plan_arrays(plan, device=dev, order=order)
        pa = kernel_plan_arrays(plan, device=dev)
        b_pad = pad_rhs(torch.as_tensor(
            np.random.default_rng(7).standard_normal(L.n_rows), dtype=torch.float32)).to(dev)
        res, ref = check(plan, la, pa, b_pad)
        ok &= all(res.values())
        seq = (["parent"] if "parent" in libs else []) + [*LEVEL_VARIANTS, "bar1024"]
        ms = {}
        for rnd in (seq, seq[::-1]):
            for v in rnd:
                fn = ((lambda: run_parent(pa, b_pad)) if v == "parent"
                      else (lambda v=v: run_level(v, la, b_pad)))
                ms.setdefault(v, []).append(_median_ms(fn))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Lc = torch.sparse_csr_tensor(
                torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                torch.as_tensor(solver.source_values, dtype=torch.float32),
                size=(L.n_rows, L.n_cols)).to(dev)
            rhs = b_pad[:-1].reshape(-1, 1).contiguous()
            lib = _median_ms(lambda: torch.triangular_solve(rhs, Lc, upper=False), 1, 5)
        t0 = time.perf_counter()
        x_plain = sptrsv_level_ref(*la[:7], b_pad)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_ok = _bits_equal(x_plain, ref)
        ok &= plain_ok
        emit({"matrix": name, "n": L.n_rows, "T": plan.n_steps, "supersteps": plan.n_supersteps,
              "W": plan.W, "plan_s": plan_s, "level_order_s": order_s, **order.stats(),
              "bitwise_vs_cpu_plain": res, "plain_level_on_card_bitwise": plain_ok,
              "plain_level_on_card_s": plain_s, "ms_rounds": ms, "library_ms": lib, "smi": smi})
    emit({"all_bitwise": bool(ok)})
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
