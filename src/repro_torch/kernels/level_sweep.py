"""The level-walk SpTRSV kernels beside their previous designs and variants,
timed side by side on the card (CUDA events, one process, one call).

    PYTHONPATH=src python3 -m repro_torch.kernels.level_sweep \\
        [--parent-src DIR] [--out FILE.jsonl]

Builds ``csrc/sptrsv.cu`` and ``csrc/sptrsv_elastic.cu`` as shipped, and
variants of the elastic m-RHS kernel with fewer threads per column block
(``csrc/level.cuh`` edited), all at once (one nvcc each). Given
``--parent-src``, a directory with the previous commit's ``sptrsv.cu`` and
``sptrsv_elastic.cu``, it builds those too: the bulk single-RHS level
kernel as it was before its body moved to ``level.cuh``, and the elastic
kernels of the previous design, which walk the certificate's readiness
waves with a block barrier per wave.

What it times, on the n = 100,000 main-path plans (ER p = 1e-4; NB
p = 0.14, B = 10 with a dominant diagonal; growlocal, k = 8), float32:

  single RHS    parent_bulk, bulk (the shipped bulk level kernel, bulk
                order); parent_wave (slack 8); elastic at slack 1, 8, 16
                (the level walk over runs of slack supersteps)
  m = 32 RHS    bulk_mrhs (shipped, unchanged); parent_wave_mrhs (slack 8);
                the elastic column-grid kernel at slack 1, 8, 16 on x
                f[n+1, m] row-major (``row``) and on a column-major copy
                (``col``: ``b.T.contiguous()`` in and ``x.T.contiguous()``
                out, timed with the kernel; ``colk``: the kernel alone);
                ``t256`` / ``t512``: row-major at slack 8 with 256 / 512
                threads per column block
  library       ``torch.triangular_solve`` on the sparse-CSR L (cuSPARSE),
                b and B

Every variant is held bitwise against the plain version ``sptrsv_ref`` on
the CPU, on small ER / NB plans (k in {8, 32}, width in {None, 2}, slack in
{1, 3, 8}, float32 and float64) and on the main-path plans; the run exits
non-zero where one differs. Timing: median of 20 after 3 warm-ups, in the
order parent, variants, variants reversed, parent. One JSON object per line
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

from repro_torch.core.elastic import elastic_transform
from repro_torch.kernels import build
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import level_plan_arrays
from repro_torch.kernels.ref import sptrsv_ref
from repro_torch.pipeline import TriangularSolver
from repro_torch.solver.executor import elastic_plan_arrays, pad_rhs, plan_arrays
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

_COLS_LAUNCH = "sptrsv_level_cols_kernel<T><<<m, kThreads,"
MAIN_M = 32
SLACKS = (1, 8, 16)
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def variant_headers() -> dict:
    """``level.cuh`` of each thread-count variant of the column kernel."""
    src = (build.CSRC / "level.cuh").read_text()
    if _COLS_LAUNCH not in src:
        raise RuntimeError("csrc/level.cuh no longer has the column launch this sweep edits")
    return {f"t{t}": src.replace(_COLS_LAUNCH, f"sptrsv_level_cols_kernel<T><<<m, {t},")
            for t in (256, 512)}


def _nvcc(item):
    name, source, include, out_dir = item
    so = out_dir / f"lib{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(include), "-I", str(build.CSRC),
         "-o", str(so), str(source)],
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
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    iv = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and bool(torch.equal(a.view(iv), b.view(iv)))


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


class _Libs:
    """The built libraries' entry points, typed, and calls that run them
    on prepared tensors and return x f[n+1(, m)]."""

    def __init__(self, libs):
        self.libs = libs
        self.fns = {}

    def _fn(self, lib, name, dtype, argtypes):
        """The entry point, typed once (outside the timed calls after the
        first)."""
        key = (lib, name, dtype)
        if key not in self.fns:
            fn = getattr(self.libs[lib], f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
            fn.argtypes = argtypes
            fn.restype = _I
            self.fns[key] = fn
        return self.fns[key]

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    @staticmethod
    def _raise(lib, err):
        if err:
            raise RuntimeError(f"{lib}: CUDA error {err}")

    def level_single(self, lib, entry, la, b_pad):
        """One RHS through a level kernel (``sptrsv_single`` or
        ``sptrsv_elastic_single``) over the level tensors ``la``."""
        x = torch.zeros_like(b_pad)
        fn = self._fn(lib, entry, b_pad.dtype, [_P] * 7 + [_I, _I, _P, _P, _P])
        self._raise(lib, fn(*[t.data_ptr() for t in la[:7]], la.level_ptr.numel() - 1,
                            la.col_idx.shape[1], b_pad.data_ptr(), x.data_ptr(),
                            self._stream()))
        return x

    def level_cols(self, lib, la, b_pad, layout):
        """m RHS through the elastic column kernel: ``row`` on b f[n+1, m]
        as it is, ``col`` on a column-major copy (copied in and out),
        ``colk`` on ``b_pad`` already column-major ([m, n+1]; x returned as
        [m, n+1])."""
        fn = self._fn(lib, "sptrsv_elastic_mrhs", b_pad.dtype,
                      [_P] * 7 + [_I, _I, _I, _I64, _I64, _P, _P, _P])
        if layout == "row":
            rows, m = b_pad.shape
            b, strides = b_pad, (m, 1)
        else:
            b = b_pad.T.contiguous() if layout == "col" else b_pad
            m, rows = b.shape
            strides = (1, rows)
        x = torch.zeros_like(b)
        self._raise(lib, fn(*[t.data_ptr() for t in la[:7]], la.level_ptr.numel() - 1,
                            la.col_idx.shape[1], m, *strides, b.data_ptr(), x.data_ptr(),
                            self._stream()))
        return x.T.contiguous() if layout == "col" else x

    def bulk_mrhs(self, lib, pa, b_pad):
        x = torch.zeros_like(b_pad)
        T, k, W = pa.col_idx.shape
        fn = self._fn(lib, "sptrsv_mrhs", b_pad.dtype, [_P] * 6 + [_I, _I, _I, _I, _P, _P, _P])
        self._raise(lib, fn(*[t.data_ptr() for t in pa[:6]], pa.step_bounds.numel() - 1, k, W,
                            b_pad.shape[1], b_pad.data_ptr(), x.data_ptr(), self._stream()))
        return x

    def wave(self, lib, ea, wave_id, n_waves, b_pad):
        """The previous design's elastic kernels: the macro-step tensors
        flattened to [M * S, ...], the certificate's wave tensors and the
        ``tot`` scratch they need."""
        M, S, k, W = ea.col_idx.shape
        T = M * S
        flat = (ea.row_ids.view(T, k), ea.col_idx.view(T, k, W), ea.vals.view(T, k, W),
                ea.diag.view(T, k), ea.accum.view(T, k))
        x = torch.zeros_like(b_pad)
        tot = torch.empty((T, k, *b_pad.shape[1:]), dtype=b_pad.dtype, device=b_pad.device)
        mrhs = b_pad.dim() == 2
        fn = self._fn(lib, "sptrsv_elastic_mrhs" if mrhs else "sptrsv_elastic_single",
                      b_pad.dtype, [_P] * 7 + [_I] * (5 if mrhs else 4) + [_P] * 4)
        shape = (M, S, k, W) + ((b_pad.shape[1],) if mrhs else ())
        self._raise(lib, fn(wave_id.data_ptr(), n_waves.data_ptr(),
                            *[t.data_ptr() for t in flat], *shape, b_pad.data_ptr(),
                            x.data_ptr(), tot.data_ptr(), self._stream()))
        return x


def _wave_tensors(plan, slack, dtype, dev):
    ep = elastic_transform(plan, slack)
    ea = elastic_plan_arrays(plan, slack=slack, dtype=dtype, device=dev)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32).reshape(-1)).to(dev)

    return ea, put(ep.wave_id), put(ep.n_waves), ep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path,
                    help="directory with the previous sptrsv.cu and sptrsv_elastic.cu")
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
    jobs = [("bulk", build.CSRC / "sptrsv.cu", build.CSRC, work),
            ("elastic", build.CSRC / "sptrsv_elastic.cu", build.CSRC, work)]
    for name, text in variant_headers().items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "level.cuh").write_text(text)
        (d / "sptrsv_elastic.cu").write_text((build.CSRC / "sptrsv_elastic.cu").read_text())
        jobs.append((name, d / "sptrsv_elastic.cu", d, work))
    if args.parent_src:
        for name, src in (("parent_bulk", "sptrsv.cu"), ("parent_wave", "sptrsv_elastic.cu")):
            jobs.append((name, (args.parent_src / src).resolve(), args.parent_src.resolve(), work))
    work.mkdir(parents=True, exist_ok=True)
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
    run = _Libs(libs)
    parent = "parent_bulk" in libs

    def candidates(plan, dtype, m, slacks):
        """name -> zero-argument call returning x f[n+1(, m)], for one
        right-hand-side shape, with its tensors prepared once."""
        rng = np.random.default_rng(7)
        b_pad = pad_rhs(torch.as_tensor(rng.standard_normal(
            plan.n if m is None else (plan.n, m)), dtype=dtype)).to(dev)
        la = {s: level_plan_arrays(plan, dtype=dtype, device=dev,
                                   order=level_order(plan, slack=s)) for s in slacks}
        out = {}
        if m is None:
            if parent:
                out["parent_bulk"] = lambda: run.level_single(
                    "parent_bulk", "sptrsv_single", la[1], b_pad)
            out["bulk"] = lambda: run.level_single("bulk", "sptrsv_single", la[1], b_pad)
            for s in slacks:
                out[f"elastic_s{s}"] = lambda s=s: run.level_single(
                    "elastic", "sptrsv_elastic_single", la[s], b_pad)
        else:
            pa = plan_arrays(plan, dtype=dtype, device=dev)
            out["bulk_mrhs"] = lambda: run.bulk_mrhs("bulk", pa, b_pad)
            b_col = b_pad.T.contiguous()
            for s in slacks:
                out[f"row_s{s}"] = lambda s=s: run.level_cols("elastic", la[s], b_pad, "row")
                out[f"col_s{s}"] = lambda s=s: run.level_cols("elastic", la[s], b_pad, "col")
            s8 = 8 if 8 in slacks else slacks[-1]
            out[f"colk_s{s8}"] = lambda: run.level_cols("elastic", la[s8], b_col, "colk").T
            for t in variant_headers():
                out[f"{t}_row_s{s8}"] = lambda t=t: run.level_cols(t, la[s8], b_pad, "row")
        if parent:
            ea, wave_id, n_waves, _ = _wave_tensors(plan, 8, dtype, dev)
            out["parent_wave"] = lambda: run.wave("parent_wave", ea, wave_id, n_waves, b_pad)
        return b_pad, out

    def check(plan, dtype, m, slacks):
        b_pad, calls = candidates(plan, dtype, m, slacks)
        ref = sptrsv_ref(*plan_arrays(plan, dtype=dtype, device="cpu")[:5], b_pad.cpu())
        res = {}
        for name, fn in calls.items():
            x = fn()
            torch.cuda.synchronize()
            res[name] = _bits_equal(x, ref)
        return res, b_pad, calls

    ok = True
    small = {"er": erdos_renyi_lower(2000, 5e-3, seed=0),
             "nb": narrow_band_lower(2000, 0.14, 10, seed=0)}
    for gname, L in small.items():
        for k, width in ((8, None), (32, 2)):
            plan = TriangularSolver.plan(L, k=k, width=width, device="cpu", backend="scan").exec_plan
            for dtype in (torch.float32, torch.float64):
                for m in (None, 5):
                    res, _, _ = check(plan, dtype, m, (1, 3, 8))
                    ok &= all(res.values())
                    emit({"cell": gname, "k": k, "W": plan.W, "dtype": str(dtype), "m": m,
                          "bitwise": res})

    nb = narrow_band_lower(100_000, 0.14, 10, seed=0)
    mats = {"er": erdos_renyi_lower(100_000, 1e-4, seed=0),
            "nb": dataclasses.replace(nb, data=_dominant(nb, nb.data))}
    for name, L in mats.items():
        t0 = time.perf_counter()
        solver = TriangularSolver.plan(L, device="cpu", backend="scan")
        plan = solver.exec_plan
        plan_s = time.perf_counter() - t0
        levels = {}
        for s in SLACKS + (plan.n_supersteps,):
            t0 = time.perf_counter()
            order = level_order(plan, slack=s)
            levels[s] = {**order.stats(), "level_order_s": time.perf_counter() - t0}
        ep = elastic_transform(plan, 8)
        emit({"matrix": name, "n": L.n_rows, "T": plan.n_steps, "supersteps": plan.n_supersteps,
              "W": plan.W, "plan_s": plan_s, "waves_slack8": int(ep.n_waves.sum()),
              "levels_by_slack": levels, "smi": smi})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Lc = torch.sparse_csr_tensor(
                torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                torch.as_tensor(solver.source_values, dtype=torch.float32),
                size=(L.n_rows, L.n_cols)).to(dev)
        for m in (None, MAIN_M):
            res, b_pad, calls = check(plan, torch.float32, m, SLACKS)
            ok &= all(res.values())
            names = list(calls)
            seq = (["parent_wave"] if parent else []) + [v for v in names if v != "parent_wave"]
            ms = {}
            for rnd in (seq, seq[::-1]):
                for v in rnd:
                    ms.setdefault(v, []).append(_median_ms(calls[v]))
            rhs = b_pad[:-1].reshape(L.n_rows, -1).contiguous()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                lib = _median_ms(lambda: torch.triangular_solve(rhs, Lc, upper=False), 1, 5)
            emit({"matrix": name, "m": 1 if m is None else m, "bitwise_vs_cpu_plain": res,
                  "ms_rounds": ms, "library_ms": lib,
                  "library": "torch.triangular_solve(B, L_csr, upper=False)", "smi": smi})
    emit({"all_bitwise": bool(ok)})
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
