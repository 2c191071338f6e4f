"""The SpMV kernel at each choice of slots a step and threads a block,
beside the design it replaced and the library, timed side by side on the
card (CUDA events, one process, one call).

    PYTHONPATH=src python3 -m repro_torch.kernels.spmv_sweep \\
        [--parent-src DIR] [--out FILE.jsonl]

Builds ``csrc/spmv.cu`` as it ships, ``csrc/sweep/spmv_variants.cu`` (the
same kernel at U = 1, 2, 4, 8 slots a step and 128 or 256 threads a block;
only this sweep builds it) and, given ``--parent-src`` (a directory with
the previous commit's ``spmv.cu`` and ``rn.cuh``: the padded-ELL kernel,
one value per ELL row, entry ``spmv_ell_f32``), that too, all at once (one
nvcc each), and prints each build's registers per kernel.

Matrices, float32: ER (n = 100,000, p = 1e-4, seed 0), NB (n = 100,000,
p = 0.14, B = 10, seed 0) and the 5-point Poisson matrix of the 512 x 512
grid (CG's A in ``chip_smoke.py``'s pcg phase); x from seed 1.

  ship           ``EllOperator(A)(x)``: the shipped kernel through its
                 wrapper, checks and launch path included
  u{U}_t{B}      the variant's entry on the same bound layout (ctypes)
  parent_kernel  the previous kernel alone on the padded ELL, x padded
                 beforehand: one value per ELL row
  parent_op      the previous operator: x padded, the kernel, the split
                 rows summed piece by piece (one gather-add a piece)
  library        ``L_csr @ x`` (cuSPARSE)

Each is timed eager (CUDA events around one call; median of 50 after 5
warm-ups) and as the replay of a CUDA graph that holds 100 calls (per
call: the device's time without the host's launch path), in the order
parent, the rest, the rest reversed, parent. Every kernel's answer is held
bitwise to the plain version on the CPU (``parent_op``'s too: it computes
the definition the sliced walk keeps), the library's within 1e-5 relative;
the run exits non-zero where one differs. Last, the pick: the variant with
the least sum over the matrices of its graph time, where it beats the
shipped choice by more than 5%, else the shipped choice. One JSON object
per line on stdout (and into ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.level_sweep import bits_equal, median_ms, nvcc_job, ptxas_registers
from repro_torch.kernels.ref import spmv_sliced_ref
from repro_torch.kernels.spmv import EllOperator, ell_from_csr
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower, poisson2d_matrix

VARIANTS = [(u, b) for b in (128, 256) for u in (1, 2, 4, 8)]
VARIANTS_SRC = build.CSRC / "sweep" / "spmv_variants.cu"
GRAPH_CALLS = 100
SHIPS = "u1_t256"  # csrc/spmv.cu's kUnroll and kThreads
PICK_MARGIN = 0.05  # another choice ships only where it beats SHIPS by more
_P, _I = ctypes.c_void_p, ctypes.c_int


def _entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, _I
    return fn


def _graph_ms(fn, reps=20):
    """Per call: the median replay of a graph of ``GRAPH_CALLS`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    return median_ms(g.replay, 3, reps) / GRAPH_CALLS


class _ParentOp:
    """The previous operator on A's padded ELL: x padded with the scratch
    slot, the parent's kernel (one value per ELL row), then the split rows
    summed piece by piece in piece order."""

    def __init__(self, lib, m, dev):
        col_idx, vals, row_map = ell_from_csr(m)
        self.c, self.v = torch.from_numpy(col_idx).to(dev), torch.from_numpy(vals).to(dev)
        self.R, self.W, self.n = col_idx.shape[0], col_idx.shape[1], m.n_rows
        first = np.flatnonzero(np.r_[True, row_map[1:] != row_map[:-1]])
        piece = np.arange(self.R) - np.repeat(first, np.diff(np.r_[first, self.R]))
        self.first = torch.from_numpy(first).to(dev)
        self.rest = [(torch.from_numpy(np.flatnonzero(piece == p)).to(dev),
                      torch.from_numpy(row_map[piece == p].astype(np.int64)).to(dev))
                     for p in range(1, int(piece.max()) + 1)]
        self.fn = _entry(lib, "spmv_ell_f32", [_P, _P, _I, _I, _P, _P, _P])

    def kernel(self, x_pad):
        y = torch.empty(self.R, dtype=torch.float32, device=x_pad.device)
        err = self.fn(self.c.data_ptr(), self.v.data_ptr(), self.R, self.W, x_pad.data_ptr(),
                      y.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent spmv_ell: CUDA error {err}")
        return y

    def __call__(self, x):
        y_ell = self.kernel(torch.cat([x, x.new_zeros(1)]))
        y = y_ell.new_zeros(self.n) + y_ell[self.first]
        for src, dst in self.rest:
            y[dst] = y[dst] + y_ell[src]
        return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", type=Path,
                    help="directory with the previous commit's spmv.cu and rn.cuh")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmv_sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    dev = torch.device("cuda")

    work = build.BUILD_DIR.parent / "spmv_sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = [("variants", VARIANTS_SRC, work)]
    if args.parent_src:
        jobs.append(("parent", args.parent_src.resolve() / "spmv.cu", work))
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        shipped = pool.submit(build.load, "spmv")
        built = list(pool.map(nvcc_job, jobs))
        shipped.result()
    libs = {}
    for name, rc, sec, so, log in built:
        emit({"build": name, "rc": rc, "s": round(sec, 2), "ptxas": ptxas_registers(log),
              "errors": [ln for ln in log.splitlines() if "error" in ln][:8]})
        if rc != 0:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(so))
    variants = {f"u{u}_t{b}": _entry(libs["variants"], f"spmv_u{u}_t{b}_f32",
                                     [_P] * 4 + [_I, _I, _P, _P, _P]) for u, b in VARIANTS}

    mats = {"er": erdos_renyi_lower(100_000, 1e-4, seed=0),
            "nb": narrow_band_lower(100_000, 0.14, 10, seed=0),
            "pcg_A": poisson2d_matrix(512)}
    graph_sum = {name: 0.0 for name in variants}
    for mname, m in mats.items():
        op = EllOperator(m, device=dev)
        lay = op.layout
        x_cpu = torch.as_tensor(np.random.default_rng(1).standard_normal(m.n_cols),
                                dtype=torch.float32)
        x = x_cpu.to(dev)
        y_ref = spmv_sliced_ref(*(t.cpu() for t in lay[:4]), lay.width, x_cpu)
        calls = {"ship": lambda: op(x)}
        for vname, fn in variants.items():
            def call(fn=fn, vname=vname):
                y = torch.empty(m.n_rows, dtype=torch.float32, device=dev)
                err = fn(*(t.data_ptr() for t in lay[:4]), m.n_rows, lay.width, x.data_ptr(),
                         y.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{vname}: CUDA error {err}")
                return y
            calls[vname] = call
        parents = {}
        if "parent" in libs:
            pop = _ParentOp(libs["parent"], m, dev)
            x_pad = torch.cat([x, x.new_zeros(1)])
            parents = {"parent_kernel": lambda: pop.kernel(x_pad), "parent_op": lambda: pop(x)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            lc = torch.sparse_csr_tensor(
                torch.as_tensor(m.indptr), torch.as_tensor(m.indices),
                torch.as_tensor(m.data, dtype=torch.float32), size=(m.n_rows, m.n_cols)).to(dev)
            calls["library"] = lambda: lc @ x
            y_lib = (lc @ x).double().cpu()
        for name, fn in {**calls, **parents}.items():
            if name in ("library", "parent_kernel"):
                continue
            if not bits_equal(fn(), y_ref):
                emit({"matrix": mname, "variant": name, "bitwise_vs_cpu_plain": False})
                return 1
        lib_rel = float((y_lib - y_ref.double()).norm() / y_ref.double().norm())
        if lib_rel > 1e-5:
            emit({"matrix": mname, "library_rel_gap": lib_rel})
            return 1
        names = list(calls)
        seq = list(parents) + names + names[::-1] + list(parents)
        eager, graph = {k: [] for k in seq}, {k: [] for k in seq}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for name in seq:
                fn = {**calls, **parents}[name]
                eager[name].append(median_ms(fn, warmup=5, reps=50))
                try:
                    graph[name].append(_graph_ms(fn))
                except RuntimeError as e:  # a capture the call refuses
                    graph[name].append(None)
                    emit({"matrix": mname, "variant": name, "graph_error": str(e)[:200]})
        rows = {k: {"eager_ms": statistics.mean(eager[k]),
                    "graph_ms": statistics.mean(graph[k]) if None not in graph[k] else None,
                    "eager_each": eager[k], "graph_each": graph[k]} for k in eager}
        for vname in variants:
            graph_sum[vname] += rows[vname]["graph_ms"]
        emit({"matrix": mname, "n": m.n_rows, "nnz": m.nnz, "W": lay.width,
              "lane_idle_share": op.lane_idle_share, "bitwise_vs_cpu_plain": True,
              "library_rel_gap": lib_rel, "graph_calls": GRAPH_CALLS, "times": rows, "smi": smi})
    best = min(graph_sum, key=graph_sum.get)
    pick = best if graph_sum[best] < (1 - PICK_MARGIN) * graph_sum[SHIPS] else SHIPS
    emit({"pick": pick, "least": best, "graph_ms_sum": graph_sum, "ships": SHIPS, "smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
