"""The m-RHS column-group walk at each C beside the design it replaces,
timed side by side on the card (CUDA events, one process, one call).

    PYTHONPATH=src python3 -m repro_torch.kernels.level_sweep \\
        [--parent-src DIR] [--out FILE.jsonl]

Builds ``csrc/sptrsv.cu`` as it ships (one library for both level
orders), ``csrc/sweep/groups.cu`` (the column-group walk, which only this
sweep builds) and, given ``--parent-src`` (a directory with the previous
commit's ``sptrsv.cu``, ``level.cuh``, ``rn.cuh`` and, where it has one,
``sptrsv_elastic.cu``), those too, all at once (one nvcc each), and
prints each build's registers per kernel (``-Xptxas -v``).

The column groups: b f[n+1, m] packed to f[G, n+1, C] (``pack_groups``,
G = ceil(m / C), the C entries of a row contiguous, pad columns +0); block
g walks the level order for group g and a thread solves one vertex for
its C columns. C = 1 is the column-major copy and the column grid that
ships (``sptrsv_mrhs``); C > 1 is ``csrc/sweep/groups.cu``, which also
spells C = 1 for a control (``grp_c1``). Its plain
version is ``sptrsv_groups_ref``.

What it times, on the n = 100,000 main-path plans (ER p = 1e-4; NB
p = 0.14, B = 10 with a dominant diagonal; growlocal, k = 8):

  m = 32, f32   parent_mrhs: the previous design (a thread per column and
                lane walking the lane's chain, a barrier per superstep);
                walk_c{C}, C in 1, 2, 4, 8: the column-group walk over the
                bulk order with b packed in and x unpacked (and made
                contiguous) in the timed call; walk_c{C}_k: the kernel
                alone on packed b (x unpacked after the clock);
                walk_c{1,4}_k_cold: the kernel alone with L2 flushed
                before each call (64 MB written, outside the clock);
                grp_c1, grp_c1_k: the C = 1 walk as csrc/sweep/groups.cu
                spells it, beside walk_c1 (the shipped column grid);
                onerun_c{C}, onerun_c{C}_k: the same over the order of one
                run (slack >= the superstep count: the whole DAG's);
                elastic_s8 / parent_elastic_s8: the elastic column grid at
                slack 8 as it ships, this build and the parent's, copies
                included; elastic_groups_s8_c{C}, C > 1: the column-group
                walk over the slack-8 order, copies included
  m = 32, f64   walk_c{C} and walk_c{C}_k, C in 1, 2, 4; grp_c1(_k)
  m = 300, f32  walk_c{C} and walk_c{C}_k, C in 1, 2, 4, 8, grp_c1(_k):
                more column blocks than SMs at C = 1
  m = 1, f32    single / parent_single (the bulk single-RHS kernel),
                elastic_single_s8 / parent_elastic_single_s8
  library       torch.triangular_solve on the sparse-CSR L (cuSPARSE), f32

Every variant is held bitwise against the plain version ``sptrsv_ref`` on
the CPU, on small ER / NB plans (k in {8, 32}, width in {None, 2}, f32
and f64, m = 5 and one RHS) and on the main-path plans; the run exits
non-zero where one differs. Timing: median of 20 after 3 warm-ups, in the
order parent, variants, variants reversed, parent. Last, the pick: for
each type the C of ``walk_c{C}`` with the least sum of the ER and NB times
(copies included), and C = 1 unless that beats C = 1 by more than 5%.
One JSON object per line on stdout (and into ``--out``).
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

from repro_torch.kernels import build
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import level_plan_arrays
from repro_torch.kernels.ref import sptrsv_level_ref, sptrsv_ref
from repro_torch.pipeline import TriangularSolver
from repro_torch.solver.executor import pad_rhs, plan_arrays
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

MAIN_M = 32
WIDE_M = 300  # more column blocks than the card's 132 SMs at C = 1
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB of L2
PICK_MARGIN = 0.05  # a C > 1 ships only where it beats C = 1 by more than this
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_LEVEL = [_P] * 7 + [_I, _I]  # the level tensors, level count, W
# the staged walk's (csrc/level.cuh): the level tensors, the chunk table,
# level count, W, stage bytes and stages
_STAGED = [_P] * 9 + [_I] * 4
# the columns a group at which the sweep runs the walk, per type: a row of
# C entries is 4 to 32 bytes (C = 1 is the column grid that ships)
GROUP_COLS = {torch.float32: (1, 2, 4, 8), torch.float64: (1, 2, 4)}
GROUPS_SRC = build.CSRC / "sweep" / "groups.cu"


def pack_groups(b_pad: torch.Tensor, cols: int) -> torch.Tensor:
    """The column-group layout: b_pad f[n+1, m] as f[G, n+1, C] with
    C = ``cols`` and G = ceil(m / C). Group g holds columns g*C .. g*C +
    C - 1, the C entries of one row contiguous; the columns past m are +0,
    and the scratch row n is b_pad's. At C = 1 it is the column-major
    copy that ``kernels.sptrsv`` passes to the column grid.
    ``unpack_groups`` inverts it."""
    rows, m = b_pad.shape
    if cols == 1:  # as a 2-D transpose the copy ran 0.02 ms faster on the card
        return b_pad.T.contiguous().unsqueeze(2)
    groups = -(-m // cols)
    if groups * cols != m:
        b_pad = torch.nn.functional.pad(b_pad, (0, groups * cols - m))
    return b_pad.reshape(rows, groups, cols).transpose(0, 1).contiguous()


def unpack_groups(x_groups: torch.Tensor, m: int) -> torch.Tensor:
    """x f[n+1, m] from the column-group layout f[G, n+1, C], the pad
    columns dropped: a view at C = 1, a copy otherwise."""
    groups, rows, cols = x_groups.shape
    return x_groups.transpose(0, 1).reshape(rows, groups * cols)[:, :m]


def sptrsv_groups_ref(row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr, b_groups):
    """Plain version of the column-group walk on its own layout: b_groups
    f[G, n+1, C] (``pack_groups``), each group solved by
    ``sptrsv_level_ref`` as b f[n+1, C]; returns x in the same layout."""
    level = (row_ids, col_idx, vals, diag, accum, vert_ptr, level_ptr)
    if b_groups.shape[0] == 0:
        return torch.zeros_like(b_groups)
    return torch.stack([sptrsv_level_ref(*level, b) for b in b_groups])


def nvcc_job(item):
    name, source, out_dir = item
    so = out_dir / f"lib{name}.so"
    t0 = time.perf_counter()
    # a source's own directory comes first for #include "...": the parent's
    # sources find the parent's headers
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(source)],
        capture_output=True, text=True,
    )
    return name, proc.returncode, time.perf_counter() - t0, so, proc.stdout + proc.stderr


def ptxas_registers(log):
    """{kernel (mangled): "N registers, S bytes spill stores"} from
    ptxas's -v report."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.rsplit(" ", 1)[-1]
            out[fn] = ""
        elif fn and "spill stores" in line:
            out[fn] += line.strip().split(",")[1].strip()
        elif fn and "registers" in line:
            out[fn] = line.split("Used")[1].split(",")[0].strip() + ", " + out[fn]
    return out


def _dominant(L, data):
    """``data`` with each diagonal entry set to sign · (1 + the row's
    off-diagonal absolute sum), the smoke's NB values."""
    rows = L.row_of_entry()
    on_diag = L.indices == rows
    off = np.bincount(rows, weights=np.where(on_diag, 0.0, np.abs(data)), minlength=L.n_rows)
    out = np.array(data, dtype=np.float64)
    out[on_diag] = np.where(data[on_diag] < 0, -1.0, 1.0) * (1.0 + off[rows[on_diag]])
    return out


def bits_equal(a, b):
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    iv = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and bool(torch.equal(a.view(iv), b.view(iv)))


def median_ms(fn, warmup=3, reps=20, setup=None):
    """Median ms of ``fn`` between CUDA events; ``setup`` runs before each
    call, outside the events."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if setup:
            setup()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


class _Lib:
    """One built library's entry points, typed once, and calls that run
    them on prepared tensors."""

    def __init__(self, name, path, staged=False):
        self.name = name
        self.staged = staged  # built from the staged walk of csrc/level.cuh
        self.lib = ctypes.CDLL(str(path))
        self.fns = {}

    def _call(self, entry, dtype, argtypes, *args):
        key = (entry, dtype)
        if key not in self.fns:
            fn = getattr(self.lib, f"{entry}_{_SUFFIX[dtype]}")
            fn.argtypes, fn.restype = argtypes, _I
            self.fns[key] = fn
        err = self.fns[key](*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name} {entry}: CUDA error {err}")

    def _level(self, la):
        """The level arguments' types and values, in this build's layout."""
        L, W = la.level_ptr.numel() - 1, la.col_idx.shape[1]
        if self.staged:
            ch = la.chunks
            return _STAGED, (*[t.data_ptr() for t in la[:7]], ch.chunk_ptr.data_ptr(),
                             ch.level_chunk.data_ptr(), L, W, ch.stage_bytes, ch.n_stages)
        return _LEVEL, (*[t.data_ptr() for t in la[:7]], L, W)

    def single(self, entry, la, b_pad):
        """One RHS: ``sptrsv_single`` (or a parent's ``sptrsv_elastic_single``)."""
        x = torch.zeros_like(b_pad)
        types, args = self._level(la)
        self._call(entry, b_pad.dtype, types + [_P, _P, _P], *args, b_pad.data_ptr(),
                   x.data_ptr())
        return x

    def groups(self, la, b_groups):
        """The column-group walk of ``csrc/sweep/groups.cu`` on b
        f[G, n+1, C]; x in the same layout."""
        x = torch.zeros_like(b_groups)
        G, rows, C = b_groups.shape
        if b_groups.data_ptr() % min(16, C * b_groups.element_size()):
            raise ValueError("b_groups must be aligned to its row of C entries (or 16 bytes)")
        types, args = self._level(la)
        self._call("sptrsv_groups", b_groups.dtype, types + [_I, _I, _I64, _P, _P, _P],
                   *args, C, G, rows, b_groups.data_ptr(), x.data_ptr())
        return x

    def cols(self, entry, la, b_col, strides=False):
        """The column grid (``sptrsv_mrhs``, a parent's ``sptrsv_elastic_mrhs``) on
        column-major b f[m, n+1]; ``strides``: the parent's entry, which
        takes the row and the column stride."""
        x = torch.zeros_like(b_col)
        m, rows = b_col.shape[:2]
        shape = (1, rows) if strides else (rows,)
        types, args = self._level(la)
        self._call(entry, b_col.dtype, types + [_I] + [_I64] * len(shape) + [_P, _P, _P],
                   *args, m, *shape, b_col.data_ptr(), x.data_ptr())
        return x

    def parent_mrhs(self, pa, b_pad):
        """The previous design: the padded plan, its step bounds, b f[n+1, m]."""
        x = torch.zeros_like(b_pad)
        T, k, W = pa.col_idx.shape
        self._call("sptrsv_mrhs", b_pad.dtype, [_P] * 6 + [_I, _I, _I, _I, _P, _P, _P],
                   *[t.data_ptr() for t in pa[:6]], pa.step_bounds.numel() - 1, k, W,
                   b_pad.shape[1], b_pad.data_ptr(), x.data_ptr())
        return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path,
                    help="directory with the previous sptrsv.cu (sptrsv_elastic.cu) and headers")
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
    jobs = [("bulk", build.CSRC / "sptrsv.cu", work), ("groups", GROUPS_SRC, work)]
    if args.parent_src:
        src = args.parent_src.resolve()
        jobs.append(("parent_bulk", src / "sptrsv.cu", work))
        if (src / "sptrsv_elastic.cu").exists():  # a parent with its own elastic library
            jobs.append(("parent_elastic", src / "sptrsv_elastic.cu", work))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(nvcc_job, jobs))
    libs = {}
    for name, rc, sec, so, log in built:
        emit({"build": name, "rc": rc, "s": round(sec, 2), "ptxas": ptxas_registers(log),
              "errors": [ln for ln in log.splitlines() if "error" in ln][:8]})
        if rc != 0:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[name] = _Lib(name, so, staged=name == "bulk")
    parent = "parent_bulk" in libs
    new, grp = libs["bulk"], libs["groups"]
    # each build's elastic entries: its library and their prefix
    elastic = {"": (new, "sptrsv")}
    if parent:
        elastic["parent_"] = ((libs["parent_elastic"], "sptrsv_elastic") if "parent_elastic" in libs
                              else (libs["parent_bulk"], "sptrsv"))

    def walk(la_s, packed):
        """The walk over column groups: the column grid that ships at
        C = 1, csrc/sweep/groups.cu otherwise."""
        if packed.shape[2] == 1:
            return new.cols("sptrsv_mrhs", la_s, packed[:, :, 0]).unsqueeze(2)
        return grp.groups(la_s, packed)

    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    setups = {}  # variant -> what runs before each timed call of it

    def candidates(plan, dtype, m, full):
        """name -> zero-argument call returning x f[n+1(, m)], with its
        tensors prepared once; ``full``: every variant of the main plans,
        else those whose bits the small cells check. At m = WIDE_M and in
        float64 only the column-group walk."""
        rng = np.random.default_rng(7)
        b_pad = pad_rhs(torch.as_tensor(rng.standard_normal(
            plan.n if m is None else (plan.n, m)), dtype=dtype)).to(dev)
        slacks = (1, 8, plan.n_supersteps) if full else (1, 3)
        la = {s: level_plan_arrays(plan, dtype=dtype, device=dev,
                                   order=level_order(plan, slack=s)) for s in slacks}
        one = slacks[-1]  # one run: the whole DAG's order
        s8 = slacks[1]
        out = {}
        if m is None:
            if parent:
                out["parent_single"] = lambda: libs["parent_bulk"].single(
                    "sptrsv_single", la[1], b_pad)
                out[f"parent_elastic_single_s{s8}"] = lambda: elastic["parent_"][0].single(
                    f"{elastic['parent_'][1]}_single", la[s8], b_pad)
            out["single"] = lambda: new.single("sptrsv_single", la[1], b_pad)
            out[f"elastic_single_s{s8}"] = lambda: new.single("sptrsv_single", la[s8], b_pad)
            return b_pad, out
        extras = dtype == torch.float32 and m != WIDE_M
        if parent and extras:
            pa = plan_arrays(plan, dtype=dtype, device=dev)
            out["parent_mrhs"] = lambda: libs["parent_bulk"].parent_mrhs(pa, b_pad)

        def with_copies(la_s, cols):
            return lambda: unpack_groups(walk(la_s, pack_groups(b_pad, cols)), m).contiguous()

        for C in GROUP_COLS[dtype]:
            packed = pack_groups(b_pad, C)
            out[f"walk_c{C}"] = with_copies(la[1], C)
            out[f"walk_c{C}_k"] = lambda packed=packed: walk(la[1], packed)
            if full and extras and C in (1, 4):  # the kernel alone after L2 is flushed
                out[f"walk_c{C}_k_cold"] = out[f"walk_c{C}_k"]
                setups[f"walk_c{C}_k_cold"] = lambda: flush_buf.fill_(0.0)
            if C == 1:  # the same walk spelled as groups.cu spells it
                out["grp_c1"] = lambda: unpack_groups(
                    grp.groups(la[1], pack_groups(b_pad, 1)), m).contiguous()
                out["grp_c1_k"] = lambda packed=packed: grp.groups(la[1], packed)
            if extras:
                out[f"onerun_c{C}"] = with_copies(la[one], C)
                out[f"onerun_c{C}_k"] = lambda packed=packed: walk(la[one], packed)
                if C > 1:
                    out[f"elastic_groups_s{s8}_c{C}"] = with_copies(la[s8], C)
        if extras:  # each build's elastic column grid with the copies it ships with
            for tag, (lib, pre) in elastic.items():
                out[f"{tag}elastic_s{s8}"] = lambda lib=lib, pre=pre, tag=tag: lib.cols(
                    f"{pre}_mrhs", la[s8], b_pad.T.contiguous(),
                    strides=bool(tag)).T.contiguous()
        return b_pad, out

    def check(plan, dtype, m, full):
        b_pad, calls = candidates(plan, dtype, m, full)
        ref = sptrsv_ref(*plan_arrays(plan, dtype=dtype, device="cpu")[:5], b_pad.cpu())
        res = {}
        for name, fn in calls.items():
            x = fn()
            torch.cuda.synchronize()
            if x.dim() == 3:  # a kernel alone: x still in column groups
                x = unpack_groups(x, m)
            res[name] = bits_equal(x, ref)
        return res, b_pad, calls

    ok = True
    small = {"er": erdos_renyi_lower(2000, 5e-3, seed=0),
             "nb": narrow_band_lower(2000, 0.14, 10, seed=0)}
    for gname, L in small.items():
        for k, width in ((8, None), (32, 2)):
            plan = TriangularSolver.plan(L, k=k, width=width, device="cpu",
                                         backend="scan").exec_plan
            for dtype in (torch.float32, torch.float64):
                for m in (None, 5):
                    res, _, _ = check(plan, dtype, m, False)
                    ok &= all(res.values())
                    emit({"cell": gname, "k": k, "W": plan.W, "dtype": str(dtype), "m": m,
                          "bitwise": res})

    nb = narrow_band_lower(100_000, 0.14, 10, seed=0)
    mats = {"er": erdos_renyi_lower(100_000, 1e-4, seed=0),
            "nb": dataclasses.replace(nb, data=_dominant(nb, nb.data))}
    walk_ms = {}  # (dtype, C) -> {matrix: ms}
    for name, L in mats.items():
        t0 = time.perf_counter()
        solver = TriangularSolver.plan(L, device="cpu", backend="scan")
        plan = solver.exec_plan
        plan_s = time.perf_counter() - t0
        levels = {s: level_order(plan, slack=s).stats() for s in (1, 8, plan.n_supersteps)}
        for st in levels.values():
            st.pop("levels_per_run")
        emit({"matrix": name, "n": L.n_rows, "T": plan.n_steps, "supersteps": plan.n_supersteps,
              "W": plan.W, "plan_s": plan_s, "levels_by_slack": levels, "smi": smi})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            Lc = torch.sparse_csr_tensor(
                torch.as_tensor(L.indptr), torch.as_tensor(L.indices),
                torch.as_tensor(solver.source_values, dtype=torch.float32),
                size=(L.n_rows, L.n_cols)).to(dev)
        for dtype, m in ((torch.float32, MAIN_M), (torch.float64, MAIN_M), (torch.float32, None),
                         (torch.float32, WIDE_M)):
            res, b_pad, calls = check(plan, dtype, m, True)
            ok &= all(res.values())
            names = [v for v in calls if not v.startswith("parent")]
            seq = [v for v in calls if v.startswith("parent")] + names
            ms = {}
            for rnd in (seq, seq[::-1]):
                for v in rnd:
                    ms.setdefault(v, []).append(median_ms(calls[v], setup=setups.get(v)))
            lib = None
            if dtype == torch.float32 and m != WIDE_M:
                rhs = b_pad[:-1].reshape(L.n_rows, -1).contiguous()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    lib = median_ms(lambda: torch.triangular_solve(rhs, Lc, upper=False), 1, 5)
            for C in GROUP_COLS[dtype] if m == MAIN_M else ():
                walk_ms.setdefault((str(dtype), C), {})[name] = statistics.median(
                    ms[f"walk_c{C}"])
            emit({"matrix": name, "dtype": str(dtype), "m": 1 if m is None else m,
                  "bitwise_vs_cpu_plain": res, "ms_rounds": ms, "library_ms": lib,
                  "library": "torch.triangular_solve(B, L_csr, upper=False)", "smi": smi})
    pick = {}
    for dtype in GROUP_COLS:
        sums = {C: sum(walk_ms[(str(dtype), C)].values()) for C in GROUP_COLS[dtype]}
        best = min(sums, key=sums.get)
        pick[str(dtype)] = {"sum_er_nb_ms": sums, "least": best,
                            "ships": best if sums[best] < (1 - PICK_MARGIN) * sums[1] else 1}
    emit({"pick": pick, "rule": "least ER + NB walk_c{C} ms at m = 32, copies included; "
          f"C = 1 unless that beats it by more than {PICK_MARGIN:.0%}", "smi": smi})
    emit({"all_bitwise": bool(ok)})
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
