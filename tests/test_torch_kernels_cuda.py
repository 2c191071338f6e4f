"""The CUDA kernels (bulk SpTRSV, the level walk of the bulk order for one
RHS and, a block per column, for m RHS; elastic SpTRSV, the level walk over
runs of supersteps for one and m RHS; the banked walk, a column per block
on its own plan of a bank; SpMV, and SpMV bound once as CG's matvec)
against their plain versions, on the card; IC(0)-preconditioned CG on the
card against the CPU plain PCG, timed solves, and width-class and
continuous serving on the card.

Marked ``cuda``: every test here skips on a host without a CUDA device (it
adds no pass there). On the card run it with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The front door's solve is one launch of the ordered walk (b read and x
written in the caller's row order): bitwise the gather, the unordered
kernel and the gather back, on ER, NB and both IC(0) factors, bulk and
elastic, one and 32 right-hand sides, f32 and f64; one device operation
under torch.profiler; a new x every call.

Every entry of the level walk (single, m-RHS, range, elastic, bank,
ordered; f32 and f64) is also held bitwise to the plain version over three
stage layouts: a
plan whose widest levels split into several chunks, chunks cut by bytes
under a smaller shared-memory budget (with vertices that take the
fallback), and a vertex wider than any stage at the card's budget.

``chip_smoke.py`` makes the same comparison at the main path's shapes.
The kernels must match the plain version run on the CPU bit for bit: both
chain fused multiply-adds left to right over W and divide correctly
rounded.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import elastic_transform
from repro_torch.kernels import levels, spmv, sptrsv
from repro_torch.kernels.ops import (
    LevelArrays,
    elastic_kernel_arrays,
    level_plan_arrays,
    ordered_walk,
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
    stack_level_bank,
)
from repro_torch.kernels.ref import (
    sptrsv_level_bank_ref,
    sptrsv_ordered_ref,
    spmv_ell_rows_ref,
    spmv_sliced_ref,
    sptrsv_level_ref,
    sptrsv_ref,
)
from repro_torch.solver import pcg_ichol
from repro_torch.solver.executor import pad_rhs, plan_arrays, solve_with_plan
from repro_torch.sparse import (
    CSRMatrix,
    csr_from_coo,
    erdos_renyi_lower,
    ichol0,
    narrow_band_lower,
    poisson2d_matrix,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    iv = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(iv), b.view(iv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [None, 5, 64, 300])
@pytest.mark.parametrize("k,width", [(8, None), (32, 2)])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_kernel_matches_plain_bitwise(cuda, gen, k, width, m, dtype):
    L = (erdos_renyi_lower(2000, 1e-3, seed=0) if gen == "er"
         else narrow_band_lower(2000, 0.14, 10, seed=0))
    plan = repro_torch.TriangularSolver.plan(L, k=k, width=width, device="cpu").exec_plan
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(2000 if m is None else (2000, m)), dtype=dtype)
    x_cpu = solve_with_plan(plan_arrays(plan, dtype=dtype, device="cpu"), b)
    before = dict(sptrsv.launches)
    x_gpu = solve_with_kernel_arrays(level_plan_arrays(plan, dtype=dtype, device=cuda),
                                     b.to(cuda))
    torch.cuda.synchronize()
    kind = "single" if m is None else "mrhs"
    assert sptrsv.launches[kind] == before[kind] + 1
    assert _bits_equal(x_gpu, x_cpu)


def test_launch_leaves_current_device(cuda):
    # the wrapper makes b's device current only for the launch
    plan = repro_torch.TriangularSolver.plan(
        narrow_band_lower(500, 0.14, 10, seed=4), device="cpu"
    ).exec_plan
    b = torch.ones(500)
    x_cpu = solve_with_plan(plan_arrays(plan, device="cpu"), b)
    for index in range(torch.cuda.device_count()):
        before = torch.cuda.current_device()
        dev = torch.device("cuda", index)
        x = solve_with_kernel_arrays(level_plan_arrays(plan, device=dev), b.to(dev))
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == before
        assert _bits_equal(x, x_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", ["er", "nb", "wide"])
def test_level_kernel_matches_level_ref_bitwise(cuda, gen, dtype):
    # "wide": levels of several thousand vertices, more than one block's threads
    L = {"er": lambda: erdos_renyi_lower(2000, 1e-3, seed=0),
         "nb": lambda: narrow_band_lower(2000, 0.14, 10, seed=0),
         "wide": lambda: erdos_renyi_lower(20000, 2e-5, seed=1)}[gen]()
    plan = repro_torch.TriangularSolver.plan(L, k=8, width=2, device="cpu").exec_plan
    b_pad = pad_rhs(torch.as_tensor(np.random.default_rng(3).standard_normal(L.n_rows), dtype=dtype))
    la_cpu = level_plan_arrays(plan, dtype=dtype, device="cpu")
    la = level_plan_arrays(plan, dtype=dtype, device=cuda)
    before = sptrsv.launches["single"]
    x = sptrsv.sptrsv_level_cuda(*la[:7], b_pad.to(cuda))
    torch.cuda.synchronize()
    assert sptrsv.launches["single"] == before + 1
    assert _bits_equal(x, sptrsv_level_ref(*la_cpu[:7], b_pad))
    assert _bits_equal(x, sptrsv_ref(*plan_arrays(plan, dtype=dtype, device="cpu")[:5], b_pad))


@pytest.mark.parametrize("m", [1, 5, 32, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_mrhs_kernel_matches_plain_bitwise(cuda, gen, dtype, m):
    # the m-RHS kernel: a block per column of the column-major copy of b
    # (m = 300: more column blocks than the card has SMs)
    L = (erdos_renyi_lower(2000, 1e-3, seed=0) if gen == "er"
         else narrow_band_lower(2000, 0.14, 10, seed=0))
    plan = repro_torch.TriangularSolver.plan(L, k=8, width=2, device="cpu").exec_plan
    b_pad = pad_rhs(torch.as_tensor(np.random.default_rng(m).standard_normal((2000, m)),
                                     dtype=dtype))
    la_cpu = level_plan_arrays(plan, dtype=dtype, device="cpu")
    la = level_plan_arrays(plan, dtype=dtype, device=cuda)
    before = dict(sptrsv.launches)
    x = sptrsv.sptrsv_level_cuda(*la[:7], b_pad.to(cuda))
    torch.cuda.synchronize()
    assert sptrsv.launches["mrhs"] == before["mrhs"] + 1
    assert sum(sptrsv.launches.values()) == sum(before.values()) + 1
    assert x.shape == (2001, m)
    assert bool((x[-1] == 0).all())  # the scratch row
    assert _bits_equal(x, sptrsv_level_ref(*la_cpu[:7], b_pad))
    assert _bits_equal(x, sptrsv_level_ref(*la[:7], b_pad.to(cuda)))


def test_level_wrapper_takes_both_shapes_on_card(cuda):
    # one right-hand side is the single-RHS kernel, m the column grid
    plan = repro_torch.TriangularSolver.plan(
        narrow_band_lower(500, 0.14, 10, seed=4), device="cpu"
    ).exec_plan
    la = level_plan_arrays(plan, device=cuda)
    b_pad = pad_rhs(torch.as_tensor(np.random.default_rng(0).standard_normal((500, 3)),
                                    dtype=torch.float32))
    before = dict(sptrsv.launches)
    x1 = sptrsv.sptrsv_level_cuda(*la[:7], b_pad[:, 0].contiguous().to(cuda))
    xm = sptrsv.sptrsv_level_cuda(*la[:7], b_pad.to(cuda))
    torch.cuda.synchronize()
    assert sptrsv.launches["single"] == before["single"] + 1
    assert sptrsv.launches["mrhs"] == before["mrhs"] + 1
    assert x1.shape == (501,) and xm.shape == (501, 3)
    assert _bits_equal(xm[:, 0], x1)
    assert _bits_equal(xm, sptrsv_ref(*plan_arrays(plan, device="cpu")[:5], b_pad))


def test_front_door_on_cuda(cuda):
    L = narrow_band_lower(3000, 0.14, 10, seed=3)
    gpu = repro_torch.TriangularSolver.plan(L)
    cpu = repro_torch.TriangularSolver.plan(L, device="cpu")
    assert gpu.device.type == "cuda" and gpu.backend == "kernel"
    B = np.random.default_rng(2).standard_normal((3000, 4))
    x = gpu.solve(B)
    assert x.device.type == "cuda"
    assert _bits_equal(x, cpu.solve(B))
    data = L.data * 1.25
    gpu.numeric_update(data)
    cpu.numeric_update(data)
    assert _bits_equal(gpu.solve(B[:, 0]), cpu.solve(B[:, 0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [None, 1, 5, 33])
@pytest.mark.parametrize("slack", [1, 3, 8])
@pytest.mark.parametrize("k,width", [(8, None), (32, 2)])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_elastic_kernel_matches_plain_bitwise(cuda, gen, k, width, slack, m, dtype):
    # the level walk over runs of slack supersteps: one block for b f[n+1]
    # (None), a block per column for b f[n+1, m]
    L = (erdos_renyi_lower(2000, 1e-3, seed=0) if gen == "er"
         else narrow_band_lower(2000, 0.14, 10, seed=0))
    plan = repro_torch.TriangularSolver.plan(L, k=k, width=width, device="cpu").exec_plan
    plan = dataclasses.replace(plan, elastic=elastic_transform(plan, slack))
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(2000 if m is None else (2000, m)), dtype=dtype)
    x_cpu = solve_with_plan(plan_arrays(plan, dtype=dtype, device="cpu"), b)
    la_cpu = elastic_kernel_arrays(plan, dtype=dtype, device="cpu")
    x_plain = solve_with_elastic_kernel_arrays(la_cpu, b)
    before = dict(sptrsv.launches)
    la = elastic_kernel_arrays(plan, dtype=dtype, device=cuda)
    x_gpu = solve_with_elastic_kernel_arrays(la, b.to(cuda))
    torch.cuda.synchronize()
    kind = "elastic_single" if m is None else "elastic_mrhs"
    assert sptrsv.launches[kind] == before[kind] + 1
    assert sum(sptrsv.launches.values()) == sum(before.values()) + 1
    assert _bits_equal(x_plain, x_cpu)
    assert _bits_equal(x_gpu, x_cpu)
    if slack == 1:  # the bulk level kernel's order: its bits, and its tensors
        for a, c in zip(la[:7], level_plan_arrays(plan, dtype=dtype, device=cuda)[:7]):
            assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [None, 2])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_spmv_kernel_matches_plain_bitwise(cuda, gen, width, dtype):
    # the whole product in one launch: bitwise its plain version on the
    # CPU and the padded-ELL definition (chains over every slot, the split
    # rows summed in piece order)
    L = (erdos_renyi_lower(3000, 2e-3, seed=5) if gen == "er"
         else narrow_band_lower(3000, 0.14, 10, seed=5))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lay = spmv.sliced_from_csr(L, width=width, dtype=np_dtype)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(3000), dtype=dtype)
    host = [torch.from_numpy(a) for a in lay[:4]]
    before = spmv.launches["spmv"]
    y = spmv.spmv_sliced_cuda(*(t.to(cuda) for t in host), lay.width, x.to(cuda))
    torch.cuda.synchronize()
    assert spmv.launches["spmv"] == before + 1
    assert y.device.type == "cuda" and y.shape == (3000,)
    assert _bits_equal(y, spmv_sliced_ref(*host, lay.width, x))
    col_idx, vals, row_map = spmv.ell_from_csr(L, width=width, dtype=np_dtype)
    assert _bits_equal(y, spmv_ell_rows_ref(torch.from_numpy(col_idx), torch.from_numpy(vals),
                                            torch.from_numpy(row_map), x))


def test_front_door_elastic_and_spmv_on_cuda(cuda):
    L = narrow_band_lower(3000, 0.14, 10, seed=3)
    gpu = repro_torch.TriangularSolver.plan(L, mode="elastic")
    cpu = repro_torch.TriangularSolver.plan(L, device="cpu")
    assert gpu.bound.backend == "kernel" and gpu.info()["mode"] == "elastic"
    B = np.random.default_rng(2).standard_normal((3000, 4))
    assert _bits_equal(gpu.solve(B), cpu.solve(B))
    data = L.data * 1.25
    gpu.numeric_update(data)
    cpu.numeric_update(data)
    assert _bits_equal(gpu.solve(B[:, 0]), cpu.solve(B[:, 0]))
    x = np.random.default_rng(3).standard_normal(3000)
    y = spmv.spmv(L, x, dtype=torch.float64)
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(), L.to_scipy() @ x, rtol=1e-12, atol=1e-12)


def _arrow(n=3000):
    """ER with three dense rows, which the default ELL width splits."""
    m = erdos_renyi_lower(n, 2e-3, seed=5)
    rows = [m.row_of_entry()] + [np.full(i, i) for i in (n // 3, n // 2, n - 1)]
    cols = [m.indices] + [np.arange(i) for i in (n // 3, n // 2, n - 1)]
    vals = np.random.default_rng(8).uniform(-1, 1, sum(len(c) for c in cols))
    return csr_from_coo(n, n, np.concatenate(rows), np.concatenate(cols), vals)


def _signed_zeros(n=3000, seed=11):
    """Rows whose chains reach -0 (-tiny times tiny underflows; a
    negative value times x = +0 keeps it there) or cancel to an exact zero
    (a value and its negation at columns 20 and 21, whose x the test sets
    equal), beside ordinary rows. x: +0 at columns 0-9, tiny at 10-19
    (1e-30: times these rows' -1e-300 the products underflow in float64,
    times the -1e-30 of the test's float32 rows in float32)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, n)
    kinds = rng.integers(0, 4, lens.sum())
    cols = np.where(kinds == 0, rng.integers(0, 10, kinds.size),
                    np.where(kinds == 1, rng.integers(10, 20, kinds.size),
                             np.where(kinds == 2, 20 + (np.arange(kinds.size) % 2),
                                      rng.integers(22, 30, kinds.size))))
    vals = np.where(kinds == 0, -rng.uniform(0.5, 2, kinds.size),
                    np.where(kinds == 1, -1e-300, np.where(cols == 20, 1.5, -1.5)))
    vals = np.where(kinds == 3, rng.uniform(-2, 2, kinds.size), vals)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    return CSRMatrix(n, 30, indptr, cols.astype(np.int64), vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", ["er", "nb", "poisson", "arrow", "signed_zeros"])
def test_ell_operator_matches_plain_bitwise(cuda, gen, dtype):
    # CG's matvec bound once on the card: one kernel launch per call, the
    # bits of the operator's plain version on the CPU and of the padded-ELL
    # definition (rows wider than W split, into many pieces on "arrow";
    # chains at -0 and exact zeros on "signed_zeros")
    L = {"er": lambda: erdos_renyi_lower(3000, 2e-3, seed=5),
         "nb": lambda: narrow_band_lower(3000, 0.14, 10, seed=5),
         "poisson": lambda: poisson2d_matrix(50), "arrow": _arrow,
         "signed_zeros": _signed_zeros}[gen]()
    x = np.random.default_rng(2).standard_normal(L.n_cols)
    if gen == "signed_zeros":
        x[:10], x[10:20], x[21] = 0.0, 1e-30, x[20]
        if dtype == torch.float32:  # -1e-30 * 1e-30 underflows in float32
            L = CSRMatrix(L.n_rows, L.n_cols, L.indptr, L.indices,
                          np.where(L.data == -1e-300, -1e-30, L.data))
    x = torch.as_tensor(x, dtype=dtype)
    op = spmv.EllOperator(L, dtype=dtype, device=cuda)
    op_cpu = spmv.EllOperator(L, dtype=dtype, device="cpu")
    before = spmv.launches["spmv"]
    xd = x.to(cuda)
    y = op(xd)
    y2 = op(xd)
    torch.cuda.synchronize()
    assert spmv.launches["spmv"] == before + 2
    assert y.device.type == "cuda" and _bits_equal(y, y2)
    assert _bits_equal(y, op_cpu(x))
    assert _bits_equal(y, spmv.spmv(L, x, dtype=dtype, device="cpu"))
    col_idx, vals, row_map = spmv.ell_from_csr(L, dtype=spmv.numpy_dtype(dtype))
    assert _bits_equal(y, spmv_ell_rows_ref(torch.from_numpy(col_idx), torch.from_numpy(vals),
                                            torch.from_numpy(row_map), x))
    split = bool((op.layout.row_len.cpu() > op.layout.width).any())
    assert split == (gen in ("er", "nb", "arrow"))  # the stencil's rows fit in W


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pcg_on_card_matches_cpu_plain(cuda, dtype):
    # the CG dots reduce in another order on the card (cuBLAS): float64
    # iteration counts equal, float32 within one, x within rtol 1e-3
    # (atol 1e-3 of max|x|); the launch counts are exact
    A = poisson2d_matrix(64)
    b = np.random.default_rng(0).standard_normal(A.n_rows)
    sptrsv.reset_launches()
    spmv.reset_launches()
    # GrowLocal, bulk: pcg_ichol's default "auto" picks elastic on this grid
    x, iters, relres, info = pcg_ichol(A, b, k=8, strategy="growlocal", tol=1e-6,
                                       maxiter=2000, dtype=dtype)
    torch.cuda.synchronize()
    # every factor solve is one launch of the ordered walk (the front door)
    assert dict(sptrsv.launches) == {**{k: 0 for k in sptrsv.launches},
                                     "ordered_single": 2 * (iters + 1)}
    assert spmv.launches == {"spmv": iters}
    # the CPU plain PCG: the kernels' plain versions (bitwise the scan's)
    xc, ic, rc, info_c = pcg_ichol(A, b, k=8, strategy="growlocal", tol=1e-6,
                                   maxiter=2000, dtype=dtype, device="cpu")
    assert x.device.type == "cuda" and x.dtype == dtype and relres < 1e-6 and rc < 1e-6
    assert abs(iters - ic) <= (0 if dtype == torch.float64 else 1), (iters, ic)
    xc = xc.double().numpy()
    np.testing.assert_allclose(x.cpu().double().numpy(), xc, rtol=1e-3,
                               atol=1e-3 * np.abs(xc).max())
    assert info["fwd_supersteps"] == info_c["fwd_supersteps"]


@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize("mode", ["bsp", "elastic"])
@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_solve_timed_on_card(cuda, backend, mode, m):
    # the kernel backend times its one launch with CUDA events; the scan
    # backend one segment per superstep or macro-step; both keep the bits
    L = narrow_band_lower(1500, 0.14, 10, seed=6)
    s = repro_torch.TriangularSolver.plan(L, backend=backend, mode=mode, timed=True)
    b = np.random.default_rng(1).standard_normal(1500 if m is None else (1500, m))
    before = dict(sptrsv.launches)
    x, steps = s.solve_timed(b)
    torch.cuda.synchronize()
    launched = sum(sptrsv.launches.values()) - sum(before.values())
    assert launched == (1 if backend == "kernel" else 0)
    assert steps and all(st["us"] > 0 for st in steps)
    if backend == "kernel":
        assert len(steps) == 1 and steps[0]["n_steps"] is None
        assert s.info()["binding"]["runtime"]["timed_solves"] == 1
    s.timed = False
    assert _bits_equal(x, s.solve(b))
    cpu = repro_torch.TriangularSolver.plan(L, device="cpu", backend="scan")
    assert _bits_equal(x, cpu.solve(b))


@pytest.mark.parametrize("m", [None, 5])
@pytest.mark.parametrize("gen", ["er", "nb"])
@pytest.mark.parametrize(
    "strategy", ["block", "funnel-gl", "growlocal", "hdagg", "serial", "spmp", "wavefront"])
def test_every_strategy_kernel_matches_plain_bitwise(cuda, strategy, gen, m):
    L = (erdos_renyi_lower(3000, 2e-3, seed=21) if gen == "er"
         else narrow_band_lower(3000, 0.14, 10, seed=22))
    gpu = repro_torch.TriangularSolver.plan(L, strategy=strategy)
    cpu = repro_torch.TriangularSolver.plan(L, strategy=strategy, device="cpu", backend="scan")
    assert gpu.strategy == strategy and gpu.n_supersteps == cpu.n_supersteps
    b = np.random.default_rng(6).standard_normal(3000 if m is None else (3000, m))
    sptrsv.reset_launches()
    x = gpu.solve(b)
    torch.cuda.synchronize()
    assert sptrsv.launches["ordered_single" if m is None else "ordered_mrhs"] == 1
    assert sum(sptrsv.launches.values()) == 1
    assert _bits_equal(x, cpu.solve(b))


@pytest.mark.parametrize("gen", ["er", "nb"])
def test_tune_on_card(cuda, gen):
    L = (erdos_renyi_lower(3000, 2e-3, seed=23) if gen == "er"
         else narrow_band_lower(3000, 0.14, 10, seed=24))
    cache = repro_torch.PlanCache()
    tuned = repro_torch.TriangularSolver.plan(L, strategy="auto", tune=True, cache=cache)
    sel = tuned.selection
    assert sel.tuned and tuned.device.type == "cuda"
    assert [s for s, _ in sel.timings] == [c.strategy for c in sel.candidates]
    assert sel.slack_timings is not None and all(sec > 0 for _, sec in sel.slack_timings)
    assert dict(sel.timings)[sel.strategy] == min(t for _, t in sel.timings)
    ref = repro_torch.TriangularSolver.plan(
        L, strategy=sel.strategy, options=sel.options, device="cpu", backend="scan")
    B = np.random.default_rng(7).standard_normal((3000, 4))
    assert _bits_equal(tuned.solve(B), ref.solve(B))
    again = repro_torch.TriangularSolver.plan(L, strategy="auto", tune=True, cache=cache)
    assert again is tuned
    assert cache.stats.selections == 1 and cache.stats.selection_hits == 1


# ------------------------------------------------------------ the bank kernel
def _bank_clones(gen, dtype, device, count=4):
    L = (erdos_renyi_lower(2000, 1e-3, seed=0) if gen == "er"
         else narrow_band_lower(2000, 0.14, 10, seed=0))
    s0 = repro_torch.TriangularSolver.plan(L, device=device, dtype=dtype)
    rng = np.random.default_rng(2)
    return [s0.clone_with_values(L.data * rng.uniform(0.5, 1.5, L.nnz)) for _ in range(count)]


@pytest.mark.parametrize("lanes", ["repeats", "all", "pow2_prefix"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_bank_kernel_matches_bank_ref_bitwise(cuda, gen, dtype, lanes):
    from repro_torch.kernels.ops import stack_level_bank
    from repro_torch.kernels.ref import sptrsv_level_bank_ref

    clones = _bank_clones(gen, dtype, cuda, count=3)  # 4 lanes, lane 3 = lane 0
    bank = stack_level_bank([c.bound._la for c in clones], [c._perm for c in clones],
                            [c._inv for c in clones])
    lane_idx = torch.tensor({"repeats": [2, 2, 0, 1, 0, 3, 1, 2], "all": [0, 1, 2, 3],
                             "pow2_prefix": [1, 0]}[lanes], dtype=torch.int32)
    m, n = lane_idx.shape[0], bank.n
    b_col = torch.as_tensor(np.random.default_rng(3).standard_normal((m, n + 1)), dtype=dtype)
    b_col[:, n] = 0
    cpu_bank = [t.cpu() for t in bank[:9]]
    x_cpu = sptrsv_level_bank_ref(*cpu_bank, lane_idx, b_col)
    before = sptrsv.launches["bank"]
    x_gpu = sptrsv.sptrsv_level_bank_cuda(*bank[:9], lane_idx, b_col.to(cuda))
    torch.cuda.synchronize()
    assert sptrsv.launches["bank"] == before + 1
    assert _bits_equal(x_gpu, x_cpu)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_bound_bank_solves_launch_the_bank_kernel(cuda, backend, monkeypatch):
    """On CUDA tensors the kernel bound's grouped, bank and resident
    solves launch the bank kernel once per call and never reach the plain
    executor (patched to raise); the scan bound is the plain executor,
    and the two agree bitwise."""
    from repro_torch.pipeline import GroupBank, grouped_solve
    from repro_torch.solver import executor

    clones = _bank_clones("er", torch.float32, cuda)
    if backend == "kernel":
        for name in ("solve_with_plan_group", "stack_plan_bank", "solve_with_bank",
                     "solve_resident"):
            def boom(*a, _name=name, **k):
                raise AssertionError(f"the kernel bound reached executor.{_name}")

            monkeypatch.setattr(executor, name, boom)
    else:
        clones = [repro_torch.TriangularSolver(
            exec_plan=c.exec_plan, total_perm=c._perm.cpu().numpy(), backend="scan",
            dtype=c.dtype, device=cuda, fingerprint=c.fingerprint, strategy=c.strategy,
            lower=True, inspector_seconds=0.0) for c in clones]
    n = clones[0].n
    rng = np.random.default_rng(4)
    B = rng.standard_normal((n, 4)).astype(np.float32)
    sptrsv.reset_launches()
    X = grouped_solve(clones, B)
    bank = GroupBank()
    for i, c in enumerate(clones):
        bank.add(i, c)
    keys = [3, 1, 1, 0, 2, 0, 3, 2]
    B8 = rng.standard_normal((n, 8)).astype(np.float32)
    Xb = bank.solve(keys, B8)
    cls = type(clones[0].bound)
    R = cls.blank_rhs(n, 8, torch.float32, cuda)
    for j in range(8):
        R = cls.insert_lane(R, j, B8[:, j])
    Xr = bank.solve_resident(keys[:4], R)
    torch.cuda.synchronize()
    want = {"kernel": 3, "scan": 0}[backend]
    assert sptrsv.launches["bank"] == want and sptrsv.launches["mrhs"] == 0
    for j, c in enumerate(clones):  # each column on its own plan
        assert _bits_equal(X[:, j], c.solve(B[:, j]))
    assert _bits_equal(Xr, Xb[:, :4])
    monkeypatch.undo()  # the CPU scan reference below runs the plain executor
    cpu = [repro_torch.TriangularSolver(
        exec_plan=c.exec_plan, total_perm=c._perm.cpu().numpy(), backend="scan",
        dtype=c.dtype, device=torch.device("cpu"), fingerprint=c.fingerprint,
        strategy=c.strategy, lower=True, inspector_seconds=0.0) for c in clones]
    cbank = GroupBank()
    for i, c in enumerate(cpu):
        cbank.add(i, c)
    assert _bits_equal(Xb, cbank.solve(keys, B8))


def test_serve_on_card_launches_the_bank_kernel(cuda):
    """Width-class and continuous serving on the card: banked traffic
    launches the bank kernel, every result bitwise its replay."""
    from repro_torch.serve import SolveService, direct_reference, width_class_patterns

    for kw in ({"width_class_batching": True, "max_wait_us": 200_000}, {"mode": "continuous"}):
        sptrsv.reset_launches()
        with SolveService(strategy="wavefront", max_batch=8, **kw) as svc:
            pats = width_class_patterns(svc, 4, n=2000, seed=5)
            rng = np.random.default_rng(6)
            tickets = []
            for i in range(8):
                fp, n = pats[i % 4]
                b = rng.standard_normal(n).astype(np.float32)
                tickets.append((svc.submit(fp, b), b))
            served = [(t, b, t.result(timeout=120)) for t, b in tickets]
            snap = svc.stats()
            launches = dict(sptrsv.launches)  # the serving's, before the replays
            for t, b, x in served:
                assert np.array_equal(
                    x, direct_reference(t.served_by, b, t.batch_width, t.batch_position))
        # a grouped batch or a pass is one bank launch; a homogeneous batch
        # takes the front door's ordered m-RHS walk
        banked = snap["grouped_batches"] + snap["slots"]["passes"]
        assert launches["bank"] == banked > 0, (kw, launches, snap["batches"])
        assert launches["ordered_mrhs"] == snap["batches"] - banked, (kw, launches)


# ------------------------------------------- the staged walk, every entry
def _wide_vertex_levels(dtype, device, K=40_000):
    """Level tensors with a vertex wider than any stage: level 0 finishes
    rows 0 .. K-1, one step each reading the scratch slot; level 1
    finishes row K with one vertex of K lane-steps (W = 1) that reads
    every row of level 0."""
    n = K + 1
    rng = np.random.default_rng(21)
    p = np.arange(2 * K)
    row_ids = np.where(p < K, p, K)
    col_idx = np.where(p < K, n, p - K)[:, None]
    vals = np.where(p < K, 0.0, rng.uniform(-1, 1, 2 * K))[:, None]
    diag = rng.uniform(0.5, 2, 2 * K)
    accum = np.where(p < K, False, p < 2 * K - 1)
    vert_ptr = np.append(np.arange(K + 1), 2 * K)
    level_ptr = np.array([0, K, K + 1])

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return LevelArrays(
        row_ids=put(row_ids, torch.int32), col_idx=put(col_idx, torch.int32),
        vals=put(vals, dtype), diag=put(diag, dtype), accum=put(accum, torch.bool),
        vert_ptr=put(vert_ptr, torch.int32), level_ptr=put(level_ptr, torch.int32),
        perm=put(p, torch.int64), n=n,
        chunks=sptrsv.device_chunks(levels.level_chunks(vert_ptr, level_ptr, 1, dtype.itemsize),
                                    device))


def _walk_entries_match_plain(la_cpu, la, cuda, dtype):
    """Every entry of the level walk on ``la`` (on the card, its bound
    chunk table) against the plain version on ``la_cpu``, bitwise: one and
    five right-hand sides, range launches over two ranges, the elastic
    entries on the same tensors, a bank of two lanes (the plan and its
    values halved), and the ordered entries under a random row order."""
    n, L = la.n, la.level_ptr.numel() - 1
    rng = np.random.default_rng(22)
    for m in (None, 5):
        b_pad = pad_rhs(torch.as_tensor(
            rng.standard_normal(n if m is None else (n, m)), dtype=dtype))
        x_ref = sptrsv_level_ref(*la_cpu[:7], b_pad)
        b = b_pad.to(cuda)
        for fn in (sptrsv.sptrsv_level_cuda, sptrsv.sptrsv_elastic_cuda):
            assert _bits_equal(fn(*la[:7], b, chunks=la.chunks), x_ref)
        b_r = b if m is None else b.T.contiguous()
        x_r = torch.zeros_like(b_r)
        for lo, hi in ((0, L // 2), (L // 2, L)):
            sptrsv.sptrsv_level_range_cuda(*la[:7], lo, hi, b_r, x_r, chunks=la.chunks)
        assert _bits_equal(x_r if m is None else x_r.T, x_ref)
    rows = torch.arange(n)
    las = [la, la._replace(vals=la.vals * 0.5)]
    bank = stack_level_bank(las, [rows.to(cuda)] * 2, [rows.to(cuda)] * 2)
    cpu_bank = stack_level_bank([la_cpu, la_cpu._replace(vals=la_cpu.vals * 0.5)],
                                [rows] * 2, [rows] * 2)
    lane_idx = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    b_col = torch.as_tensor(rng.standard_normal((4, n + 1)), dtype=dtype)
    b_col[:, n] = 0
    x_cpu = sptrsv_level_bank_ref(*cpu_bank[:9], lane_idx, b_col)
    x_gpu = sptrsv.sptrsv_level_bank_cuda(*bank[:9], lane_idx, b_col.to(cuda),
                                          chunks=bank.chunks)
    assert _bits_equal(x_gpu, x_cpu)
    # the ordered solve, bulk and elastic kinds, under a random row order:
    # b and x in the caller's order, one column, five and 40 (a second tile
    # of columns)
    perm = torch.as_tensor(rng.permutation(n))
    for m in (None, 5, 40):
        b = torch.as_tensor(rng.standard_normal(n if m is None else (n, m)), dtype=dtype)
        x_ref = sptrsv_ordered_ref(*la_cpu[:7], perm, b)
        for elastic in (False, True):
            x = sptrsv.sptrsv_ordered_cuda(ordered_walk(la, perm, elastic=elastic), b.to(cuda))
            assert _bits_equal(x, x_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["wide_levels", "small_stages", "wide_vertex"])
def test_every_walk_entry_staged_matches_plain_bitwise(cuda, monkeypatch, layout, dtype):
    """"wide_levels": levels of several thousand vertices, each several
    chunks; "small_stages": two stages of 2 KB, chunks cut by bytes and the
    dense rows' vertices read in place; "wide_vertex": one vertex wider
    than a stage at the card's budget, beside staged chunks."""
    if layout == "wide_vertex":
        la_cpu, la = (_wide_vertex_levels(dtype, d) for d in ("cpu", cuda))
    else:
        if layout == "small_stages":
            monkeypatch.setattr(levels, "SMEM_BYTES", 2 * (levels.STAGE_HEAD_BYTES + 4 * 1024))
        L = erdos_renyi_lower(20000, 2e-5, seed=1) if layout == "wide_levels" else _arrow()
        plan = repro_torch.TriangularSolver.plan(L, k=8, width=2, device="cpu").exec_plan
        la_cpu = level_plan_arrays(plan, dtype=dtype, device="cpu")
        la = level_plan_arrays(plan, dtype=dtype, device=cuda)
    st = la.chunks.stats()
    split = (np.diff(la.chunks.level_chunk.cpu().numpy()) > 1).any()
    assert split or layout == "wide_vertex"
    if layout == "wide_levels":
        assert st["chunks_staged"] == st["chunks"]
    else:  # some chunks take the fallback, the others are staged
        assert 0 < st["chunks_staged"] < st["chunks"]
    _walk_entries_match_plain(la_cpu, la, cuda, dtype)


# ------------------------------------------- the front door's ordered walk
def _front_door_solver(gen, mode, dtype, device):
    kw = dict(device=device, dtype=dtype, mode=mode, slack=3 if mode == "elastic" else 0)
    if gen.startswith("poisson"):
        fwd, bwd = repro_torch.factor_pair(ichol0(poisson2d_matrix(48)), **kw)
        return fwd if gen == "poisson_fwd" else bwd
    L = (erdos_renyi_lower(3000, 1e-3, seed=8) if gen == "er"
         else narrow_band_lower(3000, 0.14, 10, seed=9))
    return repro_torch.TriangularSolver.plan(L, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [None, 32])
@pytest.mark.parametrize("mode", ["bsp", "elastic"])
@pytest.mark.parametrize("gen", ["er", "nb", "poisson_fwd", "poisson_bwd"])
def test_ordered_solve_is_permute_kernel_unpermute_bitwise(cuda, gen, mode, m, dtype):
    """The front door's one launch against the path it replaces: b gathered
    into plan row order, the unordered kernel, x gathered back."""
    s = _front_door_solver(gen, mode, dtype, cuda)
    assert s.info()["binding"]["front_door"] == "ordered"
    b = torch.as_tensor(np.random.default_rng(10).standard_normal(
        s.n if m is None else (s.n, m)), dtype=dtype, device=cuda)
    sptrsv.reset_launches()
    x = s.solve(b)
    torch.cuda.synchronize()
    kind = ("elastic_" if mode == "elastic" else "") + (
        "ordered_single" if m is None else "ordered_mrhs")
    assert {k: v for k, v in sptrsv.launches.items() if v} == {kind: 1}
    x_gather = s.bound.solve(b[s._perm])[s._inv]
    assert x.shape == b.shape and _bits_equal(x, x_gather)
    la = s.bound._la
    assert _bits_equal(x, sptrsv_ordered_ref(*(t.cpu() for t in la[:7]), s._perm.cpu(), b.cpu()))


@pytest.mark.parametrize("m", [None, 32])
def test_front_door_solve_is_one_device_operation(cuda, m):
    """Under torch.profiler a solve is the ordered solve's one launch: no
    gather, padding, fill or copy."""
    from torch.profiler import ProfilerActivity, profile

    s = _front_door_solver("er", "bsp", torch.float32, cuda)
    b = torch.randn(s.n if m is None else (s.n, m), device=cuda)
    s.solve(b)
    torch.cuda.synchronize()
    solves = 4
    sptrsv.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(solves):
            s.solve(b)
        torch.cuda.synchronize()
    events = prof.events()
    # the runtime's launches and copies: one cooperative launch a solve
    api = [e.name for e in events if e.name.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset"))]
    assert api == ["cudaLaunchCooperativeKernel"] * solves, api
    # the device's operations: the ordered solve's kernel alone (the profiler
    # may drop a record now and then, so at most one a solve)
    ops_ = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(ops_) <= solves and all("sptrsv_level_ordered_kernel" in o for o in ops_), ops_
    assert sptrsv.launches["ordered_single" if m is None else "ordered_mrhs"] == solves


def test_front_door_past_the_resident_blocks_gathers(cuda):
    """More right-hand sides than the card holds blocks of the ordered
    solve at once: the gather path, one launch of the m-RHS walk."""
    s = _front_door_solver("er", "bsp", torch.float32, cuda)
    m = sptrsv.ordered_columns(s.bound._walk) + 1
    B = torch.randn(s.n, m, device=cuda)
    sptrsv.reset_launches()
    x = s.solve(B)
    torch.cuda.synchronize()
    assert {k: v for k, v in sptrsv.launches.items() if v} == {"mrhs": 1}
    assert _bits_equal(x, s.bound.solve(B[s._perm])[s._inv])


def test_front_door_solves_do_not_alias(cuda):
    s = _front_door_solver("nb", "bsp", torch.float32, cuda)
    rng = np.random.default_rng(11)
    b1, b2 = (torch.as_tensor(rng.standard_normal(s.n), dtype=torch.float32, device=cuda)
              for _ in range(2))
    x1 = s.solve(b1)
    kept = x1.clone()
    x2 = s.solve(b2)
    x1_again = s.solve(b1)
    torch.cuda.synchronize()
    assert len({x1.data_ptr(), x2.data_ptr(), x1_again.data_ptr()}) == 3
    assert _bits_equal(x1, kept) and _bits_equal(x1_again, kept)
    assert not _bits_equal(x2, kept)


def test_front_door_solves_on_two_streams_at_once(cuda):
    """Two solvers' ordered solves, each launch a grid of up to 128 blocks
    that hold their SMs until the walk ends, queued on two streams at once:
    each launch waits for room on the card, none deadlocks, and every
    answer is the one a lone solve gives."""
    import time

    solvers = [_front_door_solver("er", "bsp", torch.float32, cuda),
               _front_door_solver("nb", "elastic", torch.float64, cuda)]
    rng = np.random.default_rng(12)
    rhs = [torch.as_tensor(rng.standard_normal((s.n, m)), dtype=s.dtype, device=cuda)
           for s, m in zip(solvers, (32, 1))]
    alone = [s.solve(b) for s, b in zip(solvers, rhs)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in solvers]
    outs = [[], []]
    for _ in range(20):
        for i, (s, b, st) in enumerate(zip(solvers, rhs, streams)):
            with torch.cuda.stream(st):
                outs[i].append(s.solve(b))
    done = [torch.cuda.Event() for _ in streams]
    for ev, st in zip(done, streams):
        ev.record(st)
    deadline = time.monotonic() + 60.0
    while not all(ev.query() for ev in done):
        assert time.monotonic() < deadline, "solves on two streams did not finish in 60 s"
        time.sleep(0.01)
    for x_alone, xs in zip(alone, outs):
        assert all(_bits_equal(x, x_alone) for x in xs)
