"""The CUDA kernels (bulk SpTRSV, the level walk of the bulk order for one
RHS and, a block per column, for m RHS; elastic SpTRSV, the level walk over
runs of supersteps for one and m RHS; SpMV, and SpMV bound once as CG's
matvec) against their plain versions, on the card; IC(0)-preconditioned CG
on the card against the CPU plain PCG, and timed solves on the card.

Marked ``cuda``: every test here skips on a host without a CUDA device (it
adds no pass there). On the card run it with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

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
from repro_torch.kernels import spmv, sptrsv
from repro_torch.kernels.ops import (
    elastic_kernel_arrays,
    level_plan_arrays,
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
)
from repro_torch.kernels.ref import (
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
    x, iters, relres, info = pcg_ichol(A, b, k=8, tol=1e-6, maxiter=2000, dtype=dtype)
    torch.cuda.synchronize()
    assert dict(sptrsv.launches) == {"single": 2 * (iters + 1), "mrhs": 0,
                                     "elastic_single": 0, "elastic_mrhs": 0}
    assert spmv.launches == {"spmv": iters}
    # the CPU plain PCG: the kernels' plain versions (bitwise the scan's)
    xc, ic, rc, info_c = pcg_ichol(A, b, k=8, tol=1e-6, maxiter=2000, dtype=dtype,
                                   device="cpu")
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
