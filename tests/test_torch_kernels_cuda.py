"""The CUDA kernels (bulk and elastic SpTRSV, SpMV) against their plain
versions, on the card.

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
    kernel_plan_arrays,
    solve_with_elastic_kernel_arrays,
    solve_with_kernel_arrays,
)
from repro_torch.kernels.ref import spmv_ell_ref
from repro_torch.solver.executor import plan_arrays, solve_with_plan
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

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
    x_gpu = solve_with_kernel_arrays(
        kernel_plan_arrays(plan, dtype=dtype, device=cuda), b.to(cuda)
    )
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
        x = solve_with_kernel_arrays(kernel_plan_arrays(plan, device=dev), b.to(dev))
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == before
        assert _bits_equal(x, x_cpu)


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
@pytest.mark.parametrize("m", [None, 5, 64])
@pytest.mark.parametrize("k,width,slack", [(8, None, 8), (32, 2, 1), (8, 2, 3)])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_elastic_kernel_matches_plain_bitwise(cuda, gen, k, width, slack, m, dtype):
    L = (erdos_renyi_lower(2000, 1e-3, seed=0) if gen == "er"
         else narrow_band_lower(2000, 0.14, 10, seed=0))
    plan = repro_torch.TriangularSolver.plan(L, k=k, width=width, device="cpu").exec_plan
    plan = dataclasses.replace(plan, elastic=elastic_transform(plan, slack))
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(2000 if m is None else (2000, m)), dtype=dtype)
    x_cpu = solve_with_plan(plan_arrays(plan, dtype=dtype, device="cpu"), b)
    x_plain = solve_with_elastic_kernel_arrays(
        *elastic_kernel_arrays(plan, dtype=dtype, device="cpu"), b
    )
    before = dict(sptrsv.launches)
    x_gpu = solve_with_elastic_kernel_arrays(
        *elastic_kernel_arrays(plan, dtype=dtype, device=cuda), b.to(cuda)
    )
    torch.cuda.synchronize()
    kind = "elastic_single" if m is None else "elastic_mrhs"
    assert sptrsv.launches[kind] == before[kind] + 1
    assert _bits_equal(x_plain, x_cpu)
    assert _bits_equal(x_gpu, x_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [None, 2])
@pytest.mark.parametrize("gen", ["er", "nb"])
def test_spmv_kernel_matches_plain_bitwise(cuda, gen, width, dtype):
    L = (erdos_renyi_lower(3000, 2e-3, seed=5) if gen == "er"
         else narrow_band_lower(3000, 0.14, 10, seed=5))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    col_idx, vals, _ = spmv.ell_from_csr(L, width=width, dtype=np_dtype)
    x_pad = torch.as_tensor(
        np.append(np.random.default_rng(2).standard_normal(3000), 0.0), dtype=dtype
    )
    c, v = torch.from_numpy(col_idx), torch.from_numpy(vals)
    before = spmv.launches["spmv"]
    y = spmv.spmv_cuda(c.to(cuda), v.to(cuda), x_pad.to(cuda))
    torch.cuda.synchronize()
    assert spmv.launches["spmv"] == before + 1
    assert _bits_equal(y, spmv_ell_ref(c, v, x_pad))


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
