"""The distributed solves on the card: range launches of the level kernel
(``kernels.sptrsv.sptrsv_level_range_cuda``) and distributed binds on
meshes whose positions share ``cuda:0``, against the same on the CPU, bit
for bit.

Marked ``cuda``: every test here skips on a host without a CUDA device (it
adds no pass there). On the card run it with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_distributed_cuda.py

``chip_smoke.py``'s ``distributed`` phase makes the same comparisons at
the main path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch import TriangularSolver
from repro_torch.backends import get_backend
from repro_torch.kernels import sptrsv
from repro_torch.kernels.ops import level_plan_arrays
from repro_torch.mesh import make_mesh
from repro_torch.solver.executor import pad_rhs
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

pytestmark = pytest.mark.cuda

_TORCH = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits_equal(a, b) -> bool:
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def _plan(name, k=8):
    L = {"er": lambda: erdos_renyi_lower(3000, 1e-3, seed=1),
         "nb": lambda: narrow_band_lower(3000, 0.14, 10, seed=2)}[name]()
    return TriangularSolver.plan(L, k=k, device="cpu").exec_plan


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["er", "nb"])
def test_range_launches_bitwise_cpu(cuda, name, dtype):
    plan = _plan(name)
    la_cpu = level_plan_arrays(plan, dtype=_TORCH[dtype], device="cpu")
    la_gpu = level_plan_arrays(plan, dtype=_TORCH[dtype], device=cuda)
    L = la_cpu.level_ptr.numel() - 1
    rng = np.random.default_rng(3)
    for m in (None, 5):
        b = torch.as_tensor(rng.standard_normal(plan.n if m is None else (plan.n, m)),
                            dtype=_TORCH[dtype])
        b_pad = pad_rhs(b) if m is None else pad_rhs(b).T.contiguous()
        for cuts in ([0, L], [0, L // 2, L], list(range(0, L + 1, max(L // 7, 1))) + [L]):
            cuts = sorted(set(cuts))
            outs = []
            for la, dev in ((la_cpu, "cpu"), (la_gpu, cuda)):
                bb = b_pad.to(dev)
                x = torch.zeros_like(bb)
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    sptrsv.sptrsv_level_range_cuda(*la[:7], lo, hi, bb, x)
                outs.append(x)
            torch.cuda.synchronize()
            assert _bits_equal(outs[1], outs[0]), (m, cuts)
    full = sptrsv.sptrsv_level_cuda(*la_gpu[:7], pad_rhs(b[:, 0].contiguous()).to(cuda))
    x = torch.zeros_like(full)
    sptrsv.reset_launches()
    sptrsv.sptrsv_level_range_cuda(*la_gpu[:7], 0, L, pad_rhs(b[:, 0].contiguous()).to(cuda), x)
    sptrsv.sptrsv_level_range_cuda(*la_gpu[:7], L, L, pad_rhs(b[:, 0].contiguous()).to(cuda), x)
    torch.cuda.synchronize()
    assert sptrsv.launches["range_single"] == 1  # an empty range launches nothing
    assert _bits_equal(x, full)


@pytest.mark.parametrize("shard,shape", [("rows", (1, 8)), ("rows", (2, 4)),
                                         ("model", (1, 8)), ("model", (2, 8))])
@pytest.mark.parametrize("name", ["er", "nb"])
def test_distributed_bind_on_card_bitwise_cpu(cuda, monkeypatch, name, shard, shape):
    plan = _plan(name)
    gpu_mesh = make_mesh(shape, devices=cuda)
    cpu_mesh = make_mesh(shape, devices="cpu")
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.standard_normal(plan.n), dtype=torch.float32)
    B = torch.as_tensor(rng.standard_normal((plan.n, 6)), dtype=torch.float32)
    be = get_backend("distributed")
    for slack in (0, 8):
        cpu = be.bind(plan, device="cpu", mesh=cpu_mesh, shard=shard, slack=slack)
        gpu = be.bind(plan, mesh=gpu_mesh, shard=shard, slack=slack)
        assert gpu.describe()["exchange"] == cpu.describe()["exchange"]
        # a mesh on the card never runs the plain version
        with monkeypatch.context() as mp:
            mp.setattr(sptrsv, "sptrsv_level_range_ref", None)
            sptrsv.reset_launches()
            x, X = gpu.solve(b.to(cuda)), gpu.solve(B.to(cuda))
            xt, steps = gpu.solve_timed(b.to(cuda))
            torch.cuda.synchronize()
        rounds = gpu.describe()["exchange"]["rounds"]
        assert len(steps) == rounds
        busy = sum(s["launches"] for s in steps)
        assert sptrsv.launches["range_single"] == 2 * busy
        assert sptrsv.launches["range_mrhs"] == busy * shape[0]  # every data row
        assert _bits_equal(x, cpu.solve(b)) and _bits_equal(X, cpu.solve(B))
        assert _bits_equal(xt, x)
        data = np.random.default_rng(5).uniform(0.5, 2.0, gpu.n_entries)
        assert _bits_equal(gpu.update_values(data).solve(b.to(cuda)),
                           cpu.update_values(data).solve(b))
