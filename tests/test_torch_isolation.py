"""The port stands alone: it imports neither JAX nor the JAX package, runs
with JAX blocked, never drops silently to the CPU, and leaves the kernel
launch counters alone when its kernels' plain versions run."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import backends
from repro_torch.backends import get_backend
from repro_torch.core import elastic_transform
from repro_torch.kernels import build, spmv, sptrsv
from repro_torch.kernels.ops import (
    bind_kernel_solver,
    elastic_kernel_arrays,
    kernel_plan_arrays,
    level_plan_arrays,
)
from repro_torch.kernels.ref import sptrsv_ref
from repro_torch.solver.executor import (
    elastic_plan_arrays,
    make_solver,
    pad_rhs,
    plan_arrays,
)
from repro_torch.sparse import erdos_renyi_lower

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_or_repro_imports_in_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []


def test_chip_smoke_imports_no_jax_or_repro():
    mods = list(_imports(REPO / "chip_smoke.py"))
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]


_BLOCKED = r"""
import sys
sys.modules["jax"] = None
import numpy as np
import repro_torch
from repro_torch.sparse import narrow_band_lower
L = narrow_band_lower(300, 0.14, 10, seed=1)
s = repro_torch.TriangularSolver.plan(L, device="cpu")
x = s.solve(np.ones(300)).numpy()
assert np.isfinite(x).all()
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert loaded == [], loaded
print("ok")
"""


def test_import_and_solve_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_plan_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L = erdos_renyi_lower(50, 0.05, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.TriangularSolver.plan(L)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.TriangularSolver.plan(L, mode="elastic")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.factor_pair(L)


def _bind_kernel(plan):
    return get_backend("kernel").bind(plan)


def _bind_scan(plan):
    return get_backend("scan").bind(plan)


def _registry_bind(plan):
    return backends.bind("kernel", plan)


def _kernel_plan_arrays(plan):
    return kernel_plan_arrays(plan)


def _level_plan_arrays(plan):
    return level_plan_arrays(plan)


def _bind_kernel_solver(plan):
    return bind_kernel_solver(plan)


def _elastic_plan_arrays(plan):
    return elastic_plan_arrays(plan, slack=4)


def _elastic_kernel_arrays(plan):
    return elastic_kernel_arrays(
        dataclasses.replace(plan, elastic=elastic_transform(plan, 4))
    )


def _bind_kernel_elastic(plan):
    return get_backend("kernel").bind(plan, slack=4)


def _bind_scan_elastic(plan):
    return backends.bind("scan", plan, slack=4)


def _spmv(plan):
    return spmv.spmv(erdos_renyi_lower(plan.n, 0.05, seed=0), np.ones(plan.n))


@pytest.mark.parametrize(
    "entry",
    [_bind_kernel, _bind_scan, _registry_bind, plan_arrays, make_solver,
     _kernel_plan_arrays, _level_plan_arrays, _bind_kernel_solver, _elastic_plan_arrays,
     _elastic_kernel_arrays, _bind_kernel_elastic, _bind_scan_elastic, _spmv],
)
def test_lower_entry_points_without_device_raise_without_cuda(monkeypatch, entry):
    # every entry point that places tensors defaults to the card
    plan = repro_torch.TriangularSolver.plan(
        erdos_renyi_lower(50, 0.05, seed=0), device="cpu"
    ).exec_plan
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(plan)


def test_sptrsv_cuda_on_cpu_takes_plain_path():
    L = erdos_renyi_lower(120, 0.05, seed=2)
    solver = repro_torch.TriangularSolver.plan(L, device="cpu")
    elastic = repro_torch.TriangularSolver.plan(L, device="cpu", mode="elastic")
    la = level_plan_arrays(solver.exec_plan, device="cpu")
    sptrsv.reset_launches()
    spmv.reset_launches()
    b1 = pad_rhs(torch.ones(120))
    bm = pad_rhs(torch.ones(120, 3))
    x1 = sptrsv.sptrsv_level_cuda(*la[:7], b1)
    xm = sptrsv.sptrsv_level_cuda(*la[:7], bm)
    solver.solve(np.ones(120))
    assert torch.equal(elastic.solve(np.ones((120, 3))), solver.solve(np.ones((120, 3))))
    spmv.spmv(L, np.ones(120), device="cpu")
    assert set(sptrsv.launches) == {"single", "mrhs", "elastic_single", "elastic_mrhs"}
    assert not any(sptrsv.launches.values()) and spmv.launches == {"spmv": 0}
    assert torch.equal(xm[:, 0], x1)
    pa = plan_arrays(solver.exec_plan, device="cpu")
    assert torch.equal(x1, sptrsv_ref(*pa[:5], b1)) and torch.equal(xm, sptrsv_ref(*pa[:5], bm))
    assert not build._LIBS  # nothing was built or loaded


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_library_path_tracks_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    p1 = build.library_path(src)
    src.write_text("// b\n")
    assert build.library_path(src) != p1
    assert p1.parent == REPO / "build" / "repro_torch"


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_use_their_own_registry():
    from repro_torch.backends import available_backends

    assert set(available_backends()) == {"kernel", "scan"}
    assert repro_torch.TriangularSolver.plan.__kwdefaults__["backend"] == "kernel"
    assert repro_torch.TriangularSolver.plan.__kwdefaults__["device"] is None
