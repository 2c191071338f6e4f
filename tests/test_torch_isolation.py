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
from repro_torch.kernels import build, ops, spmv, sptrsv
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import (
    bind_kernel_solver,
    elastic_kernel_arrays,
    level_plan_arrays,
    level_sources,
)
from repro_torch.kernels.ref import sptrsv_ref
from repro_torch.solver.executor import (
    elastic_plan_arrays,
    make_solver,
    pad_rhs,
    plan_arrays,
)
from repro_torch.solver import cg_solve, pcg_ichol
from repro_torch.sparse import erdos_renyi_lower, poisson2d_matrix

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
    scanned = {f.relative_to(PKG).parts[0] for f in files}
    assert {"serve", "launch", "analysis", "models", "configs"} <= scanned  # the LM stack too
    assert {"train", "data", "checkpoint", "distributed"} <= scanned  # and its training
    assert len([f for f in files if f.parent.name == "analysis"]) >= 9
    assert len([f for f in files if f.parent.name == "serve"]) >= 7
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


def test_torch_examples_import_no_jax_or_repro():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert examples
    for path in examples:
        mods = list(_imports(path))
        assert "repro_torch" in {m.split(".")[0] for m in mods}, path.name
        assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")], path.name


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
import repro_torch.launch.solver_serve
from repro_torch.serve import SolveService, direct_reference
from repro_torch.sparse import shifted_coupling_lower
with SolveService(mode="continuous", strategy="wavefront", device="cpu") as svc:
    fp = svc.register(shifted_coupling_lower(96, 0, seed=1))
    t = svc.submit(fp, np.ones(96))
    y = t.result(timeout=60)
    assert np.array_equal(y, direct_reference(t.served_by, np.ones(96), t.batch_width,
                                              t.batch_position))
    assert svc.stats()["slots"]["passes"] == 1
import repro_torch.analysis.mutate, repro_torch.launch.check, repro_torch.launch.check_overhead
from repro_torch.core import partition_plan
for mode in ("bsp", "elastic"):
    sv = repro_torch.TriangularSolver.plan(L, device="cpu", validate="full", mode=mode)
    assert np.array_equal(sv.solve(np.ones(300)).numpy(), x)
assert repro_torch.launch.check.main(["--smoke", "--no-lint"]) == 0
assert partition_plan(sv.exec_plan, 4).n_shards == 4
import torch
import repro_torch.launch.serve
from repro_torch.configs import get_reduced
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import decode_step, init_params, param_specs, prefill
cfg = get_reduced("granite_3_2b")
params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
logits, cache, pos = prefill(cfg, params, make_train_batch(cfg, batch=2, seq_len=16, device="cpu"),
                             max_len=17)
logits, cache = decode_step(cfg, params, cache, pos, logits[:, :cfg.vocab_size].argmax(-1))
assert logits.shape == (2, cfg.padded_vocab) and torch.isfinite(logits).all()
import tempfile
import repro_torch.launch.train
from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import compressed_grad_transform, init_error_buffers
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import init_train_state
state = init_train_state(cfg, params)
step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1), microbatches=2,
                       grad_transform=compressed_grad_transform({"e": init_error_buffers(params)}))
data = SyntheticLMData(vocab=cfg.vocab_size, batch=2, seq=16, device="cpu")
state, metrics = step(state, data.batch_at(0))
assert torch.isfinite(metrics["loss"]) and int(state.opt_state["step"]) == 1
with tempfile.TemporaryDirectory() as tmp:
    ck = AsyncCheckpointer(tmp)
    ck.save(state, step=1)
    ck.wait()
    back, meta = restore_checkpoint(ck.latest(), template=state, device="cpu")
assert meta["step"] == 1 and torch.equal(back.params["embed"], state.params["embed"])
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


def _level_sources(plan):
    return level_sources(plan, level_order(plan))


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


def _ell_operator(plan):
    return spmv.EllOperator(erdos_renyi_lower(plan.n, 0.05, seed=0))


def _cg_solve(plan):
    A = poisson2d_matrix(5)
    return cg_solve(A, np.ones(A.n_rows))


def _pcg_ichol(plan):
    A = poisson2d_matrix(5)
    return pcg_ichol(A, np.ones(A.n_rows))


def _serve_register(plan):
    from repro_torch.serve import SolveService

    with SolveService(strategy="growlocal") as svc:
        return svc.register(erdos_renyi_lower(plan.n, 0.05, seed=0))


def _make_mesh(plan):
    from repro_torch.mesh import make_mesh

    return make_mesh((1, 2))


def _bind_distributed_on_card_mesh(plan):
    from repro_torch.mesh import make_mesh

    return get_backend("distributed").bind(plan, mesh=make_mesh((1, 1), devices="cuda"))


def _serve_cli(plan):
    from repro_torch.launch import solver_serve

    return solver_serve.main(["--mix", "width", "--strategy", "wavefront", "--requests", "1"])


def _lm_init_params(plan):
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params, param_specs

    return init_params(param_specs(get_reduced("granite_3_2b")), torch.Generator())


def _lm_batch(plan):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.inputs import make_train_batch

    return make_train_batch(get_reduced("granite_3_2b"), batch=1, seq_len=4)


def _lm_decode_cache(plan):
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_decode_cache

    return init_decode_cache(get_reduced("granite_3_2b"), 1, 4)


def _lm_params_from_numpy(plan):
    from repro_torch.configs import get_reduced
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_map

    cfg = get_reduced("granite_3_2b")
    return lm_params_from_numpy(cfg, tree_map(lambda s: np.zeros(s.shape), param_specs(cfg)))


def _lm_serve_cli(plan):
    from repro_torch.launch import serve

    return serve.main(["--arch", "granite_3_2b"])


def _lm_train_cli(plan):
    from repro_torch.launch import train

    return train.main(["--arch", "granite_3_2b", "--steps", "1"])


def _synthetic_data(plan):
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(vocab=10, batch=1, seq=4).batch_at(0)


def _restore_checkpoint(plan):
    from repro_torch.checkpoint import restore_checkpoint

    # the device is resolved before the checkpoint is read
    return restore_checkpoint("no-such-checkpoint")


def _train_state_from_numpy(plan):
    from repro_torch.configs import get_reduced
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_map

    cfg = get_reduced("granite_3_2b")
    zeros = tree_map(lambda s: np.zeros(s.shape, np.float32), param_specs(cfg))
    return train_state_from_numpy(cfg, {"params": zeros, "opt_state": {
        "mu": zeros, "nu": zeros, "step": np.int32(0)}})


@pytest.mark.parametrize(
    "entry",
    [_bind_kernel, _bind_scan, _registry_bind, plan_arrays, make_solver,
     _level_sources, _level_plan_arrays, _bind_kernel_solver, _elastic_plan_arrays,
     _elastic_kernel_arrays, _bind_kernel_elastic, _bind_scan_elastic, _spmv,
     _ell_operator, _cg_solve, _pcg_ichol, _serve_register, _serve_cli, _make_mesh,
     _bind_distributed_on_card_mesh, _lm_init_params, _lm_batch, _lm_decode_cache,
     _lm_params_from_numpy, _lm_serve_cli, _lm_train_cli, _synthetic_data, _restore_checkpoint,
     _train_state_from_numpy],
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
    bank = ops.stack_level_bank([la, la], [solver._perm] * 2, [solver._inv] * 2)
    xb = sptrsv.sptrsv_level_bank_cuda(*bank[:9], torch.tensor([1, 0]), bm.T[:2].contiguous())
    assert torch.equal(xb, xm.T[:2])
    xr = torch.zeros_like(b1)
    sptrsv.sptrsv_level_range_cuda(*la[:7], 0, la.level_ptr.numel() - 1, b1, xr)
    assert torch.equal(xr, x1)
    assert set(sptrsv.launches) == {"single", "mrhs", "elastic_single", "elastic_mrhs", "bank",
                                    "range_single", "range_mrhs", "ordered_single",
                                    "ordered_mrhs", "elastic_ordered_single",
                                    "elastic_ordered_mrhs"}
    assert solver.info()["binding"]["front_door"] == "gather"  # the CPU keeps the gathers
    assert not any(sptrsv.launches.values()) and spmv.launches == {"spmv": 0}
    assert torch.equal(xm[:, 0], x1)
    pa = plan_arrays(solver.exec_plan, device="cpu")
    assert torch.equal(x1, sptrsv_ref(*pa[:5], b1)) and torch.equal(xm, sptrsv_ref(*pa[:5], bm))
    assert not build._LIBS  # nothing was built or loaded


def test_torch_example_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "examples/torch_pcg_solve.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "OK" not in out.stdout


_QUICKSTART_BLOCKED = r"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["examples/torch_quickstart.py"] + sys.argv[1:]
runpy.run_path("examples/torch_quickstart.py", run_name="__main__")
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert loaded == [], loaded
"""


def test_torch_quickstart_on_cpu_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _QUICKSTART_BLOCKED, "--device", "cpu"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "n=4096" in out.stdout and "hdagg" in out.stdout
    assert "auto: regime=" in out.stdout and out.stdout.strip().endswith("OK")


def test_torch_serve_lm_example_on_cpu_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    script = _QUICKSTART_BLOCKED.replace("torch_quickstart", "torch_serve_lm")
    out = subprocess.run(
        [sys.executable, "-c", script, "--device", "cpu"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    for arch, family in (("granite_3_2b", "dense"), ("mixtral_8x7b", "moe"),
                         ("rwkv6_7b", "rwkv6"), ("recurrentgemma_2b", "hybrid")):
        assert any(ln.startswith(arch) and f"family={family}" in ln
                   for ln in out.stdout.splitlines()), arch
    assert out.stdout.strip().endswith("OK")


def test_torch_serve_lm_example_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "examples/torch_serve_lm.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "OK" not in out.stdout


def test_torch_quickstart_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "examples/torch_quickstart.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert "OK" not in out.stdout


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

    assert set(available_backends()) == {"kernel", "scan", "distributed"}
    assert repro_torch.TriangularSolver.plan.__kwdefaults__["backend"] == "kernel"
    assert repro_torch.TriangularSolver.plan.__kwdefaults__["device"] is None
