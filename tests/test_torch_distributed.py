"""The port's distributed solves on a mesh of positions: the mesh
(``repro_torch.mesh``), ``shard="model"`` (``repro_torch.solver.distributed``
behind ``repro_torch.backends.distributed``), the front door
(``TriangularSolver.plan(backend="distributed", mesh=, shard=)``, the plan
cache, ``validate=``) and the example, on CPU meshes in this process.

Model mode is bitwise the port's scan (each position walks one lane's
levels; every row keeps the plan's own FMA chain) on meshes (1, 8), (2, 4)
and (1, 4) with k = 3 (padded lanes), slack 0 / 2 / 8, one right-hand side
and m = 5, float32 and float64. JAX's ``run_distributed_solve`` steps with
``acc + gathered @ v[0]``, a dot product XLA need not contract into the
scan's FMA chain, so one subprocess holds the port to it within rtol 1e-5
(float32) / 1e-12 (float64) on a (2, 4) forced host mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.pipeline.registry import ScheduleOptions as JOptions
from repro.pipeline.registry import get_scheduler as jget_scheduler
from repro.sparse import dag_from_lower_csr as jdag
from repro.sparse.generators import erdos_renyi_lower as jer
from repro.sparse.generators import narrow_band_lower as jnb
from repro_torch import analysis, obs
from repro_torch.backends import get_backend
from repro_torch.backends.distributed import _pad_cores
from repro_torch.convert import exec_plan_from_numpy
from repro_torch.core import elastic_transform
from repro_torch.kernels import ops, sptrsv
from repro_torch.kernels.levels import level_order, round_ranges
from repro_torch.mesh import Mesh, make_mesh, mesh_fingerprint
from repro_torch.pipeline import PlanCache, TriangularSolver
from repro_torch.solver import distributed as dist
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _mesh import run_in_mesh_subprocess  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_TORCH = {"float32": torch.float32, "float64": torch.float64}
_MAKERS = {
    "er": (lambda: jer(700, 4e-3, seed=9), "wavefront"),
    "band": (lambda: jnb(800, 0.1, 6, seed=4), "block"),
}
M = 5


def _port_plan(name, k, dtype):
    make, strategy = _MAKERS[name]
    L = make()
    s = jget_scheduler(strategy)(jdag(L), JOptions(k=k))
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    jp = jcore.compile_plan(L2, s2, dtype=np.dtype(dtype))
    return exec_plan_from_numpy({f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def _rhs(n, dtype):
    rng = np.random.default_rng(n)
    return (torch.from_numpy(rng.standard_normal(n).astype(dtype)),
            torch.from_numpy(rng.standard_normal((n, M)).astype(dtype)))


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _assert_bitwise(a, b, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{what}: {nd} of {a.numel()} entries differ"


def _bind(plan, mesh, dtype="float32", slack=0, shard="model"):
    return get_backend("distributed").bind(
        plan, dtype=_TORCH[dtype], device="cpu", mesh=mesh, shard=shard, slack=slack)


# ------------------------------------------------------------------ mesh
def test_make_mesh_reads_as_jax():
    mesh = make_mesh((2, 4), devices="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.shape["data"] == 2 and dict(mesh.shape) == {"data": 2, "model": 4}
    assert list(mesh.shape) == ["data", "model"] and mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (2, 4) and mesh.devices.dtype == object
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    listed = make_mesh((1, 3), devices=["cpu"] * 3)
    assert dict(listed.shape) == {"data": 1, "model": 3}
    with pytest.raises(ValueError, match="devices"):
        make_mesh((1, 3), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="size"):
        make_mesh((0, 3), devices="cpu")
    # the CPU's positions have no streams: their work runs in program order
    assert mesh.stream((0, 0)) is None and mesh.mark((1, 3)) is None


def test_mesh_axes_in_either_order():
    """A position is (data, model) whatever the order of the mesh's axes:
    ``device`` finds it by axis name, the fingerprint lists the devices by
    position, and both shard modes solve on a non-square mesh whose model
    axis comes first as on the same mesh in the usual order."""
    devs = [f"cpu:{i}" for i in range(8)]
    usual = make_mesh((2, 4), devices=devs)
    grid = np.array(devs, dtype=object).reshape(2, 4).T.ravel().tolist()
    rev = make_mesh((4, 2), axis_names=("model", "data"), devices=grid)
    assert dict(rev.shape) == {"model": 4, "data": 2} and rev.shape["data"] == 2
    for d in range(2):
        for j in range(4):
            assert rev.device((d, j)) == usual.device((d, j)) == torch.device(devs[4 * d + j])
    assert mesh_fingerprint(rev) == mesh_fingerprint(usual)
    # the same devices laid out by the other axis order: a different placement
    square = [f"cpu:{i}" for i in range(4)]
    assert (mesh_fingerprint(make_mesh((2, 2), axis_names=("model", "data"), devices=square))
            != mesh_fingerprint(make_mesh((2, 2), devices=square)))

    plan = _port_plan("er", 4, "float32")
    b, B = _rhs(plan.n, "float32")
    for shard in ("model", "rows"):
        want = _bind(plan, make_mesh((2, 4), devices="cpu"), shard=shard)
        got = _bind(plan, make_mesh((4, 2), axis_names=("model", "data"), devices="cpu"),
                    shard=shard)
        _assert_bitwise(got.solve(b), want.solve(b), shard)
        _assert_bitwise(got.solve(B), want.solve(B), shard)
    odd = make_mesh((2, 4), axis_names=("x", "y"), devices="cpu")
    with pytest.raises(ValueError, match="'data' and 'model'"):
        _bind(plan, odd)
    with pytest.raises(ValueError, match="positions are"):
        odd.device((0, 0))


def test_make_mesh_refuses_more_positions_than_devices(monkeypatch):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh((2, max(have, 4)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 2), devices="cuda:0")


def test_mesh_fingerprint_and_plan_cache():
    L = erdos_renyi_lower(300, 0.01, seed=3)
    a, b = make_mesh((2, 4), devices="cpu"), make_mesh((1, 8), devices="cpu")
    assert mesh_fingerprint(a) != mesh_fingerprint(b)
    assert mesh_fingerprint(make_mesh((2, 4), devices="cpu")) == mesh_fingerprint(a)
    assert mesh_fingerprint(None) is None
    cache = PlanCache()
    kw = dict(k=4, device="cpu", backend="distributed", cache=cache)
    s1 = TriangularSolver.plan(L, mesh=a, **kw)
    s2 = TriangularSolver.plan(L, mesh=make_mesh((2, 4), devices="cpu"), **kw)
    assert s2 is s1 and cache.stats.hits == 1  # a rebuilt identical mesh hits
    s3 = TriangularSolver.plan(L, mesh=b, **kw)
    s4 = TriangularSolver.plan(L, mesh=a, shard="rows", **kw)
    assert len({id(s1), id(s3), id(s4)}) == 3 and cache.stats.misses == 3
    assert s1.width_class != s3.width_class != s4.width_class
    assert s4.info()["shard"] == "rows" and s1.info()["shard"] == "model"
    assert s1.info()["binding"]["mesh"] == {"data": 2, "model": 4}


def test_front_door_refusals():
    L = erdos_renyi_lower(200, 0.02, seed=4)
    mesh = make_mesh((1, 4), devices="cpu")
    with pytest.raises(ValueError, match="shard-rows"):
        TriangularSolver.plan(L, device="cpu", shard="rows")
    with pytest.raises(ValueError, match="requires a mesh"):
        TriangularSolver.plan(L, device="cpu", backend="distributed")
    with pytest.raises(ValueError, match="takes no mesh"):
        TriangularSolver.plan(L, device="cpu", mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        TriangularSolver.plan(L, device="cpu", backend="distributed", mesh=object())
    with pytest.raises(ValueError, match="shard mode"):
        get_backend("distributed").bind(
            TriangularSolver.plan(L, device="cpu").exec_plan, device="cpu", mesh=mesh,
            shard="cols")
    be = get_backend("distributed")
    assert be.requires() == ("mesh",) and be.capabilities() == ("elastic", "shard-rows")
    assert get_backend("kernel").requires() == ()


# ------------------------------------------------------------ model mode
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["er", "band"])
@pytest.mark.parametrize("shape,k", [((1, 8), 8), ((2, 4), 4), ((1, 4), 3)],
                         ids=["1x8", "2x4", "1x4-k3"])
def test_model_bitwise_port_scan(shape, k, name, dtype):
    plan = _port_plan(name, k, dtype)
    b, B = _rhs(plan.n, dtype)
    scan = get_backend("scan").bind(plan, dtype=_TORCH[dtype], device="cpu")
    x_ref, X_ref = scan.solve(b), scan.solve(B)
    mesh = make_mesh(shape, devices="cpu")
    for slack in (0, 2, 8):
        bound = _bind(plan, mesh, dtype, slack)
        _assert_bitwise(bound.solve(b), x_ref, f"slack {slack} single")
        _assert_bitwise(bound.solve(B), X_ref, f"slack {slack} m={M}")
        assert bound.describe()["k"] == shape[1]


def test_pad_cores_pads_and_refuses():
    plan = _port_plan("er", 3, "float32")
    padded = _pad_cores(plan, 4)
    assert padded.k == 4 and (padded.row_ids[:, 3] == plan.n).all()
    assert (padded.val_src[:, 3] == -1).all() and (padded.diag[:, 3] == 1).all()
    assert _pad_cores(plan, 3) is plan
    bound = _bind(plan, make_mesh((1, 4), devices="cpu"))
    # the padded lane has no levels: its position launches nothing
    assert bound.describe()["n_levels"][3] == 0
    with pytest.raises(ValueError, match="model"):
        _pad_cores(plan, 2)
    with pytest.raises(ValueError, match="model"):
        _bind(plan, make_mesh((1, 2), devices="cpu"))


def _jax_elastic_info(name, k, slack):
    make, strategy = _MAKERS[name]
    L = make()
    s = jget_scheduler(strategy)(jdag(L), JOptions(k=k))
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    ep = jcore.elastic_transform(jcore.compile_plan(L2, s2), slack)
    return {"slack": slack, "predicted_rounds": ep.n_fused_supersteps,
            "predicted_fusion": ep.stats()["barrier_fusion"]}, ep.n_fused_supersteps


@pytest.mark.parametrize("slack", [0, 8])
def test_model_describe_timed_and_update_values(slack):
    plan = _port_plan("band", 8, "float32")
    mesh = make_mesh((2, 8), devices="cpu")
    bound = _bind(plan, mesh, slack=slack)
    d = bound.describe()
    n_sup = plan.n_supersteps
    rounds = n_sup
    ex = {"mode": "all_gather", "shard": "model", "rounds": n_sup, "n_supersteps": n_sup,
          "executed_fusion": 1.0, "comm_values_per_solve": 8 * plan.n_steps,
          "comm_bytes_per_solve": 8 * plan.n_steps * 4}
    if slack:
        info, rounds = _jax_elastic_info("band", 8, slack)
        ex.update(info, rounds=rounds, executed_fusion=round(n_sup / rounds, 4))
    assert d["exchange"] == ex
    assert d["mesh"] == {"data": 2, "model": 8} and d["slack_unit"] == "supersteps"
    assert (d["backend"], d["shard"], d["n"], d["n_steps"], d["k"], d["W"]) == (
        "distributed", "model", plan.n, plan.n_steps, 8, plan.W)

    b, B = _rhs(plan.n, "float32")
    buf = obs.TraceBuffer("dist")
    with obs.tracing(buf):
        xt, steps = bound.solve_timed(b)
        Xt, msteps = bound.solve_timed(B)
    _assert_bitwise(xt, bound.solve(b))
    _assert_bitwise(Xt, bound.solve(B))
    assert len(steps) == len(msteps) == rounds
    assert sum(s["halo_values"] for s in steps) == ex["comm_values_per_solve"]
    assert sum(s["n_steps"] for s in steps) == plan.n_steps
    assert all(s["launches"] <= 8 for s in steps) and sum(s["launches"] for s in steps) > 0
    spans = [r for r in buf.spans() if r.name == "executor.exchange_round"]
    assert len(spans) == 2 * rounds
    assert set(spans[0].args) >= {"round", "supersteps", "halo_bytes"}

    data = np.random.default_rng(5).uniform(0.5, 2.0, bound.n_entries)
    fresh_plan = dataclasses.replace(plan, vals=plan.vals.copy(), diag=plan.diag.copy())
    fresh_plan.numeric_update(data)
    fresh = _bind(fresh_plan, mesh, slack=slack)
    upd = bound.update_values(data)
    _assert_bitwise(upd.solve(b), fresh.solve(b))
    _assert_bitwise(upd.solve(B), fresh.solve(B))
    assert not torch.equal(upd.solve(b), bound.solve(b))


def test_run_distributed_solve_and_raw_pieces():
    plan = _port_plan("er", 4, "float32")
    mesh = make_mesh((2, 4), devices="cpu")
    B = _rhs(plan.n, "float32")[1]
    x = dist.run_distributed_solve(plan, B.T.numpy(), mesh)
    scan = get_backend("scan").bind(plan, device="cpu")
    _assert_bitwise(x, scan.solve(B).T.contiguous())
    spec = dist.dist_plan_spec(plan)
    assert spec.n_rounds == plan.n_supersteps
    assert spec.exchange_bounds == tuple(range(plan.n_supersteps + 1))
    # the all-gather tables: every row finished once, in its round
    rows = dist.lane_rows(plan, spec.exchange_bounds)
    allr = np.concatenate([r for rr in rows for r in rr])
    assert np.array_equal(np.sort(allr), np.arange(plan.n))
    with pytest.raises(ValueError, match="model axis"):
        dist.run_distributed_solve(plan, B.T.numpy(), make_mesh((1, 8), devices="cpu"))


def test_model_within_tolerance_of_jax_run_distributed_solve():
    """JAX's ``run_distributed_solve`` on a (2, 4) forced host mesh, ER
    (k = 4), 4 right-hand sides in float32 and float64: the port's model
    mode within rtol 1e-5 / 1e-12 (its dot-product step is not the scan's
    FMA chain)."""
    out = run_in_mesh_subprocess("""
        import json, dataclasses
        import jax
        jax.config.update("jax_enable_x64", True)
        import numpy as np, jax.numpy as jnp
        import repro.core as jcore
        from repro.pipeline.registry import ScheduleOptions, get_scheduler
        from repro.solver.distributed import run_distributed_solve
        from repro.sparse import dag_from_lower_csr
        from repro.sparse.generators import erdos_renyi_lower

        L = erdos_renyi_lower(700, 4e-3, seed=9)
        s = get_scheduler("wavefront")(dag_from_lower_csr(L), ScheduleOptions(k=4))
        L2, s2, _, _ = jcore.apply_reordering(L, s)
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        b = np.random.default_rng(1).standard_normal((4, L.n_rows))
        res = {"b": b.tolist()}
        for dt in ("float32", "float64"):
            plan = jcore.compile_plan(L2, s2, dtype=np.dtype(dt))
            x = run_distributed_solve(plan, b.astype(dt), mesh, dtype=jnp.dtype(dt))
            res[dt] = np.asarray(x).astype(np.float64).tolist()
        print("RESULT" + json.dumps(res))
    """, devices=8)
    res = json.loads(out.split("RESULT", 1)[1])
    mesh = make_mesh((2, 4), devices="cpu")
    b = np.asarray(res["b"])
    for dt, rtol in (("float32", 1e-5), ("float64", 1e-12)):
        plan = _port_plan("er", 4, dt)
        x = dist.run_distributed_solve(plan, b.astype(dt), mesh, dtype=_TORCH[dt])
        want = np.asarray(res[dt])
        got = x.double().numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= rtol * scale, (dt, np.abs(got - want).max(), scale)
        # and bitwise the port's scan
        scan = get_backend("scan").bind(plan, dtype=_TORCH[dt], device="cpu")
        _assert_bitwise(x, scan.solve(torch.from_numpy(b.T.astype(dt))).T.contiguous())


# ---------------------------------------------------------- the verifier
def test_round_ranges_and_their_check():
    plan = _port_plan("band", 8, "float32")
    order = level_order(plan)
    ep = elastic_transform(plan, 8)
    for bounds in (np.arange(plan.n_supersteps + 1), ep.fused_bounds):
        rng = round_ranges(order, bounds)
        assert rng[0] == 0 and rng[-1] == order.n_levels
        assert analysis.verify_round_ranges(order, bounds, rng) == []
        for r in range(len(bounds) - 1):
            runs = order.level_run[rng[r]:rng[r + 1]]
            assert ((runs >= bounds[r]) & (runs < bounds[r + 1])).all()
    rng = round_ranges(order, np.arange(plan.n_supersteps + 1)).copy()
    rng[2] += 1  # one level walked a round late
    found = analysis.verify_round_ranges(order, np.arange(plan.n_supersteps + 1), rng)
    assert [f.code for f in found] == ["LEVEL_ROUND_RANGE"]
    with pytest.raises(ValueError, match="slack"):
        round_ranges(level_order(plan, slack=2), [0, plan.n_supersteps])


@pytest.mark.parametrize("shard", ["rows", "model"])
def test_validate_refuses_a_shifted_range_before_any_launch(monkeypatch, shard):
    L = narrow_band_lower(400, 0.3, 3, seed=4)
    mesh = make_mesh((1, 4), devices="cpu")
    kw = dict(k=4, device="cpu", backend="distributed", mesh=mesh, shard=shard,
              strategy="wavefront")
    # clean: the halo partition and every position's order pass, fast and full
    for level in ("fast", "full"):
        s = TriangularSolver.plan(L, validate=level, **kw)
        assert len(s.bound.level_audit()) == 4
    calls = []
    real = sptrsv.sptrsv_level_range_ref
    monkeypatch.setattr(sptrsv, "sptrsv_level_range_ref",
                        lambda *a: calls.append(1) or real(*a))

    def shifted(order, bounds):
        out = round_ranges(order, bounds).copy()
        out[1] += 1  # one level walked a round late
        return out

    monkeypatch.setattr(ops, "round_ranges", shifted)
    with pytest.raises(analysis.VerificationError, match="LEVEL_ROUND_RANGE"):
        TriangularSolver.plan(L, validate="fast", **kw)
    assert calls == []  # refused before any launch
    # without validation the shifted order binds (and would walk wrongly)
    s = TriangularSolver.plan(L, **kw)
    s.solve(np.ones(L.n_rows))
    assert calls


# ------------------------------------------------------------- example
def test_example_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "examples/torch_distributed_solve.py", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
    assert "shard=model" in out.stdout and "shard=rows" in out.stdout
