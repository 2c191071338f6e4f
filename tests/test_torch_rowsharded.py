"""The row-sharded solve of the port (``backend="distributed"``,
``shard="rows"``: ``repro_torch.solver.rowsharded`` behind
``repro_torch.backends.distributed``) against the JAX package, on CPU
meshes in this process (``make_mesh(..., devices="cpu")``: every position
takes the level kernel's plain version).

The reference's own contract is that the row-sharded solve is bitwise the
single-device scan (``src/repro/solver/rowsharded.py``). So on meshes
(1, 1), (1, 3) (uneven: 8 cores on 3 shards), (2, 4) and (1, 8), slack 0, 2
and 8, one right-hand side and m = 5, float32 and float64, on an ER plan
(wavefront, 9 exchange rounds) and a banded one (block, 8 supersteps that
the certificate fuses into 5 rounds), every answer is bitwise JAX's scan
bind (``repro.backends.get_backend("scan")``) of the same plan and the
port's scan. One subprocess runs JAX's raw ``build_rowsharded_solver`` on
an 8-device forced host mesh; the port's raw solver gives the same stacked
owned regions, bit for bit. Also: the psum exchange against the ring, the
bound's ``update_values`` / ``solve_timed`` / ``describe()["exchange"]``
(the latter against the numbers the JAX bound builds, from the JAX
package's NumPy partitioner and certificate), and the range launches.
"""
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.backends import get_backend as jget_backend
from repro.core.rowshard import partition_plan as jpartition_plan
from repro.pipeline.registry import ScheduleOptions as JOptions
from repro.pipeline.registry import get_scheduler as jget_scheduler
from repro.sparse import dag_from_lower_csr as jdag
from repro.sparse.generators import erdos_renyi_lower as jer
from repro.sparse.generators import narrow_band_lower as jnb
from repro_torch.backends import get_backend
from repro_torch.convert import exec_plan_from_numpy
from repro_torch.core import elastic_transform, partition_plan
from repro_torch.kernels import sptrsv
from repro_torch.mesh import make_mesh
from repro_torch.solver import rowsharded as rows

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _mesh import run_in_mesh_subprocess  # noqa: E402

_TORCH = {"float32": torch.float32, "float64": torch.float64}
_MAKERS = {
    "er": (lambda: jer(700, 4e-3, seed=9), "wavefront"),
    "band": (lambda: jnb(800, 0.1, 6, seed=4), "block"),
}
MESHES = [(1, 1), (1, 3), (2, 4), (1, 8)]
SLACKS = (0, 2, 8)
M = 5


@functools.lru_cache(maxsize=None)
def _jax_plan(name, dtype):
    make, strategy = _MAKERS[name]
    L = make()
    s = jget_scheduler(strategy)(jdag(L), JOptions(k=8))
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    return jcore.compile_plan(L2, s2, dtype=np.dtype(dtype))


def _port_plan(jp):
    return exec_plan_from_numpy({f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def _rhs(n, dtype):
    rng = np.random.default_rng(n)
    return (rng.standard_normal(n).astype(dtype),
            rng.standard_normal((n, M)).astype(dtype))


@functools.lru_cache(maxsize=None)
def _jax_scan(name, dtype):
    """JAX's scan bind of the plan: x for b and B."""
    jp = _jax_plan(name, dtype)
    b, B = _rhs(jp.n, dtype)
    with jax.enable_x64(dtype == "float64"):
        bound = jget_backend("scan").bind(jp, dtype=jnp.dtype(dtype))
        return np.asarray(bound.solve(b)), np.asarray(bound.solve(B))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{what}: {nd} of {a.size} entries differ"


def _bind(plan, mesh, dtype, slack=0):
    return get_backend("distributed").bind(
        plan, dtype=_TORCH[dtype], device="cpu", mesh=mesh, shard="rows", slack=slack)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["er", "band"])
def test_rows_bitwise_jax_scan_bind(name, dtype, shape):
    jp = _jax_plan(name, dtype)
    plan = _port_plan(jp)
    b, B = _rhs(jp.n, dtype)
    x_jax, X_jax = _jax_scan(name, dtype)
    scan = get_backend("scan").bind(plan, dtype=_TORCH[dtype], device="cpu")
    x_scan, X_scan = scan.solve(torch.from_numpy(b)), scan.solve(torch.from_numpy(B))
    _assert_bitwise(x_scan, x_jax, "port scan vs JAX scan")
    mesh = make_mesh(shape, devices="cpu")
    for slack in SLACKS:
        bound = _bind(plan, mesh, dtype, slack)
        d = bound.describe()
        assert d["shard"] == "rows" and d["n_shards"] == shape[1] and d["mesh"] == {
            "data": shape[0], "model": shape[1]}
        x, X = bound.solve(torch.from_numpy(b)), bound.solve(torch.from_numpy(B))
        _assert_bitwise(x, x_jax, f"slack {slack} single")
        _assert_bitwise(X, X_jax, f"slack {slack} m={M}")
        _assert_bitwise(x, x_scan)
        _assert_bitwise(X, X_scan)


def test_elastic_fuses_exchange_rounds():
    """The banded plan's certificate fuses 8 supersteps into 5 exchange
    rounds; describe() reports the fusion, the answer keeps its bits."""
    plan = _port_plan(_jax_plan("band", "float32"))
    mesh = make_mesh((2, 4), devices="cpu")
    bulk, fused = _bind(plan, mesh, "float32"), _bind(plan, mesh, "float32", slack=8)
    eb, ef = bulk.describe()["exchange"], fused.describe()["exchange"]
    assert (eb["rounds"], ef["rounds"]) == (8, 5)
    assert ef["executed_fusion"] == round(8 / 5, 4) and ef["slack"] == 8
    assert ef["predicted_rounds"] == 5
    b = torch.from_numpy(_rhs(plan.n, "float32")[0])
    _assert_bitwise(fused.solve(b), bulk.solve(b))


def _jax_describe_exchange(jp, n_shards, slack, itemsize):
    """The exchange block JAX's ``RowShardedBoundSolve.describe`` builds,
    from the JAX package's NumPy partitioner and certificate."""
    info, bounds = None, None
    if slack:
        ep = jcore.elastic_transform(jp, slack)
        bounds = ep.fused_bounds
        info = {"slack": slack, "predicted_rounds": ep.n_fused_supersteps,
                "predicted_fusion": ep.stats()["barrier_fusion"]}
    rsp = jpartition_plan(jp, n_shards, exchange_bounds=bounds)
    comm = rsp.comm_stats(itemsize)
    n_sup = len(rsp.step_bounds) - 1
    ex = {"mode": "ring", "shard": "rows", "rounds": rsp.n_rounds, "n_supersteps": n_sup,
          "executed_fusion": round(n_sup / max(rsp.n_rounds, 1), 4),
          "comm_values_per_solve": comm["halo_values_per_solve"],
          "comm_bytes_per_solve": comm["halo_values_per_solve"] * itemsize,
          **{k: comm[k] for k in ("halo_pairs", "halo_values_per_solve",
                                  "halo_bytes_per_solve", "halo_values_max_round",
                                  "allgather_values", "allgather_bytes", "halo_ratio",
                                  "active_exchanges")}}
    if info:
        ex.update(info)
    return ex


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["er", "band"])
def test_describe_exchange_equals_jax(name, dtype):
    jp = _jax_plan(name, dtype)
    plan = _port_plan(jp)
    for shape in ((1, 3), (2, 4)):
        mesh = make_mesh(shape, devices="cpu")
        for slack in SLACKS:
            got = _bind(plan, mesh, dtype, slack).describe()
            want = _jax_describe_exchange(jp, shape[1], slack, np.dtype(dtype).itemsize)
            assert got["exchange"] == want, (shape, slack)
            assert got["slack_unit"] == "supersteps" and got["dtype"] == dtype


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_update_values_and_timed(shape):
    """update_values is bitwise a fresh bind; solve_timed is bitwise
    solve, one step per exchange round, the halo values summing to the
    comm model's."""
    jp = _jax_plan("er", "float32")
    plan = _port_plan(jp)
    mesh = make_mesh(shape, devices="cpu")
    bound = _bind(plan, mesh, "float32")
    b, B = (torch.from_numpy(a) for a in _rhs(plan.n, "float32"))
    x0 = bound.solve(b)
    xt, steps = bound.solve_timed(b)
    _assert_bitwise(xt, x0)
    ex = bound.describe()["exchange"]
    assert len(steps) == ex["rounds"] and [s["round"] for s in steps] == list(range(len(steps)))
    assert sum(s["halo_values"] for s in steps) == ex["halo_values_per_solve"]
    assert all("us" in s and s["launches"] <= shape[1] for s in steps)
    Xt, msteps = bound.solve_timed(B)
    _assert_bitwise(Xt, bound.solve(B))
    assert len(msteps) == ex["rounds"]

    rng = np.random.default_rng(12)
    n_entries = bound.n_entries
    data = rng.uniform(0.5, 2.0, n_entries)
    fresh_plan = dataclasses.replace(plan, vals=plan.vals.copy(), diag=plan.diag.copy())
    fresh_plan.numeric_update(data)
    fresh = _bind(fresh_plan, mesh, "float32")
    upd = bound.update_values(data)
    _assert_bitwise(upd.solve(b), fresh.solve(b))
    _assert_bitwise(upd.solve(B), fresh.solve(B))
    assert not torch.equal(upd.solve(b), x0)
    _assert_bitwise(bound.solve(b), x0)  # the old bound is untouched
    with pytest.raises(ValueError, match="update_values"):
        bound.update_values(data[:-1])


def _psum_bound(bound):
    """The same bind with the psum exchange (opt-in, as in JAX)."""
    return type(bound)(
        bound._rsp, bound._mesh, "psum", bound._plan_args,
        rows.rowshard_halo_args(bound._rsp, bound._mesh, "psum"), bound._np_dtype,
        bound._home, bound.n_entries)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_psum_exchange_bitwise_ring_except_signed_zero(dtype):
    plan = _port_plan(_jax_plan("er", dtype))
    mesh = make_mesh((2, 4), devices="cpu")
    ring = _bind(plan, mesh, dtype)
    psum = _psum_bound(ring)
    assert psum.describe()["exchange"]["mode"] == "psum"
    b, B = (torch.from_numpy(a) for a in _rhs(plan.n, dtype))
    xr = ring.solve(b)
    assert not ((xr == 0) & torch.signbit(xr)).any()
    _assert_bitwise(psum.solve(b), xr)
    _assert_bitwise(psum.solve(B), ring.solve(B))
    # b = 0 with every diagonal negative: x is -0.0 everywhere, boundary
    # values included; psum's 0 + (-0) moves them as +0, so only the sign
    # of some zeros may differ
    diag = np.where(plan.diag_src >= 0, -np.abs(plan.diag), plan.diag).astype(plan.diag.dtype)
    ring = _bind(dataclasses.replace(plan, diag=diag), mesh, dtype)
    psum = _psum_bound(ring)
    bz = torch.zeros(plan.n, dtype=_TORCH[dtype])
    xr, xp = ring.solve(bz), psum.solve(bz)
    assert ((xr == 0) & torch.signbit(xr)).all()
    assert torch.equal(xr, xp)  # equal as values (-0.0 == +0.0)
    differs = torch.from_numpy(_bits(xr.numpy()) != _bits(xp.numpy()))
    assert (xr[differs] == 0).all()


def test_range_launches_partition_is_one_launch():
    """Range walks over a partition of the bulk order, in order, into one
    x are bitwise one full walk, one and m right-hand sides (the
    column-major layout), with the checks of the range wrapper."""
    from repro_torch.kernels.ops import level_plan_arrays
    from repro_torch.kernels.ref import sptrsv_level_ref
    from repro_torch.solver.executor import pad_rhs

    plan = _port_plan(_jax_plan("band", "float64"))
    la = level_plan_arrays(plan, dtype=torch.float64, device="cpu")
    L = la.level_ptr.numel() - 1
    b, B = (torch.from_numpy(a) for a in _rhs(plan.n, "float64"))
    full1, fullm = sptrsv_level_ref(*la[:7], pad_rhs(b)), sptrsv_level_ref(*la[:7], pad_rhs(B))
    for cuts in ([0, L], [0, 1, L], [0, L // 3, L // 3, 2 * L // 3, L], list(range(L + 1))):
        b1, bm = pad_rhs(b), pad_rhs(B).T.contiguous()
        x1, xm = torch.zeros_like(b1), torch.zeros_like(bm)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            sptrsv.sptrsv_level_range_cuda(*la[:7], lo, hi, b1, x1)
            sptrsv.sptrsv_level_range_cuda(*la[:7], lo, hi, bm, xm)
        _assert_bitwise(x1, full1, str(cuts))
        _assert_bitwise(xm.T, fullm, str(cuts))
    b1 = pad_rhs(b)
    x1 = torch.zeros_like(b1)
    for bad in ((1, 0), (-1, 1), (0, L + 1)):
        with pytest.raises(ValueError, match="level range"):
            sptrsv.sptrsv_level_range_cuda(*la[:7], *bad, b1, x1)
    with pytest.raises(ValueError, match="x must match"):
        sptrsv.sptrsv_level_range_cuda(*la[:7], 0, L, b1, x1.float())
    with pytest.raises(ValueError, match="contiguous"):
        xm = torch.zeros(plan.n + 1, 3, dtype=torch.float64).T
        sptrsv.sptrsv_level_range_cuda(*la[:7], 0, L, xm.contiguous(), xm)


def test_raw_solver_bitwise_jax_build_rowsharded_solver():
    """JAX's raw ``build_rowsharded_solver`` on an 8-device forced host
    mesh (2, 4), one and 4 right-hand sides: its stacked owned regions,
    read through ``np.asarray``, are bitwise the port's raw solver's."""
    out = run_in_mesh_subprocess("""
        import json, dataclasses
        import numpy as np, jax, jax.numpy as jnp
        import repro.core as jcore
        from repro.core.rowshard import partition_plan
        from repro.pipeline.registry import ScheduleOptions, get_scheduler
        from repro.solver.rowsharded import (build_rowsharded_solver, rowshard_halo_args,
                                             rowshard_plan_args, rowshard_spec)
        from repro.sparse import dag_from_lower_csr
        from repro.sparse.generators import erdos_renyi_lower

        L = erdos_renyi_lower(700, 4e-3, seed=9)
        s = get_scheduler("wavefront")(dag_from_lower_csr(L), ScheduleOptions(k=8))
        L2, s2, _, _ = jcore.apply_reordering(L, s)
        plan = jcore.compile_plan(L2, s2)
        rsp = partition_plan(plan, 4)
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        rng = np.random.default_rng(3)
        res = {"plan": {f.name: np.asarray(getattr(plan, f.name)).tolist()
                        for f in dataclasses.fields(plan)
                        if f.name not in ("elastic",)}}
        for batch in (0, 4):
            shape = (plan.n,) if batch == 0 else (plan.n, batch)
            b = rng.standard_normal(shape).astype(np.float32)
            bl = np.zeros((rsp.n_shards * rsp.slots,) + shape[1:], np.float32)
            bl[rsp.b_scatter] = b
            b_loc = bl.reshape((rsp.n_shards, rsp.slots) + shape[1:])
            spec = rowshard_spec(rsp, batch=batch)
            fn = jax.jit(build_rowsharded_solver(spec, mesh))
            with mesh:
                x = fn(*rowshard_plan_args(rsp), *rowshard_halo_args(rsp), jnp.asarray(b_loc))
            res[str(batch)] = {"b_loc": b_loc.tolist(),
                               "x": np.asarray(x).view(np.uint32).tolist()}
        print("RESULT" + json.dumps(res))
    """, devices=8)
    res = json.loads(out.split("RESULT", 1)[1])
    fields = res["plan"]
    fields["n"], fields["k"], fields["W"] = (int(np.asarray(fields[f])) for f in ("n", "k", "W"))
    plan = exec_plan_from_numpy(fields)
    plan = dataclasses.replace(
        plan, row_ids=plan.row_ids.astype(np.int32), col_idx=plan.col_idx.astype(np.int32),
        vals=plan.vals.astype(np.float32), diag=plan.diag.astype(np.float32),
        accum=plan.accum.astype(bool), step_bounds=plan.step_bounds.astype(np.int32),
        val_src=plan.val_src.astype(np.int32), diag_src=plan.diag_src.astype(np.int32))
    rsp = partition_plan(plan, 4)
    mesh = make_mesh((2, 4), devices="cpu")
    args = rows.rowshard_plan_args(rsp, mesh, torch.float32)
    halo = rows.rowshard_halo_args(rsp, mesh)
    for batch in (0, 4):
        b_loc = torch.tensor(res[str(batch)]["b_loc"], dtype=torch.float32)
        x = rows.build_rowsharded_solver(rows.rowshard_spec(rsp), mesh)(
            args, halo, b_loc)
        want = np.asarray(res[str(batch)]["x"], dtype=np.uint32)
        assert x.shape == want.shape
        assert np.array_equal(x.numpy().view(np.uint32), want), batch


def test_rows_lift_k_above_model_axis():
    """shard="rows" runs k=8 on 2 shards of 4 lanes (model mode refuses
    it), bitwise the scan."""
    plan = _port_plan(_jax_plan("er", "float32"))
    mesh = make_mesh((1, 2), devices="cpu")
    bound = _bind(plan, mesh, "float32")
    assert bound.describe()["k_local"] == 4
    b = torch.from_numpy(_rhs(plan.n, "float32")[0])
    _assert_bitwise(bound.solve(b), get_backend("scan").bind(plan, device="cpu").solve(b))
    with pytest.raises(ValueError, match="model"):
        get_backend("distributed").bind(plan, device="cpu", mesh=mesh)


def test_round_static_and_spec_match_jax():
    """The exchange tables' shapes per round (JAX's
    ``rowshard_round_static``: ring hop widths, psum send / receive widths
    and buffer size) and the fields of JAX's spec that the port's executor
    reads, with and without fused rounds."""
    from repro.solver.rowsharded import rowshard_round_static as jround_static
    from repro.solver.rowsharded import rowshard_spec as jrowshard_spec

    jp = _jax_plan("band", "float32")
    ep = jcore.elastic_transform(jp, 8)
    plan = _port_plan(jp)
    mesh = make_mesh((1, 4), devices="cpu")
    for bounds in (None, ep.fused_bounds):
        jr = jpartition_plan(jp, 4, exchange_bounds=bounds)
        pr = partition_plan(plan, 4, exchange_bounds=None if bounds is None else
                            elastic_transform(plan, 8).fused_bounds)
        ring = [rows.halo_args_for_round(pr, mesh, r) for r in range(len(pr.rounds))]
        assert tuple(rr.hops for rr in ring) == jround_static(jr, "ring")
        for rr in ring:
            width = sum(w for _, w in rr.hops)
            assert all(t.numel() == width for t in rr.send[0] + rr.recv[0])
        psum = [rows.halo_args_for_round(pr, mesh, r, "psum") for r in range(len(pr.rounds))]
        assert tuple((int(p.send_slot[0][0].numel()), int(p.recv_pos[0][0].numel()),
                      p.buf_size) for p in psum) == jround_static(jr, "psum")
        for mode in ("ring", "psum"):
            js = jrowshard_spec(jr, mode=mode, batch=3)
            ps = rows.rowshard_spec(pr, mode=mode)
            assert dataclasses.asdict(ps) == {f: getattr(js, f) for f in
                                              ("n_loc", "step_bounds", "exchange_bounds", "mode")}
            assert ps.n_rounds == js.n_rounds
    with pytest.raises(ValueError, match="mode"):
        rows.rowshard_spec(pr, mode="allreduce")
