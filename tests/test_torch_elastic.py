"""``mode="elastic"`` of the port against the JAX package (CPU):

  * the certificate (``core.elastic``) — ``ready_step``, ``wave_id``,
    ``n_waves``, ``fused_bounds`` and ``stats()`` array-equal to the JAX
    package's, and the invariants the executors rely on
    (tests/test_elastic.py::_check_certificate);
  * elastic solves bitwise-equal to the JAX elastic and bulk scan solves
    and to the port's bulk solves, both port backends, lower and upper,
    single and multi-RHS;
  * the elastic kernels' layout (``elastic_kernel_arrays``: the level order
    over runs of the certificate's slack) and their plain version
    ``kernels.ref.sptrsv_level_ref``: bitwise-equal to ``sptrsv_ref``, to
    the JAX ``solve_with_plan`` and to the JAX elastic scan in f32 and f64,
    one and m right-hand sides, signed zeros included, and within
    rtol=atol=1e-4 of ``sptrsv_pallas_elastic(interpret=True)`` (the
    Pallas body tree-sums over W);
  * ``update_values`` on an elastic bound bitwise-equal to a fresh bind;
    mode/slack validation as in JAX; plan-cache keys that differ by slack;
    the unit of ``slack`` that each elastic bound states (``slack_unit``).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch.core as tcore
from repro.autotune.corpus import chain_lower
from repro.backends import get_backend as jget_backend
from repro.kernels.ops import elastic_kernel_arrays as jelastic_kernel_arrays
from repro.kernels.sptrsv import sptrsv_pallas_elastic
from repro.pipeline import TriangularSolver as JSolver
from repro.pipeline import schedule as jschedule
from repro_torch import PlanCache, TriangularSolver
from repro_torch.backends import (
    ScanBackend,
    get_backend,
    register_backend,
    unregister_backend,
)
from repro_torch.convert import csr_from_numpy, exec_plan_from_numpy
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import (
    elastic_kernel_arrays,
    level_plan_arrays,
    solve_with_elastic_kernel_arrays,
)
from repro_torch.kernels.ref import sptrsv_level_ref, sptrsv_ref
from repro_torch.kernels.sptrsv import sptrsv_elastic_cuda
from repro_torch.solver.executor import (
    elastic_plan_arrays,
    pad_rhs,
    plan_arrays,
    solve_with_elastic,
    solve_with_plan,
)

K = 8

_MATS = {
    "chain": lambda: chain_lower(200, seed=1),
    "band": lambda: jsparse.narrow_band_lower(300, 0.14, 8, seed=2),
    "er": lambda: jsparse.erdos_renyi_lower(300, 0.03, seed=3),
}


def _port_csr(m):
    return csr_from_numpy(m.n_rows, m.n_cols, m.indptr, m.indices, m.data)


def _port_plan(jp):
    return exec_plan_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    )


@functools.lru_cache(maxsize=None)
def _jax_plan(name, width=None):
    """The JAX plan of a certificate case (GrowLocal, k=8, no reorder, as
    tests/test_elastic.py builds it)."""
    L = _MATS[name]()
    s = jschedule(jsparse.dag_from_lower_csr(L), K, strategy="growlocal")
    return jcore.compile_plan(L, s, width=width)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{nd} of {a.size} entries differ"


def _rhs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if m is None else (n, m))


def _check_certificate(plan, ep):
    """The independence/staleness invariants the executors rely on
    (tests/test_elastic.py), on the port's certificate."""
    T, slack = plan.n_steps, ep.slack
    assert ep.n_macro_steps == -(-T // slack)
    assert ep.n_steps == T
    fb = ep.fused_bounds
    assert fb[0] == 0 and fb[-1] == ep.n_supersteps
    assert np.all(np.diff(fb) >= 1)
    writer_step, _, _ = tcore.step_dependencies(plan)
    wave = ep.wave_id
    for t in range(T):
        m, j = divmod(t, slack)
        w = wave[m, j]
        assert 0 <= w < ep.n_waves[m]
        assert ep.ready_step[t] <= t
        for c in np.unique(plan.col_idx[t][~plan.accum[t]]):
            if c >= plan.n:
                continue
            wm, wj = divmod(int(writer_step[c]), slack)
            assert wm < m or (wm == m and wave[wm, wj] < w)
        if t + 1 < T and plan.accum[t].any():
            m2, j2 = divmod(t + 1, slack)
            assert m2 > m or wave[m2, j2] > w


# ------------------------------------------------------------ certificate
@pytest.mark.parametrize("slack", [1, 3, 8, 16])
@pytest.mark.parametrize("name", ["chain", "band", "er"])
def test_certificate_matches_jax(name, slack):
    jp = _jax_plan(name)
    tp = _port_plan(jp)
    jep = jcore.elastic_transform(jp, slack)
    tep = tcore.elastic_transform(tp, slack)
    for field in ("ready_step", "wave_id", "n_waves", "fused_bounds"):
        a, b = getattr(jep, field), getattr(tep, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("slack", "n_steps", "n_macro_steps", "n_supersteps"):
        assert getattr(jep, field) == getattr(tep, field), field
    assert tep.stats() == jep.stats()
    for a, b in zip(jcore.step_dependencies(jp), tcore.step_dependencies(tp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _check_certificate(tp, tep)
    assert tcore.DEFAULT_SLACK == jcore.DEFAULT_SLACK


def test_certificate_rejects_bad_slack():
    tp = _port_plan(_jax_plan("chain"))
    with pytest.raises(ValueError, match="slack"):
        tcore.elastic_transform(tp, 0)


# ------------------------------------------------------------ front door
@functools.lru_cache(maxsize=None)
def _front_pair(lower):
    """(JAX matrix, port matrix) of the front-door cases: a narrow band,
    transposed for the upper orientation."""
    j = jsparse.narrow_band_lower(400, 0.14, 8, seed=6)
    if not lower:
        j = jsparse.transpose_csr(j)
    return j, _port_csr(j)


@functools.lru_cache(maxsize=None)
def _jax_solvers(lower, slack=None):
    jA, _ = _front_pair(lower)
    kw = {} if slack is None else {"slack": slack}
    return (JSolver.plan(jA, k=K, lower=lower),
            JSolver.plan(jA, k=K, lower=lower, mode="elastic", **kw))


@pytest.mark.parametrize("backend", ["scan", "kernel"])
@pytest.mark.parametrize("m", [None, 1, 3, 16])
@pytest.mark.parametrize("lower", [True, False])
def test_elastic_solve_bitwise_vs_jax(lower, m, backend):
    jbulk, jel = _jax_solvers(lower)
    _, tA = _front_pair(lower)
    tbulk = TriangularSolver.plan(tA, k=K, lower=lower, backend=backend, device="cpu")
    tel = TriangularSolver.plan(
        tA, k=K, lower=lower, backend=backend, mode="elastic", device="cpu"
    )
    assert tel.info()["mode"] == "elastic" and tel.info()["slack"] == jel.info()["slack"]
    b = _rhs(tA.n_rows, m, seed=7)
    x = tel.solve(b)
    _assert_bitwise(jel.solve(b), x)
    _assert_bitwise(jbulk.solve(b), x)
    _assert_bitwise(tbulk.solve(b), x)


@pytest.mark.parametrize("backend", ["scan", "kernel"])
@pytest.mark.parametrize("slack", [1, 2, 5, 16])
def test_elastic_bitwise_across_slack(slack, backend):
    jbulk, _ = _jax_solvers(True)
    _, tA = _front_pair(True)
    tel = TriangularSolver.plan(tA, k=K, backend=backend, slack=slack, device="cpu")
    assert tel.info()["mode"] == "elastic" and tel.info()["slack"] == slack
    for m in (None, 4):
        b = _rhs(tA.n_rows, m, seed=slack)
        _assert_bitwise(jbulk.solve(b), tel.solve(b))


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_elastic_numeric_update_bitwise_vs_jax(backend):
    jA, tA = _front_pair(True)
    jel = JSolver.plan(jA, k=K, mode="elastic")
    tel = TriangularSolver.plan(tA, k=K, backend=backend, mode="elastic", device="cpu")
    data = jA.data * np.random.default_rng(10).uniform(0.5, 2.0, jA.nnz)
    jel.numeric_update(data)
    tel.numeric_update(data)
    fresh = TriangularSolver.plan(
        _port_csr(dataclasses.replace(jA, data=data)), k=K, backend=backend,
        mode="elastic", device="cpu",
    )
    for m in (None, 3):
        b = _rhs(jA.n_rows, m, seed=11)
        x = tel.solve(b)
        _assert_bitwise(jel.solve(b), x)
        _assert_bitwise(fresh.solve(b), x)


# ----------------------------------------------------- bound / executor
@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_update_values_bitwise(backend):
    # width 2 forces accumulate rows: vertices of several lane-steps
    jp = _jax_plan("er", width=2)
    rng = np.random.default_rng(7)
    L = _MATS["er"]()
    data = rng.uniform(-2.0, 2.0, L.nnz)
    diag = L.indices == L.row_of_entry()
    data[diag] = np.sign(data[diag]) * (1.0 + np.abs(data[diag]))
    bound = get_backend(backend).bind(_port_plan(jp), slack=3, device="cpu")
    refreshed = bound.update_values(data)
    s = jschedule(jsparse.dag_from_lower_csr(L), K, strategy="growlocal")
    jp_new = jcore.compile_plan(dataclasses.replace(L, data=data), s, width=2)
    fresh = get_backend(backend).bind(_port_plan(jp_new), slack=3, device="cpu")
    jbound = jget_backend("scan").bind(jp, slack=3).update_values(data)
    for m in (None, 5):
        b = _rhs(jp.n, m, seed=3).astype(np.float32)
        x = refreshed.solve(torch.from_numpy(b))
        _assert_bitwise(fresh.solve(torch.from_numpy(b)), x)
        _assert_bitwise(jbound.solve(jnp.asarray(b)), x)
    # the old bound is untouched
    b = _rhs(jp.n, None).astype(np.float32)
    _assert_bitwise(
        jget_backend("scan").bind(jp).solve(jnp.asarray(b)), bound.solve(torch.from_numpy(b))
    )
    d = refreshed.describe()
    assert d["mode"] == "elastic" and d["slack"] == 3 and d["backend"] == backend
    assert d["certificate"] == jcore.elastic_transform(jp, 3).stats()
    if backend == "kernel":  # the level tensors are a fresh bind's
        for name in ("vals", "diag"):
            _assert_bitwise(getattr(fresh._la, name), getattr(refreshed._la, name))
        assert d["n_levels"] == level_order(_port_plan(jp_new), slack=3).n_levels


# the shapes of tests/test_torch_executor.py::test_sptrsv_ref_matches_pallas_interpret
@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize(
    "n,density,k,width,slack",
    [(64, 0.05, 2, None, 4), (200, 0.02, 4, 3, 8), (450, 0.01, 8, 16, 3), (300, 0.08, 16, 2, 5)],
)
def test_sptrsv_elastic_ref_vs_bulk_and_pallas(n, density, k, width, slack, m):
    L = jsparse.erdos_renyi_lower(n, density, seed=n + k)
    s = jcore.grow_local(jsparse.dag_from_lower_csr(L), k)
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    jp = jcore.compile_plan(L2, s2, width=width)
    jp.elastic = jcore.elastic_transform(jp, slack)
    b = _rhs(n, m).astype(np.float32)
    b_pad_j = jnp.concatenate([jnp.asarray(b), jnp.zeros((1, *b.shape[1:]), jnp.float32)])
    x_pallas = np.asarray(sptrsv_pallas_elastic(
        *jelastic_kernel_arrays(jp), b_pad_j, steps_per_tile=slack, interpret=True
    ))
    tp = dataclasses.replace(_port_plan(jp), elastic=tcore.elastic_transform(_port_plan(jp), slack))
    la = elastic_kernel_arrays(tp, device="cpu")
    b_pad = pad_rhs(torch.from_numpy(b))
    x_el = sptrsv_level_ref(*la[:7], b_pad)
    pa = plan_arrays(tp, device="cpu")
    _assert_bitwise(sptrsv_ref(*pa[:5], b_pad), x_el)
    np.testing.assert_allclose(x_el.numpy()[:n], x_pallas[:n], rtol=1e-4, atol=1e-4)
    assert (x_el[n] == 0).all()  # the scratch slot stays zero
    # the plain macro-step loop and the kernel wrapper (plain version on
    # CPU tensors) agree too
    x = torch.from_numpy(b)
    ea = elastic_plan_arrays(tp, slack=slack, device="cpu")
    _assert_bitwise(solve_with_plan(pa, x), solve_with_elastic(ea, x))
    _assert_bitwise(solve_with_plan(pa, x), solve_with_elastic_kernel_arrays(la, x))


def test_elastic_plan_arrays_layout():
    tp = _port_plan(_jax_plan("band"))
    ea = elastic_plan_arrays(tp, slack=8, dtype=torch.float64, device="cpu")
    M = -(-tp.n_steps // 8)
    assert ea.row_ids.shape == (M, 8, tp.k) and ea.n_steps == tp.n_steps
    assert ea.vals.dtype == torch.float64 and ea.slack == 8
    flat = ea.row_ids.reshape(M * 8, tp.k)
    assert np.array_equal(flat[: tp.n_steps].numpy(), tp.row_ids)
    assert (flat[tp.n_steps:] == tp.n).all()  # padding steps hit scratch
    assert not ea.accum.reshape(M * 8, -1)[tp.n_steps:].any()
    assert (ea.diag.reshape(M * 8, -1)[tp.n_steps:] == 1).all()


def test_elastic_kernel_arrays_checks():
    tp = _port_plan(_jax_plan("band"))
    with pytest.raises(ValueError, match="no elastic certificate"):
        elastic_kernel_arrays(tp, device="cpu")
    ep = tcore.elastic_transform(tp, 4)
    good = dataclasses.replace(tp, elastic=ep)
    # the level tensors of the order over runs of the certificate's slack
    la = elastic_kernel_arrays(good, device="cpu")
    ref = level_plan_arrays(tp, device="cpu", order=level_order(tp, slack=4))
    for a, b in zip(la[:8], ref[:8]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert la.level_ptr.numel() - 1 < level_order(tp).n_levels  # runs merge levels
    # slack 1: the bulk kernel's tensors
    one = elastic_kernel_arrays(
        dataclasses.replace(tp, elastic=tcore.elastic_transform(tp, 1)), device="cpu"
    )
    for a, b in zip(one[:8], level_plan_arrays(tp, device="cpu")[:8]):
        assert torch.equal(a, b)
    other = tcore.elastic_transform(_port_plan(_jax_plan("chain")), 4)
    with pytest.raises(ValueError, match="does not fit"):
        elastic_kernel_arrays(dataclasses.replace(tp, elastic=other), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        elastic_kernel_arrays(
            dataclasses.replace(tp, elastic=dataclasses.replace(ep, slack=0)), device="cpu"
        )
    bad = dataclasses.replace(good, col_idx=tp.col_idx.copy())
    bad.col_idx[0, 0, 0] = tp.n + 1
    with pytest.raises(ValueError, match="col_idx"):
        elastic_kernel_arrays(bad, device="cpu")


def test_sptrsv_elastic_cuda_input_checks():
    tp = _port_plan(_jax_plan("er", width=2))
    tp = dataclasses.replace(tp, elastic=tcore.elastic_transform(tp, 4))
    la = elastic_kernel_arrays(tp, device="cpu")
    flat = list(la[:7])
    b1 = pad_rhs(torch.from_numpy(_rhs(tp.n, None).astype(np.float32)))
    bm = pad_rhs(torch.from_numpy(_rhs(tp.n, 3).astype(np.float32)))
    for i, bad, err in [
        (0, flat[0].long(), TypeError),  # int64 rows
        (6, flat[6].long(), TypeError),  # int64 level bounds
        (4, flat[4].float(), TypeError),  # float mask
        (7, b1.double(), TypeError),  # dtype mismatch with vals
        (1, flat[1].t(), ValueError),  # not contiguous
        (3, flat[3][:-1], ValueError),  # wrong shape
        (7, bm[:, :, None].contiguous(), ValueError),  # b_pad neither [n+1] nor [n+1, m]
    ]:
        a = [*flat, b1]
        a[i] = bad
        with pytest.raises(err):
            sptrsv_elastic_cuda(*a)
    pa = plan_arrays(tp, device="cpu")
    for b_pad in (b1, bm):  # the plain version on CPU tensors: the bulk bits
        _assert_bitwise(sptrsv_ref(*pa[:5], b_pad), sptrsv_elastic_cuda(*flat, b_pad))


@functools.lru_cache(maxsize=None)
def _signed_zero_case(name, dtype):
    """A JAX plan (width 2) of a matrix with explicit +-0 entries, and its
    entry data."""
    L = {"er": lambda: jsparse.erdos_renyi_lower(700, 2e-3, seed=11),
         "band": lambda: jsparse.narrow_band_lower(700, 0.14, 10, seed=12),
         "ichol": lambda: jsparse.ichol0(jsparse.poisson2d_matrix(24))}[name]()
    rng = np.random.default_rng(5)
    off = np.flatnonzero(L.indices != L.row_of_entry())
    data = np.array(L.data, dtype=np.float64)
    zeros = rng.choice(off, off.size // 4, replace=False)
    data[zeros] = np.where(rng.random(zeros.size) < 0.5, -0.0, 0.0)
    L = dataclasses.replace(L, data=data)
    s = jschedule(jsparse.dag_from_lower_csr(L), K, strategy="growlocal")
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    return jcore.compile_plan(L2, s2, width=2, dtype=np.dtype(dtype))


@pytest.mark.parametrize("m", [None, 3, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,slack", [("er", 2), ("band", 8), ("ichol", 3)])
def test_elastic_level_walk_bitwise_vs_jax(name, slack, dtype, m):
    import jax

    jp = _signed_zero_case(name, dtype)
    tp = _port_plan(jp)
    tp = dataclasses.replace(tp, elastic=tcore.elastic_transform(tp, slack))
    tdt = torch.float32 if dtype == "float32" else torch.float64
    rng = np.random.default_rng(slack)
    b = rng.standard_normal(jp.n if m is None else (jp.n, m)).astype(dtype)
    zero = rng.random(b.shape) < 0.5  # half of b is +0 or -0
    b[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    la = elastic_kernel_arrays(tp, dtype=tdt, device="cpu")
    b_pad = pad_rhs(torch.from_numpy(b))
    x = sptrsv_level_ref(*la[:7], b_pad)
    assert x.dtype == tdt and x.shape == b_pad.shape
    assert (x[jp.n] == 0).all() and not torch.signbit(x[jp.n]).any()  # the scratch slot
    x = x[: jp.n]
    assert (torch.signbit(x) & (x == 0)).any()  # -0 reached x
    _assert_bitwise(sptrsv_ref(*plan_arrays(tp, dtype=tdt, device="cpu")[:5], b_pad)[: jp.n], x)
    with jax.enable_x64(dtype == "float64"):
        jb = jnp.asarray(b)
        from repro.solver.executor import plan_arrays as jplan_arrays
        from repro.solver.executor import solve_with_plan as jsolve_with_plan

        x_bulk = np.asarray(jsolve_with_plan(jplan_arrays(jp, dtype=jnp.dtype(dtype)), jb))
        x_elastic = np.asarray(jget_backend("scan").bind(
            jp, dtype=np.dtype(dtype), slack=slack).solve(jb))
    _assert_bitwise(x_bulk, x)
    _assert_bitwise(x_elastic, x)


# ------------------------------------------------------ options / cache
@pytest.mark.parametrize(
    "kw", [dict(mode="nope"), dict(mode="bsp", slack=4)], ids=["unknown", "bsp+slack"]
)
def test_mode_validation_matches_jax(kw):
    jA, tA = _front_pair(True)
    with pytest.raises(ValueError) as jerr:
        JSolver.plan(jA, **kw)
    with pytest.raises(ValueError) as terr:
        TriangularSolver.plan(tA, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_negative_slack_raises():
    _, tA = _front_pair(True)
    with pytest.raises(ValueError, match="slack must be >= 0"):
        TriangularSolver.plan(tA, device="cpu", slack=-1)


def test_backend_without_elastic_capability_raises():
    class BulkOnly(ScanBackend):
        name = "bulk-only"

        def capabilities(self):
            return ()

    register_backend(BulkOnly)
    try:
        _, tA = _front_pair(True)
        with pytest.raises(ValueError, match="'elastic' capability"):
            TriangularSolver.plan(tA, backend="bulk-only", mode="elastic", device="cpu")
        plan = TriangularSolver.plan(tA, backend="bulk-only", device="cpu").exec_plan
        with pytest.raises(ValueError, match="'elastic' capability"):
            get_backend("bulk-only").bind(plan, slack=2, device="cpu")
    finally:
        unregister_backend("bulk-only")
    assert get_backend("scan").capabilities() == ("grouped", "elastic", "slots")
    assert get_backend("kernel").capabilities() == ("grouped", "elastic", "slots")


def test_plan_cache_keys_differ_by_slack():
    _, tA = _front_pair(True)
    cache = PlanCache()
    bulk = TriangularSolver.plan(tA, cache=cache, device="cpu")
    el = TriangularSolver.plan(tA, cache=cache, device="cpu", mode="elastic")
    el4 = TriangularSolver.plan(tA, cache=cache, device="cpu", slack=4)
    assert len({bulk.plan_key, el.plan_key, el4.plan_key}) == 3
    assert (cache.stats.misses, cache.stats.hits) == (3, 0)
    # mode="elastic" alone is slack=DEFAULT_SLACK: the same entry
    assert TriangularSolver.plan(
        tA, cache=cache, device="cpu", slack=tcore.DEFAULT_SLACK
    ) is el
    assert cache.stats.hits == 1
    assert bulk.info()["mode"] == "bsp" and bulk.info()["slack"] == 0
    assert "elastic" not in bulk.info()["plan"]


def test_info_and_stats_match_jax():
    _, jel = _jax_solvers(True)
    _, tA = _front_pair(True)
    tel = TriangularSolver.plan(tA, k=K, mode="elastic", device="cpu")
    ti, ji = tel.info(), jel.info()
    assert (ti["mode"], ti["slack"]) == (ji["mode"], ji["slack"]) == ("elastic", 8)
    assert ti["plan"]["elastic"] == ji["plan"]["elastic"]
    assert ti["plan"]["n_steps"] == ji["plan"]["n_steps"]
    b = ti["binding"]
    assert b["mode"] == "elastic" and b["n_macro_steps"] == ji["binding"]["n_macro_steps"]


@pytest.mark.parametrize("backend,unit", [("scan", "plan_steps"), ("kernel", "supersteps")])
def test_elastic_bound_states_slack_unit(backend, unit):
    L = _port_csr(_MATS["band"]())
    el = TriangularSolver.plan(L, device="cpu", backend=backend, slack=3)
    d = el.bound.describe()
    assert (d["mode"], d["slack"], d["slack_unit"]) == ("elastic", 3, unit)
    info = el.info()
    assert (info["slack"], info["slack_unit"]) == (3, unit)
    assert info["binding"]["slack_unit"] == unit
    bulk = TriangularSolver.plan(L, device="cpu", backend=backend)
    assert bulk.info()["slack_unit"] is None and "slack_unit" not in bulk.bound.describe()
    B = np.random.default_rng(4).standard_normal((L.n_rows, 2))
    assert torch.equal(el.solve(B), bulk.solve(B))  # the unit changes no bits
