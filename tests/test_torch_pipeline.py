"""The slice end to end: ``repro_torch.TriangularSolver`` on the CPU against
``repro.pipeline.TriangularSolver``, bitwise (f32) — both backends, lower
and upper (on ``transpose_csr``), single and multi-RHS — plus
``numeric_update``, ``clone_with_values``, ``PlanCache`` hit/miss counts and
``factor_pair`` on an IC(0) factor. Each side builds its matrices with its
own generators; the CSR arrays are equal (tests/test_torch_inspector.py)."""
import functools

import numpy as np
import pytest
import torch

import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.pipeline import PlanCache as JPlanCache
from repro.pipeline import TriangularSolver as JSolver
from repro.pipeline import factor_pair as jfactor_pair
from repro_torch import PlanCache, TriangularSolver, factor_pair
from repro_torch.convert import csr_from_numpy


@functools.lru_cache(maxsize=None)
def _pair(name, lower=True):
    """(JAX matrix, port matrix); upper variants are transposes."""
    if name == "er":
        j, t = (jsparse.erdos_renyi_lower(700, 2e-3, seed=11),
                tsparse.erdos_renyi_lower(700, 2e-3, seed=11))
    elif name == "nb":
        j, t = (jsparse.narrow_band_lower(700, 0.14, 10, seed=12),
                tsparse.narrow_band_lower(700, 0.14, 10, seed=12))
    else:
        j, t = (jsparse.ichol0(jsparse.poisson2d_matrix(24)),
                tsparse.ichol0(tsparse.poisson2d_matrix(24)))
    if not lower:
        j, t = jsparse.transpose_csr(j), tsparse.transpose_csr(t)
    return j, t


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(jax_x, port_x):
    assert isinstance(port_x, torch.Tensor) and port_x.device.type == "cpu"
    a, b = np.asarray(jax_x), port_x.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{nd} of {a.size} entries differ"


def _rhs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if m is None else (n, m))


def _new_values(L, seed):
    rng = np.random.default_rng(seed)
    data = L.data * rng.uniform(0.5, 1.5, L.nnz)
    return data


@pytest.mark.parametrize("m", [None, 7])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "scan"])
@pytest.mark.parametrize("name", ["er", "nb"])
def test_solve_bitwise_vs_jax(name, backend, lower, m):
    jA, tA = _pair(name, lower)
    js = JSolver.plan(jA, lower=lower)
    ts = TriangularSolver.plan(tA, lower=lower, backend=backend, device="cpu")
    assert ts.exec_plan.n_steps == js.exec_plan.n_steps
    b = _rhs(jA.n_rows, m)
    _assert_bitwise(js.solve(b), ts.solve(b))
    # torch input works the same as numpy input
    _assert_bitwise(js.solve(b), ts.solve(torch.from_numpy(b)))


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_numeric_update_and_clone_bitwise(backend):
    jA, tA = _pair("nb")
    js = JSolver.plan(jA)
    ts = TriangularSolver.plan(tA, backend=backend, device="cpu")
    data = _new_values(jA, 5)
    b = _rhs(jA.n_rows, 4, seed=1)
    x_before = ts.solve(b)
    # clone: new values, the original is untouched
    jc, tc = js.clone_with_values(data), ts.clone_with_values(data)
    _assert_bitwise(jc.solve(b), tc.solve(b))
    assert torch.equal(ts.solve(b), x_before)
    # in-place refresh from a CSRMatrix of the planned pattern
    js.numeric_update(data)
    ts.numeric_update(csr_from_numpy(tA.n_rows, tA.n_cols, tA.indptr, tA.indices, data))
    _assert_bitwise(js.solve(b), ts.solve(b))
    assert np.array_equal(ts.source_values, data)
    # a fresh plan on the new values agrees as well
    fresh = TriangularSolver.plan(
        csr_from_numpy(tA.n_rows, tA.n_cols, tA.indptr, tA.indices, data),
        backend=backend, device="cpu",
    )
    assert torch.equal(fresh.solve(b), ts.solve(b))


def test_numeric_update_rejects_other_pattern():
    _, tA = _pair("er")
    ts = TriangularSolver.plan(tA, device="cpu")
    _, other = _pair("nb")
    with pytest.raises(ValueError, match="fingerprint"):
        ts.numeric_update(other)
    with pytest.raises(ValueError, match="fingerprint"):
        ts.clone_with_values(other)


def test_plan_cache_counts_match_jax():
    jA, tA = _pair("er")
    data = _new_values(jA, 9)
    jcache, tcache = JPlanCache(), PlanCache()
    jnew = jsparse.CSRMatrix(jA.n_rows, jA.n_cols, jA.indptr, jA.indices, data)
    tnew = csr_from_numpy(tA.n_rows, tA.n_cols, tA.indptr, tA.indices, data)
    b = _rhs(jA.n_rows, None, seed=2)
    j1 = JSolver.plan(jA, cache=jcache)
    t1 = TriangularSolver.plan(tA, cache=tcache, device="cpu")
    assert TriangularSolver.plan(tA, cache=tcache, device="cpu") is t1  # same values
    JSolver.plan(jA, cache=jcache)
    j2 = JSolver.plan(jnew, cache=jcache)
    t2 = TriangularSolver.plan(tnew, cache=tcache, device="cpu")  # hit, new values
    assert t2 is not t1
    TriangularSolver.plan(tA, cache=tcache, device="cpu", k=4)  # miss: other k
    JSolver.plan(jA, cache=jcache, k=4)
    js, ts = jcache.stats.as_dict(), tcache.stats.as_dict()
    for key in ("hits", "misses", "numeric_updates", "evictions"):
        assert ts[key] == js[key], key
    assert (ts["hits"], ts["misses"], ts["numeric_updates"]) == (2, 2, 1)
    _assert_bitwise(j1.solve(b), t1.solve(b))
    _assert_bitwise(j2.solve(b), t2.solve(b))


def test_plan_cache_lru_and_pins():
    _, tA = _pair("er")
    cache = PlanCache(maxsize=2)
    s4 = TriangularSolver.plan(tA, cache=cache, device="cpu", k=4)
    cache.pin(s4.plan_key)
    s8 = TriangularSolver.plan(tA, cache=cache, device="cpu", k=8)
    TriangularSolver.plan(tA, cache=cache, device="cpu", k=2)
    # the oldest unpinned entry (k=8) leaves, the pinned oldest stays
    assert cache.stats.evictions == 1 and len(cache) == 2
    assert TriangularSolver.plan(tA, cache=cache, device="cpu", k=4) is s4
    assert TriangularSolver.plan(tA, cache=cache, device="cpu", k=8) is not s8
    cache.unpin(s4.plan_key)
    assert cache.pinned == frozenset()


def test_plan_cache_ignores_steps_per_tile():
    # no kernel of the port tiles, so the tile size binds nothing new
    _, tA = _pair("er")
    cache = PlanCache()
    s8 = TriangularSolver.plan(tA, cache=cache, device="cpu", steps_per_tile=8)
    s32 = TriangularSolver.plan(tA, cache=cache, device="cpu", steps_per_tile=32)
    assert s32 is s8 and (cache.stats.misses, cache.stats.hits) == (1, 1)


def test_factor_pair_ichol_bitwise():
    jL, tL = _pair("ichol")
    jf, jb = jfactor_pair(jL)
    tf, tb = factor_pair(tL, device="cpu")
    assert (tf.lower, tb.lower) == (True, False)
    b = _rhs(jL.n_rows, None, seed=4)
    y_j, y_t = jf.solve(b), tf.solve(b)
    _assert_bitwise(y_j, y_t)
    _assert_bitwise(jb.solve(y_j), tb.solve(y_t))
    B = _rhs(jL.n_rows, 3, seed=5)
    _assert_bitwise(jb.solve(jf.solve(B)), tb.solve(tf.solve(B)))


def test_factor_pair_shares_cache():
    _, tL = _pair("ichol")
    cache = PlanCache()
    factor_pair(tL, cache=cache, device="cpu")
    factor_pair(tL, cache=cache, device="cpu")
    assert (cache.stats.misses, cache.stats.hits) == (2, 2)


def test_info_and_options():
    _, tA = _pair("nb")
    ts = TriangularSolver.plan(
        tA, device="cpu", k=4, width=3, steps_per_tile=32, dtype=torch.float64
    )
    info = ts.info()
    assert info["backend"] == "kernel" and info["strategy"] == "growlocal"
    assert info["device"] == "cpu" and info["plan"]["k"] == 4
    assert info["steps_per_tile"] == 32 and info["binding"]["W"] == 3
    assert info["binding"]["dtype"] == "float64"
    x = ts.solve(_rhs(tA.n_rows, None))
    assert x.dtype == torch.float64
    serial = TriangularSolver.plan(tA, device="cpu", strategy="serial")
    assert serial.info()["plan"]["k"] == 1


@pytest.mark.parametrize(
    "kw, err",
    [
        (dict(backend="pallas"), ValueError),
        (dict(strategy="hdag"), KeyError),  # "auto" is a strategy now: a typo
        (dict(dtype=torch.float16), ValueError),
        (dict(lower=False), ValueError),  # a lower matrix is not upper
    ],
)
def test_plan_rejects_bad_arguments(kw, err):
    _, tA = _pair("er")
    with pytest.raises(err):
        TriangularSolver.plan(tA, device="cpu", **kw)


def test_solve_rejects_wrong_shape():
    _, tA = _pair("er")
    ts = TriangularSolver.plan(tA, device="cpu")
    with pytest.raises(ValueError, match="b must be"):
        ts.solve(np.ones(tA.n_rows + 1))


def test_top_level_exports():
    assert repro_torch.TriangularSolver is TriangularSolver
    assert repro_torch.factor_pair is factor_pair
