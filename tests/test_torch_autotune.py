"""The port's autotuner against the JAX package's (CPU; JAX is the oracle).

Every comparison is exact:

  * the corpus (the named tier and the n = 100,000 scale tier): CSR arrays
    equal, ``MatrixFeatures.as_dict()`` equal (named tier);
  * ``classify``, ``shortlist`` and ``select_schedule`` equal, with
    ``allow_elastic`` False and True: strategy, ``dataclasses.asdict``
    of the options, cost, regime and the scored candidates;
  * ``plan(strategy="auto", device="cpu").solve`` bitwise (f32) the JAX
    ``plan(strategy="auto")`` on every corpus entry, lower and upper (on
    ``transpose_csr``), 1 and 4 RHS, on both port backends;
  * the selection memo (in a ``PlanCache`` and module-level), the binding
    key (``device=None`` and ``"cuda"`` one entry, ``"cpu"`` another);
  * ``tune=True`` on the CPU: a timing per candidate, the slack sweep when
    elastic is allowed, a winner from the shortlist, and a solve bitwise a
    plan built with the tuned strategy and options;
  * ``plan(sched=...)`` with a JAX schedule carried across by
    ``convert.schedule_from_numpy``, bitwise the JAX ``plan(sched=...)``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.autotune as jauto
import repro.sparse as jsparse
import repro_torch.autotune as tauto
import repro_torch.sparse as tsparse
from repro.pipeline import PlanCache as JPlanCache
from repro.pipeline import TriangularSolver as JSolver
from repro.pipeline import schedule as jschedule
from repro_torch import PlanCache, ScheduleOptions, TriangularSolver
from repro_torch.autotune import selector as tselector
from repro_torch.convert import schedule_from_numpy
from repro_torch.pipeline import get_scheduler, register_scheduler, schedule

NAMES = jauto.corpus_names()
SCALE_NAMES = jauto.scale_corpus_names()


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(jax_x, port_x):
    assert isinstance(port_x, torch.Tensor) and port_x.device.type == "cpu"
    a, b = np.asarray(jax_x), port_x.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{nd} of {a.size} entries differ"


def _assert_csr_equal(j, t):
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for f in ("indptr", "indices", "data"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@functools.lru_cache(maxsize=None)
def _pair(name, lower=True):
    j, t = jauto.corpus_entry(name).matrix(), tauto.corpus_entry(name).matrix()
    if not lower:
        j, t = jsparse.transpose_csr(j), tsparse.transpose_csr(t)
    return j, t


@functools.lru_cache(maxsize=None)
def _dags(name):
    j, t = _pair(name)
    return jsparse.dag_from_lower_csr(j), tsparse.dag_from_lower_csr(t)


def _options_dict(o):
    return dataclasses.asdict(o)


def _assert_selection_equal(js, ts):
    assert ts.strategy == js.strategy
    assert _options_dict(ts.options) == _options_dict(js.options)
    assert ts.cost == js.cost and ts.regime == js.regime
    assert ts.features.as_dict() == js.features.as_dict()
    assert [(c.strategy, _options_dict(c.options), c.cost) for c in ts.candidates] == [
        (c.strategy, _options_dict(c.options), c.cost) for c in js.candidates]
    assert ts.as_dict() == js.as_dict()


# ------------------------------------------------------------ the corpus
def test_corpus_names_and_metadata_match_jax():
    assert tauto.corpus_names() == NAMES
    assert tauto.scale_corpus_names() == SCALE_NAMES
    for je, te in zip(jauto.corpus_entries() + jauto.scale_corpus_entries(),
                      tauto.corpus_entries() + tauto.scale_corpus_entries()):
        assert (te.name, te.regime, te.expected_best, te.description) == (
            je.name, je.regime, je.expected_best, je.description)
    with pytest.raises(KeyError, match="unknown corpus"):
        tauto.corpus_entry("nope")
    with pytest.raises(KeyError, match="unknown scale-corpus"):
        tauto.scale_corpus_entry("nope")


@pytest.mark.parametrize("name", NAMES)
def test_corpus_csr_equal_to_jax(name):
    _assert_csr_equal(*_pair(name))


@pytest.mark.parametrize("name", SCALE_NAMES)
def test_scale_corpus_csr_equal_to_jax(name):
    _assert_csr_equal(jauto.scale_corpus_entry(name).make(),
                      tauto.scale_corpus_entry(name).make())


@pytest.mark.parametrize("gen", ["chain_lower", "star_lower", "independent_lower"])
def test_pathological_generators_equal_to_jax(gen):
    for n, seed in ((1, 0), (5, 3), (50, 9)):
        _assert_csr_equal(getattr(jauto, gen)(n, seed=seed), getattr(tauto, gen)(n, seed=seed))


# ------------------------------------------------------------ features
@pytest.mark.parametrize("name", NAMES)
def test_features_equal_to_jax(name):
    j, t = _pair(name)
    jf, tf = jauto.matrix_features(j), tauto.matrix_features(t)
    assert tf.as_dict() == jf.as_dict()
    assert tf.invariant() == jf.invariant() and tf.density == jf.density
    jd, td = _dags(name)
    assert tauto.dag_features(td) == tf


def test_features_memoized_and_cleared():
    _, t = _pair("chain")
    tauto.clear_feature_cache()
    f1 = tauto.matrix_features(t)
    assert tauto.matrix_features(t) is f1
    tauto.clear_feature_cache()
    assert tauto.matrix_features(t) is not f1
    empty = tsparse.CSRMatrix(0, 0, np.zeros(1, np.int64), np.zeros(0, np.int64),
                              np.zeros(0))
    assert tauto.dag_features(tsparse.dag_from_lower_csr(empty)).as_dict() == (
        jauto.dag_features(jsparse.dag_from_lower_csr(
            jsparse.CSRMatrix(0, 0, np.zeros(1, np.int64), np.zeros(0, np.int64),
                              np.zeros(0)))).as_dict())


# ------------------------------------------------------------ selector
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_classify_and_shortlist_equal_to_jax(name, k):
    j, t = _pair(name)
    jf, tf = jauto.matrix_features(j), tauto.matrix_features(t)
    assert tauto.classify(tf, k) == jauto.classify(jf, k) == (
        tauto.corpus_entry(name).regime if k == 8 else tauto.classify(tf, k))
    from repro.pipeline import ScheduleOptions as JOptions

    for kw in ({}, {"max_size": 32}, {"slack": 4}):
        js = jauto.shortlist(jf, JOptions(k=k, **kw))
        ts = tauto.shortlist(tf, ScheduleOptions(k=k, **kw))
        assert [(c.strategy, _options_dict(c.options), c.cost) for c in ts] == [
            (c.strategy, _options_dict(c.options), c.cost) for c in js]


@pytest.mark.parametrize("allow_elastic", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_select_schedule_equal_to_jax(name, allow_elastic):
    jd, td = _dags(name)
    jsel, jwin = jauto.select_schedule(jd, allow_elastic=allow_elastic)
    tsel, twin = tauto.select_schedule(td, allow_elastic=allow_elastic)
    _assert_selection_equal(jsel, tsel)
    for f in ("pi", "sigma", "rank"):
        assert np.array_equal(getattr(jwin, f), getattr(twin, f))
    # the registry's "auto" returns the same winning schedule
    via_registry = schedule(td, strategy="auto")
    assert np.array_equal(via_registry.sigma, jschedule(jd, strategy="auto").sigma)


# ----------------------------------------------- plan(strategy="auto")
@functools.lru_cache(maxsize=None)
def _jax_auto(name, lower):
    j, _ = _pair(name, lower)
    return JSolver.plan(j, strategy="auto", lower=lower)


@functools.lru_cache(maxsize=None)
def _jax_auto_solve(name, lower, m):
    n = _pair(name, lower)[0].n_rows
    b = np.random.default_rng(5).standard_normal(n if m == 1 else (n, m))
    return b, np.asarray(_jax_auto(name, lower).solve(b))


@pytest.mark.parametrize("backend", ["kernel", "scan"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_plan_auto_solve_bitwise_vs_jax(name, lower, m, backend):
    _, t = _pair(name, lower)
    ts = TriangularSolver.plan(t, strategy="auto", lower=lower, backend=backend,
                               device="cpu")
    js = _jax_auto(name, lower)
    _assert_selection_equal(js.selection, ts.selection)
    assert ts.strategy == js.strategy and ts.info()["slack"] == js.info()["slack"]
    assert ts.info()["selection"] == js.info()["selection"]
    b, x_j = _jax_auto_solve(name, lower, m)
    _assert_bitwise(x_j, ts.solve(b))


def test_plan_auto_mode_bsp_keeps_bulk():
    # the elastic rule fires on band_narrow unless the caller forces bsp
    _, t = _pair("band_narrow")
    el = TriangularSolver.plan(t, strategy="auto", device="cpu")
    bsp = TriangularSolver.plan(t, strategy="auto", device="cpu", mode="bsp")
    assert el.selection.options.slack > 0 and el.info()["mode"] == "elastic"
    assert bsp.selection.options.slack == 0 and bsp.info()["mode"] == "bsp"
    b = np.random.default_rng(1).standard_normal(t.n_rows)
    assert torch.equal(el.solve(b), bsp.solve(b))


# ------------------------------------------------------------ the memo
def test_selection_memo_counts_as_in_quickstart():
    A = tsparse.ichol0(tsparse.poisson2d_matrix(20))
    cache = PlanCache()
    auto = TriangularSolver.plan(A, strategy="auto", k=8, cache=cache, device="cpu")
    sel = auto.selection
    assert sel is not None and auto.info()["selection"]["strategy"] == sel.strategy
    assert sel.cost <= min(c for _, c in sel.as_dict()["candidates"])
    again = TriangularSolver.plan(A, strategy="auto", k=8, cache=cache, device="cpu")
    assert again is auto
    assert cache.stats.selections == 1 and cache.stats.selection_hits == 1
    assert cache.stats.misses == 1 and cache.stats.hits == 1
    # the concrete key is the one a fixed-strategy plan of the pick uses
    fixed = TriangularSolver.plan(A, strategy=sel.strategy, options=sel.options,
                                  cache=cache, device="cpu")
    assert fixed is auto and cache.stats.hits == 2
    cache.clear()
    TriangularSolver.plan(A, strategy="auto", k=8, cache=cache, device="cpu")
    assert cache.stats.selections == 2


def test_module_memo_without_cache():
    tauto.clear_selection_memo()
    _, t = _pair("star")
    TriangularSolver.plan(t, strategy="auto", device="cpu")
    assert len(tselector._SELECTION_MEMO) == 1
    TriangularSolver.plan(t, strategy="auto", device="cpu")
    assert len(tselector._SELECTION_MEMO) == 1
    TriangularSolver.plan(t, strategy="auto", device="cpu", k=4)
    assert len(tselector._SELECTION_MEMO) == 2
    tauto.clear_selection_memo()
    assert not tselector._SELECTION_MEMO


def test_selection_cap_in_plan_cache():
    cache = PlanCache(maxsize=2)
    assert cache._selections_max == 64
    for i in range(70):
        cache.store_selection(("k", i), object())
    assert cache.stats.selections == 70 and len(cache._selections) == 64
    assert cache.get_selection(("k", 0)) is None
    assert cache.get_selection(("k", 69)) is not None and cache.stats.selection_hits == 1


def test_binding_key_resolves_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    k_none = tselector._binding_key({"device": None})
    k_cuda = tselector._binding_key({"device": "cuda"})
    k_cpu = tselector._binding_key({"device": "cpu"})
    assert k_none == k_cuda != k_cpu
    assert k_cuda[0] == "kernel"  # the port's default backend
    o = ScheduleOptions()
    assert (tauto.selection_key("fp", o, True, True, k_cuda)
            != tauto.selection_key("fp", o, True, True, k_cpu))
    # the model-based path is binding-free
    assert (tauto.selection_key("fp", o, True, False, k_cuda)
            == tauto.selection_key("fp", o, True, False, k_cpu))
    with pytest.raises(ValueError, match="unknown backend"):
        tselector._binding_key({"backend": "nope", "device": "cpu"})


def test_binding_key_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tselector._binding_key({})


# ------------------------------------------------------------ tune=True
@pytest.mark.parametrize("mode", [None, "bsp"])
@pytest.mark.parametrize("name", ["band_narrow", "er_sparse"])
def test_tune_times_candidates_on_cpu(name, mode):
    _, t = _pair(name)
    assert t.n_rows <= 800
    cache = PlanCache()
    ts = TriangularSolver.plan(t, strategy="auto", tune=True, device="cpu", cache=cache,
                               mode=mode)
    sel = ts.selection
    assert sel.tuned and ts.info()["selection"]["tuned"]
    names = [c.strategy for c in sel.candidates]
    assert [s for s, _ in sel.timings] == names and sel.strategy in names
    assert all(sec > 0 for _, sec in sel.timings)
    t_of = dict(sel.timings)
    assert t_of[sel.strategy] == min(t_of.values())
    if mode == "bsp":
        assert sel.slack_timings is None and sel.options.slack == 0
    else:
        swept = [s for s, _ in sel.slack_timings]
        assert swept == sorted({0, *tauto.selector.SLACK_GRID}
                               | {c.options.slack for c in sel.candidates})
        assert sel.options.slack == min(sel.slack_timings, key=lambda r: r[1])[0]
    # only the winner enters the caller's cache; a second plan does no work
    assert cache.stats.misses == 1 and cache.stats.selections == 1
    again = TriangularSolver.plan(t, strategy="auto", tune=True, device="cpu",
                                  cache=cache, mode=mode)
    assert again is ts and cache.stats.selection_hits == 1
    # the tuned solver is bitwise a plan built with the tuned pick
    ref = TriangularSolver.plan(t, strategy=sel.strategy, options=sel.options, device="cpu",
                                backend="scan")
    b = np.random.default_rng(2).standard_normal((t.n_rows, 3))
    assert torch.equal(ts.solve(b), ref.solve(b))
    # the tuned and the model-based selections keep separate memo entries
    # (the plan itself may hit the tuned entry: the key is the concrete pick)
    TriangularSolver.plan(t, strategy="auto", device="cpu", cache=cache, mode=mode)
    assert cache.stats.selections == 2


def test_tune_trial_failure_fails_the_plan(monkeypatch):
    _, t = _pair("chain")

    def boom(self, b):
        raise RuntimeError("trial failed")

    monkeypatch.setattr(TriangularSolver, "solve", boom)
    with pytest.raises(RuntimeError, match="trial failed"):
        TriangularSolver.plan(t, strategy="auto", tune=True, device="cpu")


def test_tune_requires_auto():
    _, t = _pair("chain")
    with pytest.raises(ValueError, match="tune=True"):
        TriangularSolver.plan(t, strategy="growlocal", tune=True, device="cpu")
    sched = tauto.select_schedule(_dags("chain")[1])[1]
    with pytest.raises(ValueError, match="tune=True"):
        TriangularSolver.plan(t, strategy="auto", tune=True, sched=sched, device="cpu")


def test_auto_not_registerable():
    with pytest.raises(ValueError, match="reserved"):
        register_scheduler("auto")(lambda dag, o: None)
    with pytest.raises(ValueError, match="reserved"):
        register_scheduler("AUTO")(lambda dag, o: None)
    with pytest.raises(KeyError, match="meta-strategy"):
        get_scheduler("auto")
    with pytest.raises(KeyError, match="unknown strategy"):
        TriangularSolver.plan(_pair("chain")[1], strategy="nope", device="cpu")


def test_explicit_max_size_is_respected():
    _, t = _pair("er_dense")  # "mixed": funnel-gl is shortlisted
    f = tauto.matrix_features(t)
    default = {c.strategy: c.options for c in tauto.shortlist(f)}
    assert default["funnel-gl"].max_size == int(np.clip(2 * f.avg_wavefront, 16, 256))
    pinned = {c.strategy: c.options for c in tauto.shortlist(f, ScheduleOptions(max_size=33))}
    assert pinned["funnel-gl"].max_size == 33
    sel = TriangularSolver.plan(t, strategy="auto", max_size=33, device="cpu").selection
    assert {c.strategy: c.options.max_size for c in sel.candidates}["funnel-gl"] == 33


# ------------------------------------------------------------ sched=
@pytest.mark.parametrize("strategy", ["hdagg", "funnel-gl", "wavefront"])
@pytest.mark.parametrize("name", ["er_dense", "band_narrow", "poisson2d_ichol"])
def test_prebuilt_schedule_bitwise_vs_jax(name, strategy):
    j, t = _pair(name)
    js = jschedule(_dags(name)[0], 8, strategy=strategy)
    ts = schedule_from_numpy(js.n, js.k, js.pi, js.sigma, js.rank, js.n_supersteps)
    assert ts.pi.dtype == js.pi.dtype and ts.rank.dtype == js.rank.dtype
    jcache = JPlanCache()
    cache = PlanCache()
    jsol = JSolver.plan(j, sched=js, cache=jcache)
    tsol = TriangularSolver.plan(t, sched=ts, cache=cache, device="cpu")
    assert tsol.strategy == jsol.strategy == "(prebuilt)"
    assert tsol.plan_key is None and len(cache) == 0 and cache.stats.misses == 0
    assert tsol.selection is None and "selection" not in tsol.info()
    b = np.random.default_rng(3).standard_normal((t.n_rows, 2))
    _assert_bitwise(jsol.solve(b), tsol.solve(b))
