"""Timed solves and trace export of the port, against the JAX package
(CPU).

  * ``solve_timed`` / ``timed=True`` on both port backends, bulk and
    elastic, one and m right-hand sides: x bitwise the untimed solve's;
    the scan backend times one segment per non-empty superstep (bulk) and
    per macro-step (elastic; as many as the JAX certificate's
    ``n_macro_steps`` and the JAX timed solve's steps, with the same bits),
    the kernel backend one step per launch;
  * the toggle is not part of the cache key, ``info()["timed"]``, the
    runtime counters (and ``update_values`` starting a new history);
  * ``obs.export``: a timed solve's Chrome trace round-trips through
    ``validate_chrome_trace``; on the same span records the port's events,
    payload and ``metrics_rows`` equal the JAX exporter's (the E-before-B
    tie rule and the ``repro-bench-rows/v1`` row shape).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sparse as jsparse
from repro import obs as jobs
from repro.pipeline import TriangularSolver as JSolver
from repro.solver.executor import elastic_plan_arrays as jelastic_plan_arrays
from repro.solver.executor import solve_with_elastic_timed as jsolve_elastic_timed
from repro_torch import PlanCache, TriangularSolver, obs
from repro_torch.sparse import CSRMatrix

SLACK = 3


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.disable()
    yield
    obs.disable()


def _jax_matrix():
    return jsparse.narrow_band_lower(240, 0.14, 6.0, seed=3)


def _matrix():
    m = _jax_matrix()
    return CSRMatrix(m.n_rows, m.n_cols, m.indptr, m.indices, m.data)


def _rhs(n, m, seed=0):
    return np.random.default_rng(seed).standard_normal(n if m is None else (n, m))


def _plan(backend, mode, **kw):
    return TriangularSolver.plan(_matrix(), device="cpu", backend=backend, mode=mode,
                                 slack=SLACK if mode == "elastic" else 0, **kw)


@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize("mode", ["bsp", "elastic"])
@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_timed_solve_is_bitwise_and_steps_match(backend, mode, m):
    s = _plan(backend, mode)
    b = _rhs(s.n, m)
    x = s.solve(b)
    xt, steps = s.solve_timed(b)
    assert torch.equal(xt, x) and s.last_step_timings == steps
    assert all(st["us"] >= 0 for st in steps)
    plan = s.exec_plan
    if backend == "kernel":  # one launch, timed as one step
        assert steps == [{"step": 0, "n_steps": None, "us": steps[0]["us"]}]
    elif mode == "bsp":
        sb = np.asarray(plan.step_bounds)
        assert [st["superstep"] for st in steps] == list(np.flatnonzero(np.diff(sb)))
        assert sum(st["n_steps"] for st in steps) == plan.n_steps
        assert plan.n_supersteps > 1
    else:
        jplan = JSolver.plan(_jax_matrix(), k=8).exec_plan
        n_macro = jcore.elastic_transform(jplan, SLACK).n_macro_steps
        assert [st["macro_step"] for st in steps] == list(range(n_macro))
        assert {st["n_steps"] for st in steps} == {SLACK}
    s.timed = True  # solve() now routes through solve_timed
    s.last_step_timings = None
    assert torch.equal(s.solve(b), x) and len(s.last_step_timings) == len(steps)


@pytest.mark.parametrize("m", [None, 2])
def test_elastic_timed_matches_jax_timed(m):
    jplan = JSolver.plan(_jax_matrix(), k=8).exec_plan
    b = _rhs(jplan.n, m, seed=5).astype(np.float32)
    x_j, steps_j = jsolve_elastic_timed(jelastic_plan_arrays(jplan, slack=SLACK), jnp.asarray(b))
    s = TriangularSolver.plan(_matrix(), device="cpu", backend="scan", slack=SLACK)
    # the front door permutes b; compare in plan order through the bound
    x, steps = s.bound.solve_timed(torch.from_numpy(b))
    assert len(steps) == len(steps_j)
    assert [st["macro_step"] for st in steps] == [st["macro_step"] for st in steps_j]
    assert np.array_equal(x.numpy().view(np.int32), np.asarray(x_j).view(np.int32))


def test_timed_toggle_is_not_in_the_cache_key():
    cache = PlanCache()
    s1 = TriangularSolver.plan(_matrix(), device="cpu", cache=cache)
    assert not s1.timed and s1.info()["timed"] is False
    s2 = TriangularSolver.plan(_matrix(), device="cpu", cache=cache, timed=True)
    assert s2 is s1 and s2.timed and s2.info()["timed"] is True
    s3 = TriangularSolver.plan(_matrix(), device="cpu", cache=cache)
    assert s3 is s1 and not s3.timed
    assert cache.stats.as_dict()["misses"] == 1 and cache.stats.as_dict()["hits"] == 2
    assert TriangularSolver.plan(_matrix(), device="cpu", timed=True).timed  # no cache


def test_factor_pair_takes_the_toggle():
    from repro_torch import factor_pair
    from repro_torch.sparse import ichol0, poisson2d_matrix

    fwd, bwd = factor_pair(ichol0(poisson2d_matrix(8)), device="cpu", backend="scan",
                           timed=True)
    r = _rhs(64, None)
    z = bwd(fwd(r))
    assert fwd.timed and bwd.timed and fwd.last_step_timings and bwd.last_step_timings
    fwd.timed = bwd.timed = False
    assert torch.equal(bwd(fwd(r)), z)


def test_scan_elastic_runtime_counters():
    s = _plan("scan", "elastic")
    rt = s.info()["binding"]["runtime"]
    assert rt["timed_solves"] == 0 and rt["macro_steps_executed"] == 0
    assert "macro_steps_per_solve" not in rt
    b = _rhs(s.n, None)
    _, steps = s.solve_timed(b)
    s.solve_timed(b)
    s.solve(b)  # untimed: not counted
    rt = s.info()["binding"]["runtime"]
    assert rt["timed_solves"] == 2 and rt["macro_steps_executed"] == 2 * len(steps)
    assert rt["macro_steps_per_solve"] == rt["predicted_macro_steps"] == len(steps)
    assert rt["predicted_barrier_fusion"] >= 1.0 and rt["predicted_step_fusion"] >= 1.0
    refreshed = s.bound.update_values(s.source_values * 2.0)
    assert refreshed.describe()["runtime"]["timed_solves"] == 0  # a new history
    assert s.info()["binding"]["runtime"]["timed_solves"] == 2  # the old one stays


@pytest.mark.parametrize("mode", ["bsp", "elastic"])
def test_kernel_runtime_counts_levels(mode):
    s = _plan("kernel", mode)
    d = s.bound.describe()
    assert d["runtime"] == {"timed_solves": 0, "levels_walked": 0,
                            "predicted_levels": d["n_levels"]}
    b = _rhs(s.n, 2)
    for _ in range(3):
        s.solve_timed(b)
    rt = s.info()["binding"]["runtime"]
    assert rt["timed_solves"] == 3 and rt["levels_walked"] == 3 * d["n_levels"]
    assert rt["levels_per_solve"] == d["n_levels"]
    assert not any(k.startswith("macro_steps") for k in rt)  # the kernel's own unit
    if mode == "elastic":
        assert s.info()["slack_unit"] == "supersteps"
    refreshed = s.bound.update_values(s.source_values * 2.0)
    assert refreshed.describe()["runtime"]["timed_solves"] == 0


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_timed_solve_trace_round_trips(tmp_path, backend):
    s = _plan(backend, "elastic", timed=True)
    buf = obs.TraceBuffer("timed")
    with obs.tracing(buf):
        s.solve(_rhs(s.n, None))
        obs.counter_add("solves", 1)
    path = tmp_path / "trace.json"
    payload = obs.export_chrome_trace(str(path), buf)
    assert payload["schema"] == obs.TRACE_SCHEMA == jobs.TRACE_SCHEMA
    loaded = obs.load_chrome_trace(str(path))
    assert loaded == json.loads(json.dumps(payload))
    report = obs.validate_chrome_trace(loaded)
    inner = "executor.macro_step" if backend == "scan" else "executor.solve_timed"
    names = [ev["name"] for ev in loaded["traceEvents"] if ev.get("ph") == "B"]
    assert names[0] == "executor.solve" and inner in names
    assert report["n_pairs"] == len(names) == len(buf) and report["cats"] == ["executor"]
    assert loaded["counters"] == {"solves": 1}
    rows = obs.metrics_rows(buf)
    assert ("obs.counter.solves", 1.0, "counter") in rows
    row = {name: (val, derived) for name, val, derived in rows}[f"obs.{inner}"]
    assert row[1] == f"count={names.count(inner)} total_us={buf.summary()['spans'][inner]['total_us']}"


def _same_records(port_buf, jax_buf):
    # nested and touching spans, with ties at one timestamp, on two threads
    spans = [("outer", "a", 7, 100, 400, {"n": 3}), ("inner", "b", 7, 100, 200, {}),
             ("next", "b", 7, 200, 300, {}), ("tail", "a", 7, 300, 400, {}),
             ("other", "c", 9, 150, 250, {"k": 1})]
    for name, cat, tid, t0, t1, args in spans:
        for buf, rec in ((port_buf, obs.SpanRecord), (jax_buf, jobs.SpanRecord)):
            buf.add_span(rec(name, cat, tid, f"thread-{tid}", t0, t1, dict(args)))
    for buf in (port_buf, jax_buf):
        buf.counter_add("hits", 4)


def test_exporter_matches_jax_on_the_same_records():
    buf, jbuf = obs.TraceBuffer("p"), jobs.TraceBuffer("j")
    _same_records(buf, jbuf)
    events = obs.chrome_trace_events(buf)
    assert events == jobs.chrome_trace_events(jbuf)
    # E before B at a tie, the inner span closing first
    at_200 = [(ev["ph"], ev["name"]) for ev in events if ev["ts"] == 0.2]
    assert at_200 == [("E", "inner"), ("B", "next")]
    payload, jpayload = obs.chrome_trace_payload(buf), jobs.chrome_trace_payload(jbuf)
    jpayload["summary"]["buffer"] = "p"
    assert payload == jpayload
    assert obs.validate_chrome_trace(payload) == jobs.validate_chrome_trace(jpayload)
    rows, jrows = obs.metrics_rows(buf), jobs.metrics_rows(jbuf)
    assert rows == jrows
    assert all(isinstance(n, str) and isinstance(v, float) and isinstance(d, str)
               for n, v, d in rows)


def test_validate_rejects_broken_traces():
    ok = {"traceEvents": [{"ph": "B", "name": "s", "tid": 1, "ts": 1.0},
                          {"ph": "E", "name": "s", "tid": 1, "ts": 2.0}]}
    assert obs.validate_chrome_trace(ok)["n_pairs"] == 1
    for bad in (
        [{"ph": "E", "name": "s", "tid": 1, "ts": 1.0}],  # E without B
        [{"ph": "B", "name": "s", "tid": 1, "ts": 1.0}],  # unclosed
        [{"ph": "B", "name": "s", "tid": 1, "ts": 2.0},  # not monotonic
         {"ph": "E", "name": "s", "tid": 1, "ts": 1.0}],
        [{"ph": "B", "name": "s", "tid": 1, "ts": 1.0},  # mismatched names
         {"ph": "E", "name": "t", "tid": 1, "ts": 2.0}],
    ):
        with pytest.raises(ValueError):
            obs.validate_chrome_trace({"traceEvents": bad})
        with pytest.raises(ValueError):
            jobs.validate_chrome_trace({"traceEvents": bad})
