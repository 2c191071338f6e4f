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
    ``validate_chrome_trace``; on the same span records the port's events
    and payload equal the JAX exporter's (the E-before-B tie rule);
  * spans on the profiler's clock: under ``obs.tracing()`` and a CPU
    ``torch.profiler`` session, a solve and a ``cg_solve`` put each span
    into the profiler's trace as a ``user_annotation`` range inside its
    parent's, one for each ``SpanRecord``; with tracing off, none;
  * the ordered front door (the card's path, its launch faked on the CPU):
    ``executor.solve`` -> ``kernel.solve`` -> ``kernel.launch`` of an
    ordered kind, one launch with the solve's m, grid and tensors, and no
    ``executor.permute`` / ``executor.unpermute``.
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
    # the kernel backend's cast, padding and launch are a kernel.solve span
    cats = ["executor"] if backend == "scan" else ["executor", "kernel"]
    assert report["n_pairs"] == len(names) == len(buf) and report["cats"] == cats
    assert loaded["counters"] == {"solves": 1}


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


FRONT_DOOR = {"executor.solve", "executor.permute", "executor.unpermute", "kernel.solve"}
CG = {"cg.solve", "cg.bind", "cg.matvec", "cg.precond", "cg.update", "cg.converged"}


def _solve_case():
    s = _plan("kernel", "bsp")
    b = _rhs(s.n, None)
    return lambda: s.solve(b), FRONT_DOOR


def _cg_case():
    from repro_torch import factor_pair
    from repro_torch.solver.cg import cg_solve
    from repro_torch.sparse import ichol0, poisson2d_matrix

    a = poisson2d_matrix(8)
    fwd, bwd = factor_pair(ichol0(a), device="cpu")
    b = _rhs(64, None)
    return (lambda: cg_solve(a, b, precond=lambda r: bwd(fwd(r)), device="cpu"),
            FRONT_DOOR | CG)


def _profiled(run, tmp_path):
    """``run()`` under a CPU profiler; the trace's user annotations."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _innermost_parents(intervals):
    """For (start, end) intervals sorted by start, longest first at a tie,
    the index of each one's innermost enclosing interval (None at the
    top)."""
    parents, stack = [], []
    for i, (a, b) in enumerate(intervals):
        while stack and not (a >= intervals[stack[-1]][0] and b <= intervals[stack[-1]][1]):
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return parents


@pytest.mark.parametrize("case", [_solve_case, _cg_case], ids=["solve", "cg"])
def test_spans_are_profiler_ranges_inside_their_parents(case, tmp_path):
    run, want = case()
    buf = obs.TraceBuffer("profiled")
    with obs.tracing(buf):
        events = _profiled(run, tmp_path)
    records = sorted(buf.spans(), key=lambda r: (r.t0_ns, r.t0_ns - r.t1_ns))
    events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    # one profiler range for each SpanRecord, in the same order
    assert [e["name"] for e in events] == [r.name for r in records]
    assert {r.name for r in records} == want
    # each range lies inside the range of its record's parent span
    parents = _innermost_parents([(r.t0_ns, r.t1_ns) for r in records])
    assert parents[0] is None and all(p is not None for p in parents[1:])
    for e, p in zip(events, parents):
        if p is not None:
            outer = events[p]
            assert float(outer["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= float(outer["ts"]) + float(outer["dur"])
    by_name = {}
    for r, p in zip(records, parents):
        by_name.setdefault(r.name, set()).add(None if p is None else records[p].name)
    assert by_name["executor.permute"] == by_name["kernel.solve"] == {"executor.solve"}
    if "cg.solve" in want:
        assert by_name["executor.solve"] == {"cg.precond"}
        assert by_name["cg.bind"] == by_name["cg.matvec"] == {"cg.solve"}
        iters = [r.args["iters"] for r in records if r.name == "cg.solve"]
        assert iters == [sum(r.name == "cg.matvec" for r in records)] and iters[0] > 1


@pytest.mark.parametrize("case", [_solve_case, _cg_case], ids=["solve", "cg"])
def test_tracing_off_puts_no_span_in_the_profile(case, tmp_path):
    run, _ = case()
    assert not obs.is_enabled()
    recorded = len(obs.get_buffer("default"))
    events = _profiled(run, tmp_path)
    assert events == []
    assert obs.span("executor.solve", n=1) is obs.NULL_SPAN
    assert len(obs.get_buffer("default")) == recorded


def test_front_door_span_holds_the_check_of_b():
    s = _plan("kernel", "bsp")
    buf = obs.TraceBuffer("bad-b")
    with obs.tracing(buf), pytest.raises(ValueError):
        s.solve(np.zeros(s.n + 1))
    assert [(r.name, r.args.get("error")) for r in buf.spans()] == [
        ("executor.solve", "ValueError")]


@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize("mode", ["bsp", "elastic"])
def test_ordered_front_door_nests_one_launch(monkeypatch, mode, m):
    """The front door's ordered solve, which runs on the card: here its
    bound takes the row order on the CPU and the C entry is a stand-in, so
    the spans of the one path are those the card records."""
    import contextlib
    import types

    from repro_torch.backends.kernel import _KernelBound
    from repro_torch.kernels import sptrsv

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    # the bound's device test passed over: on the CPU it keeps the gathers
    monkeypatch.setattr(_KernelBound, "take_row_order", _KernelBound._bind_row_order)
    monkeypatch.setattr(sptrsv, "_entry", lambda kind, dtype: entry)
    monkeypatch.setattr(sptrsv, "_ordered_blocks", lambda *key: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    s = _plan("kernel", mode)
    assert s.info()["binding"]["front_door"] == "ordered"
    b = _rhs(s.n, m)
    sptrsv.reset_launches()
    buf = obs.TraceBuffer("ordered")
    with obs.tracing(buf):
        x = s.solve(b)
    assert x.shape == b.shape and x.dtype == s.dtype
    kind = ("elastic_" if mode == "elastic" else "") + (
        "ordered_single" if m is None else "ordered_mrhs")
    assert {k: v for k, v in sptrsv.launches.items() if v} == {kind: 1} and len(calls) == 1
    # m, the grid (at least sptrsv.ORDERED_SPREAD blocks), n, the permutation
    # bound once, then b and x as the caller holds them
    walk = s.bound._walk
    assert calls[0][:13] == walk.args
    assert calls[0][13:17] == (1 if m is None else m, sptrsv.ORDERED_SPREAD, s.n, walk.perm)
    assert calls[0][18] == x.data_ptr() and len(calls[0]) == 21
    records = sorted(buf.spans(), key=lambda r: (r.t0_ns, r.t0_ns - r.t1_ns))
    assert [r.name for r in records] == ["executor.solve", "kernel.solve", "kernel.launch"]
    assert _innermost_parents([(r.t0_ns, r.t1_ns) for r in records]) == [None, 0, 1]
    assert records[2].args["kind"] == kind
