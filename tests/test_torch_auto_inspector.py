"""An auto plan's selection counted as inspector work (CPU).

``TriangularSolver.plan(strategy="auto")``, on a fresh selection, puts the
selector's seconds (the DAG, the features, every shortlisted candidate's
schedule) into ``inspector_seconds`` and, on their own, into
``selection_seconds``; a fixed strategy and a memo hit read 0.0 and build
as before. The selection runs inside an ``autotune.resolve`` span, its DAG
build inside ``inspector.dag``. At the benchmark's ``nb100k`` small size,
auto binds the elastic level walk.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import PlanCache, TriangularSolver, obs
from repro_torch.autotune import clear_selection_memo
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_memo():
    clear_selection_memo()
    yield
    clear_selection_memo()


def _band(n=800, seed=103):
    return narrow_band_lower(n, 0.14, 10, seed=seed)


def _traced(fn):
    buf = obs.TraceBuffer("auto-inspector")
    with obs.tracing(buf):
        out = fn()
    return out, buf.spans()


def test_a_fresh_auto_plan_counts_its_selection():
    s = TriangularSolver.plan(_band(), strategy="auto", device="cpu")
    assert s.inspector_seconds >= s.selection_seconds > 0.0
    info = s.info()
    assert info["selection_seconds"] == s.selection_seconds
    assert info["inspector_seconds"] == s.inspector_seconds


def test_a_tuned_auto_plan_counts_its_trials():
    s = TriangularSolver.plan(erdos_renyi_lower(300, 1e-2, seed=4), strategy="auto",
                              tune=True, device="cpu")
    assert s.selection.tuned
    # the winner was built inside the selection's trials
    assert s.inspector_seconds == s.selection_seconds > 0.0


@pytest.mark.parametrize("how", ["fixed", "memo", "cache_memo"])
def test_no_fresh_selection_reads_zero_and_builds_as_before(how):
    L = _band()
    if how == "fixed":
        kw = {"strategy": "growlocal"}
    elif how == "memo":  # the module-level memo, no plan cache
        kw = {"strategy": "auto"}
        TriangularSolver.plan(L, device="cpu", **kw)
    else:  # the selection kept in the plan cache, the plan evicted
        kw = {"strategy": "auto", "cache": PlanCache(maxsize=1)}
        TriangularSolver.plan(L, device="cpu", **kw)
        TriangularSolver.plan(_band(seed=5), strategy="growlocal", device="cpu",
                              cache=kw["cache"])
    s, spans = _traced(lambda: TriangularSolver.plan(L, device="cpu", **kw))
    assert s.selection_seconds == 0.0 and s.info()["selection_seconds"] == 0.0
    names = [r.name for r in spans]
    assert not [n for n in names if n.startswith("autotune.")]
    # the build ran the DAG and the winner's schedule itself, as before
    assert "inspector.dag" in names and f"inspector.schedule.{s.strategy}" in names
    assert s.inspector_seconds > 0.0


def test_a_plan_cache_hit_keeps_the_record_of_its_build():
    # cached solvers are never mutated: like ``selection``, the seconds
    # describe the build of the solver handed back
    L, cache = _band(), PlanCache()
    first = TriangularSolver.plan(L, strategy="auto", device="cpu", cache=cache)
    again = TriangularSolver.plan(L, strategy="auto", device="cpu", cache=cache)
    assert again is first and again.selection_seconds > 0.0
    # an entry a fixed-strategy plan built reads 0.0, though a selection ran
    clear_selection_memo()
    cache = PlanCache()
    fixed = TriangularSolver.plan(L, strategy=first.strategy, options=first.selection.options,
                                  device="cpu", cache=cache)
    hit = TriangularSolver.plan(L, strategy="auto", device="cpu", cache=cache)
    assert hit is fixed and hit.selection is None and hit.selection_seconds == 0.0


def test_the_selection_is_a_span_with_its_dag_inside():
    s, spans = _traced(lambda: TriangularSolver.plan(_band(), strategy="auto", device="cpu"))
    by_name = {}
    for r in spans:
        by_name.setdefault(r.name, []).append(r)
    (res,) = by_name["autotune.resolve"]
    assert res.cat == "autotune"
    assert res.args["strategy"] == s.strategy and res.args["regime"] == s.selection.regime
    assert res.args["slack"] == s.info()["slack"]
    # one DAG build, the selector's: the build reuses the winner's schedule
    (dag,) = by_name["inspector.dag"]
    assert dag.cat == "inspector" and res.t0_ns <= dag.t0_ns <= dag.t1_ns <= res.t1_ns
    assert not [n for n in by_name if n.startswith("inspector.schedule.")]
    assert res.t1_ns - res.t0_ns <= s.selection_seconds * 1e9


def test_at_nb100ks_small_size_auto_binds_the_elastic_walk():
    cfg = json.loads((ROOT / "portbench" / "configs" / "nb100k.json").read_text())
    assert cfg["plan"] == {"strategy": "auto"} and cfg["dtype"] == "float64"
    size = {**cfg, **cfg["test_sizes"]["small"]}
    L = narrow_band_lower(size["n"], size["p"], size["band"], seed=size["pattern_seed"])
    s = TriangularSolver.plan(L, strategy="auto", device="cpu", dtype=torch.float64)
    info = s.info()
    assert info["mode"] == "elastic" and info["slack"] == 8
    assert info["slack_unit"] == "supersteps" and info["backend"] == "kernel"
    assert s.selection.regime == "banded"
    # the walk solves in float64: bitwise the bulk-synchronous plan of the pick
    bsp = TriangularSolver.plan(L, strategy=s.strategy, options=s.selection.options.replace(
        slack=0), device="cpu", dtype=torch.float64)
    b = np.random.default_rng(2).standard_normal(L.n_rows)
    assert torch.equal(s.solve(b), bsp.solve(b))
