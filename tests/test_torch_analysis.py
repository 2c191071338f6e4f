"""``repro_torch.analysis`` — the port's static verifier, against the JAX
package's ``repro.analysis`` on the CPU. Findings are discrete, so every
comparison is exact equality:

  * **against JAX** — on ``launch.check``'s smoke grid (3 matrices x 2
    strategies x lower/upper x bsp/elastic x 1/4 shards), at ``fast`` and
    ``full``, the port's ``Report.codes()`` and ``checks_run`` equal JAX's
    on the same matrix (``checks_run`` plus ``"levels"`` where the port
    also checks its level orders);
  * **clean, and the harness agrees** — the artifact sets of
    ``tests/test_analysis.py``'s grid verify clean at both levels; the
    port's ``run_harness`` rows equal JAX's row for row on the 18 shared
    operators, and every ``levels`` operator is caught;
  * **``plan(validate=)``** — it gates (``VerificationError`` carrying
    the findings table, before the rebase and after the bind), honours
    ``REPRO_VALIDATE``, rejects a bogus level before any scheduling (also
    with ``strategy="auto"``), leaves cache hits unverified, and moves
    the ``analysis.*`` obs counters;
  * a corpus-wide sweep, marked ``slow`` as JAX's is.
"""
import dataclasses

import numpy as np
import pytest

import repro.analysis as janalysis
import repro.autotune as jautotune
from repro.analysis.mutate import build_artifacts as jbuild_artifacts
from repro.analysis.mutate import run_harness as jrun_harness
from repro.sparse.csr import transpose_csr as jtranspose
import repro_torch
from repro_torch import obs
from repro_torch.analysis import (
    Artifacts,
    VerificationError,
    resolve_level,
    verify_artifacts,
)
from repro_torch.analysis import mutate
from repro_torch.analysis.mutate import MUTATIONS, build_artifacts, run_harness
from repro_torch.autotune import corpus_entry
from repro_torch.kernels import ops
from repro_torch.pipeline import PlanCache
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower
from repro_torch.sparse.csr import transpose_csr

# the smoke grid of launch.check (both packages')
_SMOKE = [(m, s) for m in ("er_dense", "band_narrow", "chain")
          for s in ("growlocal", "wavefront")]

# tests/test_analysis.py's harness grid
_GRID = [
    ("er_dense", "growlocal", dict(slack=4, n_shards=4)),
    ("band_narrow", "growlocal", dict(slack=4, n_shards=4, width=2)),
    ("er_dense", "wavefront", dict(slack=0, n_shards=4)),
    ("chain", "growlocal", dict(slack=2, n_shards=2)),
]


@pytest.fixture(scope="module")
def artifact_sets():
    return [
        (f"{name}/{strategy}", build_artifacts(
            corpus_entry(name).matrix(), strategy=strategy, k=8, **kw
        ))
        for name, strategy, kw in _GRID
    ]


@pytest.fixture(scope="module")
def jax_artifact_sets():
    return [
        (f"{name}/{strategy}", jbuild_artifacts(
            jautotune.corpus_entry(name).matrix(), strategy=strategy, k=8, **kw
        ))
        for name, strategy, kw in _GRID
    ]


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("level", ["fast", "full"])
@pytest.mark.parametrize("name,strategy", _SMOKE)
def test_smoke_grid_findings_equal_jax(name, strategy, level):
    a = corpus_entry(name).matrix()
    ja = jautotune.corpus_entry(name).matrix()
    for orient in ("lower", "upper"):
        lower = orient == "lower"
        mat = a if lower else transpose_csr(a)
        jmat = ja if lower else jtranspose(ja)
        for slack in (0, 4):
            for ns in (1, 4):
                kw = dict(strategy=strategy, k=8, lower=lower, slack=slack, n_shards=ns)
                jrep = janalysis.verify_artifacts(jbuild_artifacts(jmat, **kw), level=level)
                bare = verify_artifacts(build_artifacts(mat, levels=False, **kw), level=level)
                full = verify_artifacts(build_artifacts(mat, **kw), level=level)
                cell = (orient, slack, ns)
                assert bare.codes() == jrep.codes() == full.codes(), cell
                assert bare.checks_run == jrep.checks_run, cell
                assert full.checks_run == jrep.checks_run + ["levels"], cell
                assert full.ok, (cell, full.table())


# ------------------------------------------------------ clean + harness

@pytest.mark.parametrize("level", ["fast", "full"])
def test_pristine_artifacts_verify_clean(artifact_sets, level):
    for label, art in artifact_sets:
        rep = verify_artifacts(art, level=level)
        assert rep.ok, (label, level, rep.table())
        expect = {"schedule", "reorder", "plan", "elastic", "rowshard", "levels"}
        if art.elastic is None:
            expect.discard("elastic")
            assert art.elastic_levels is None
        assert expect <= set(rep.checks_run), (label, rep.checks_run)


def test_harness_rows_equal_jax_and_levels_caught(artifact_sets, jax_artifact_sets):
    rows = run_harness(artifact_sets)
    jrows = jrun_harness(jax_artifact_sets)
    shared = [r for r in rows if r["family"] != "levels"]
    assert len({r["mutation"] for r in shared}) == 18
    assert shared == jrows
    levels = [r for r in rows if r["family"] == "levels"]
    ops_ = {r["mutation"] for r in levels}
    assert len(ops_) >= 3 and ops_ == {m.name for m in MUTATIONS if m.family == "levels"}
    for op in ops_:
        hits = [r for r in levels if r["mutation"] == op and r["caught"] is not None]
        assert hits, f"{op}: no applicable artifact set"
        assert all(r["caught"] for r in hits), (op, hits)
        assert all(c.startswith("LEVEL_") for r in hits for c in r["codes"]), hits


def test_verifier_is_deterministic(artifact_sets):
    for label, art in artifact_sets:
        assert (verify_artifacts(art, level="full").as_dict()
                == verify_artifacts(art, level="full").as_dict()), label
    bad = mutate.levels_merge_dependent(artifact_sets[0][1], np.random.default_rng(3))
    assert bad is not None
    r1, r2 = (verify_artifacts(bad, level="full") for _ in range(2))
    assert [f.as_dict() for f in r1.findings] == [f.as_dict() for f in r2.findings]


def test_level_off_is_inert():
    rep = verify_artifacts(Artifacts(L=None, sched=None, plan=None), level="off")
    assert rep.ok and not rep.checks_run


# ---------------------------------------------------------------- wiring

@pytest.mark.parametrize("mode", ["bsp", "elastic"])
def test_plan_validate_gates_and_env(monkeypatch, mode):
    a = erdos_renyi_lower(120, 0.04, seed=9)
    s = repro_torch.TriangularSolver.plan(a, k=8, validate="full", mode=mode, device="cpu")
    x = s.solve(np.ones(120)).numpy()
    assert np.isfinite(x).all()
    plain = repro_torch.TriangularSolver.plan(a, k=8, mode=mode, device="cpu")
    assert np.array_equal(x, plain.solve(np.ones(120)).numpy())
    with pytest.raises(ValueError, match="validate"):
        repro_torch.TriangularSolver.plan(a, k=8, validate="bogus", device="cpu")
    monkeypatch.setenv("REPRO_VALIDATE", "fast")
    assert resolve_level(None) == "fast"
    assert resolve_level("off") == "off"  # explicit arg wins
    buf = obs.TraceBuffer("validate-env")
    with obs.tracing(buf):
        repro_torch.TriangularSolver.plan(a, k=8, mode=mode, device="cpu")
    # the build verification and the post-bind level check
    assert buf.counters().get("analysis.verifications") == 2
    names = [sp.name for sp in buf.spans()]
    assert "analysis.verify" in names and "analysis.verify.levels" in names
    monkeypatch.setenv("REPRO_VALIDATE", "nope")
    with pytest.raises(ValueError, match="validate"):
        repro_torch.TriangularSolver.plan(a, k=8, device="cpu")


@pytest.mark.parametrize("strategy", ["growlocal", "auto"])
def test_bogus_level_raises_before_scheduling(monkeypatch, strategy):
    import repro_torch.pipeline.solver as psolver

    def boom(*a, **k):
        raise AssertionError("scheduling work ran before the level was resolved")

    monkeypatch.setattr(psolver, "get_scheduler", boom)
    monkeypatch.setattr(psolver, "pattern_fingerprint", boom)
    a = erdos_renyi_lower(60, 0.05, seed=1)
    with pytest.raises(ValueError, match="validate"):
        repro_torch.TriangularSolver.plan(a, strategy=strategy, validate="sometimes",
                                          device="cpu")


def test_build_finding_raises_with_table(monkeypatch):
    """A corrupt compiled plan is refused before the value-source rebase
    and before any bind: the error carries the report and its table."""
    import repro_torch.pipeline.solver as psolver

    real = psolver.compile_plan

    def corrupt(*a, **k):
        p = real(*a, **k)
        final = (p.row_ids != p.n) & ~p.accum
        t, lane = (int(i[0]) for i in np.nonzero(final))
        p.diag[t, lane] = 0.0
        return p

    monkeypatch.setattr(psolver, "compile_plan", corrupt)
    a = narrow_band_lower(100, 0.15, 4, seed=3)
    with pytest.raises(VerificationError) as ei:
        repro_torch.TriangularSolver.plan(a, k=8, validate="fast", device="cpu")
    assert "PLAN_ZERO_DIAG" in str(ei.value)
    assert ei.value.report.codes() == ("PLAN_ZERO_DIAG",)
    assert ei.value.report.table() in str(ei.value)


@pytest.mark.parametrize("op,level", [
    ("levels_shift_run", "fast"), ("levels_move_finish", "fast"),
    ("levels_merge_dependent", "full"), ("levels_reverse_chain", "full"),
])
@pytest.mark.parametrize("mode", ["bsp", "elastic"])
def test_bound_level_order_is_checked(monkeypatch, op, level, mode):
    """The post-bind hook audits the order the kernel bound holds: a bind
    that builds a corrupt order is refused."""
    real = ops.level_order
    apply = getattr(mutate, op)

    def corrupt(plan, slack=1):
        order = real(plan, slack)
        art = Artifacts(L=None, sched=None, plan=plan, levels=order)
        bad = apply(art, np.random.default_rng(0))
        assert bad is not None, op
        return bad.levels

    monkeypatch.setattr(ops, "level_order", corrupt)
    a = narrow_band_lower(300, 0.14, 10, seed=1)
    with pytest.raises(VerificationError) as ei:
        repro_torch.TriangularSolver.plan(a, k=8, width=2, mode=mode, validate=level,
                                          device="cpu")
    assert ei.value.report.checks_run == ["levels"]
    assert all(c.startswith("LEVEL_") for c in ei.value.report.codes())
    # the scan backend binds no level order: nothing to check there
    repro_torch.TriangularSolver.plan(a, k=8, width=2, mode=mode, validate=level,
                                      backend="scan", device="cpu")


def test_cache_hit_not_reverified():
    a = erdos_renyi_lower(150, 0.03, seed=4)
    cache = PlanCache()
    buf = obs.TraceBuffer("validate-cache")
    with obs.tracing(buf):
        s1 = repro_torch.TriangularSolver.plan(a, k=8, cache=cache, validate="full",
                                               device="cpu")
        n1 = buf.counters().get("analysis.verifications")
        s2 = repro_torch.TriangularSolver.plan(a, k=8, cache=cache, validate="full",
                                               device="cpu")
        # validate is not part of the key: an unvalidated plan hits too
        s3 = repro_torch.TriangularSolver.plan(a, k=8, cache=cache, device="cpu")
    assert n1 == 2
    assert buf.counters().get("analysis.verifications") == 2
    assert s1 is s2 is s3
    assert cache.stats.hits == 2 and cache.stats.misses == 1


def test_factor_pair_passes_validate(monkeypatch):
    a = narrow_band_lower(120, 0.15, 5, seed=2)
    buf = obs.TraceBuffer("validate-pair")
    with obs.tracing(buf):
        repro_torch.factor_pair(a, validate="fast", device="cpu")
    assert buf.counters().get("analysis.verifications") == 4


def test_obs_counters_increment():
    a = narrow_band_lower(100, 0.15, 4, seed=3)
    art = build_artifacts(a, strategy="growlocal", k=8)
    buf = obs.TraceBuffer("analysis-test")
    with obs.tracing(buf):
        verify_artifacts(art, level="fast")
        bad = mutate.levels_shift_run(art, np.random.default_rng(0))
        rep = verify_artifacts(bad, level="fast")
    assert buf.counters().get("analysis.verifications") == 2
    assert buf.counters().get("analysis.findings") == len(rep.findings) >= 1
    spans = [s for s in buf.spans() if s.name == "analysis.verify"]
    assert [s.args.get("ok") for s in spans] == [True, False]


def test_degenerate_shapes_verify_clean():
    from repro_torch.sparse import csr_from_dense

    for a, strategy, k, ns in (
        (csr_from_dense(np.array([[2.0]])), "serial", 8, 1),
        (narrow_band_lower(60, 0.2, 3, seed=5), "serial", 1, 1),
        (erdos_renyi_lower(80, 0.05, seed=7), "growlocal", 8, 1),
    ):
        art = build_artifacts(a, strategy=strategy, k=k, n_shards=ns, slack=2)
        for level in ("fast", "full"):
            rep = verify_artifacts(art, level=level)
            assert rep.ok, rep.table()


# -------------------------------------------------- slow: corpus depth

@pytest.mark.slow
def test_full_corpus_sweep_clean():
    """launch.check's grid, as a pytest: every corpus matrix x all
    strategies x orientations x modes x shard counts verifies clean at
    level="full", level orders included."""
    from repro_torch.autotune import corpus_names
    from repro_torch.launch.check import sweep_cells
    from repro_torch.pipeline.registry import available_strategies

    rows = sweep_cells(
        matrices=corpus_names(),
        strategies=tuple(s for s in available_strategies() if s != "auto"),
        level="full",
    )
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad[:5]
    assert len(rows) == 9 * 7 * 2 * 2 * 2


def test_artifacts_dataclass_extends_jax():
    jf = [f.name for f in dataclasses.fields(janalysis.Artifacts)]
    pf = [f.name for f in dataclasses.fields(Artifacts)]
    assert pf == jf + ["levels", "elastic_levels"]
    assert repro_torch.analysis.VALIDATE_LEVELS == janalysis.VALIDATE_LEVELS
