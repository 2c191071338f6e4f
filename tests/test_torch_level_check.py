"""The level-order checker (``repro_torch.analysis.level_check``), on the
CPU: the order the CUDA kernels walk, audited independently of
``kernels/levels.py``, which builds it.

  * every corpus plan's level order verifies clean at ``fast`` and
    ``full``: over runs of 1 superstep (the bulk kernels), of the elastic
    certificate's slack, and of at least the superstep count (the whole
    DAG's wavefront order);
  * each ``levels`` mutation is caught at ``full``, and the structural
    ones (``levels_shift_run``, ``levels_move_finish``) already at
    ``fast``; hand-made faults each raise their own code;
  * the checker imports nothing of ``kernels/levels.py`` (AST);
  * property: random DAGs from ``erdos_renyi_lower`` verify clean.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
from _hyp import given, settings, strategies as st

from repro_torch.analysis import mutate
from repro_torch.analysis.level_check import verify_level_order
from repro_torch.analysis.mutate import MUTATIONS, build_artifacts
from repro_torch.autotune import corpus_entry, corpus_names
from repro_torch.core import DEFAULT_SLACK
from repro_torch.kernels.levels import level_order
from repro_torch.sparse import erdos_renyi_lower, narrow_band_lower

CHECKER = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "analysis" / "level_check.py"


def _codes(found):
    return sorted({f.code for f in found})


@pytest.mark.parametrize("strategy", ["growlocal", "wavefront", "hdagg"])
@pytest.mark.parametrize("name", corpus_names())
def test_corpus_orders_verify_clean(name, strategy):
    art = build_artifacts(corpus_entry(name).matrix(), strategy=strategy, k=8,
                          levels=False)
    plan = art.plan
    for slack in (1, DEFAULT_SLACK, max(plan.n_supersteps, 1)):
        order = level_order(plan, slack)
        for level in ("fast", "full"):
            found = verify_level_order(plan, order, level=level, slack=slack)
            assert not found, (name, strategy, slack, level, _codes(found))


def test_slack_defaults_to_the_bind():
    art = build_artifacts(narrow_band_lower(300, 0.14, 10, seed=1), k=8, slack=3)
    plan = art.plan
    assert plan.elastic is not None and plan.elastic.slack == 3
    assert not verify_level_order(plan, level_order(plan, 3), level="full")
    # a bulk order handed to the elastic bind walks the wrong runs
    assert "LEVEL_SLACK" in _codes(verify_level_order(plan, level_order(plan), level="fast"))
    plan.elastic = None
    assert not verify_level_order(plan, level_order(plan), level="full")


@pytest.fixture(scope="module")
def level_sets():
    """Artifact sets where every ``levels`` operator has a site: wide ER
    plans (same-run dependent levels) and a width-2 band (accum chains)."""
    return [
        ("er_dense/growlocal", build_artifacts(
            corpus_entry("er_dense").matrix(), strategy="growlocal", k=8)),
        ("band_narrow/w2", build_artifacts(
            corpus_entry("band_narrow").matrix(), strategy="growlocal", k=8, width=2)),
        ("band/wavefront/w3", build_artifacts(
            narrow_band_lower(400, 0.14, 10, seed=2), strategy="wavefront", k=4, width=3)),
    ]


_STRUCTURAL = {"levels_shift_run", "levels_move_finish"}


@pytest.mark.parametrize("op", [m.name for m in MUTATIONS if m.family == "levels"])
def test_levels_mutation_caught(level_sets, op):
    apply = getattr(mutate, op)
    applied = 0
    for label, art in level_sets:
        bad = apply(art, np.random.default_rng(0))
        if bad is None:
            continue
        applied += 1
        full = verify_level_order(bad.plan, bad.levels, level="full", slack=1)
        fast = verify_level_order(bad.plan, bad.levels, level="fast", slack=1)
        assert full, (op, label)
        assert all(c.startswith("LEVEL_") for c in _codes(full))
        if op in _STRUCTURAL:
            assert fast, (op, label)
        else:  # only the O(lane-steps x W) proofs see these
            assert not fast, (op, label, _codes(fast))
    assert applied, op


def _faults(order, plan):
    """Hand-made faults, one code each."""
    pad = np.flatnonzero(plan.row_ids.reshape(-1) == plan.n)
    out = {
        "LEVEL_SLACK": order._replace(slack=order.slack + 1),
        "LEVEL_PTR": order._replace(level_ptr=order.level_ptr[:-1]),
        "LEVEL_RUN_ORDER": order._replace(
            level_run=np.concatenate([order.level_run[1:], order.level_run[:1]])),
    }
    if pad.size:
        perm = order.perm.copy()
        perm[-1] = pad[0]  # a padding lane-step in place of a real one
        out["LEVEL_PERM"] = order._replace(perm=perm)
    return out


def test_hand_made_faults_have_their_codes():
    art = build_artifacts(narrow_band_lower(300, 0.14, 10, seed=1), strategy="wavefront",
                          k=8, levels=False)
    plan = art.plan
    order = level_order(plan)
    for code, bad in _faults(order, plan).items():
        found = verify_level_order(plan, bad, level="full", slack=1)
        assert code in _codes(found), (code, _codes(found))
    # a row read at the level that finishes it: move the first vertex of a
    # level that reads a row of the level before (same run) down into it
    art = build_artifacts(narrow_band_lower(300, 0.14, 10, seed=1), strategy="growlocal",
                          k=8, levels=False)
    plan = art.plan
    order = level_order(plan)
    lp, vp, perm = order.level_ptr, order.vert_ptr, order.perm
    rows = plan.row_ids.reshape(-1)
    fin = ~plan.accum.reshape(-1)
    cols = plan.col_idx.reshape(-1, plan.W)
    moved = 0
    for g in range(1, order.n_levels):
        if order.level_run[g] != order.level_run[g - 1]:
            continue
        prev = perm[vp[lp[g - 1]]:vp[lp[g]]]
        finished = set(rows[prev[fin[prev]]].tolist())
        v = int(lp[g])
        if not finished & set(cols[perm[vp[v]:vp[v + 1]]].ravel().tolist()):
            continue
        ptr = lp.copy()
        ptr[g] = v + 1
        if ptr[g] == ptr[g + 1]:
            continue  # a level of one vertex would vanish: LEVEL_PTR instead
        bad = order._replace(level_ptr=ptr)
        assert "LEVEL_READ_BEFORE_WRITE" in _codes(
            verify_level_order(plan, bad, level="full", slack=1))
        assert not verify_level_order(plan, bad, level="fast", slack=1)
        moved += 1
    assert moved


def test_checker_imports_nothing_of_levels():
    tree = ast.parse(CHECKER.read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert mods, "no imports parsed"
    assert not [m for m in mods if "kernels" in m or "levels" in m.split(".")], mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro", "torch")], mods


@settings(max_examples=20, deadline=None)
@given(
    n=st.integers(min_value=1, max_value=250),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    dens=st.sampled_from((0.01, 0.03, 0.08)),
    k=st.sampled_from((1, 4, 8)),
    width=st.sampled_from((None, 1, 2)),
    slack=st.integers(min_value=1, max_value=6),
)
def test_property_random_dags_verify_clean(n, seed, dens, k, width, slack):
    art = build_artifacts(erdos_renyi_lower(n, dens, seed=seed), strategy="growlocal", k=k,
                          width=width, levels=False)
    for s in (1, slack):
        order = level_order(art.plan, s)
        found = verify_level_order(art.plan, order, level="full", slack=s)
        assert not found, _codes(found)
