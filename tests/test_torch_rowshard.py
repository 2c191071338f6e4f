"""The port's row partitioner (``repro_torch.core.rowshard``) against the
JAX package's: the same plan partitioned by both gives every
``RowShardPlan`` array equal in value and dtype — ownership, slots, each
shard's local plan, and both lowered forms of every halo round — on the
grid of ``tests/test_rowshard.py`` (n_shards 2, 3, 4, 8; per-superstep
exchanges and the elastic certificate's fused ``exchange_bounds``), plus
the partitioner's refusals."""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
from repro.pipeline.registry import ScheduleOptions as JOptions
from repro.pipeline.registry import get_scheduler as jget_scheduler
from repro.sparse import dag_from_lower_csr as jdag
from repro.sparse.generators import erdos_renyi_lower as jer
from repro.sparse.generators import narrow_band_lower as jnb
from repro_torch.convert import exec_plan_from_numpy
from repro_torch.core import HaloRound, RowShardPlan, elastic_transform, partition_plan

_PLAN_FIELDS = ("row_ids", "col_idx", "vals", "diag", "accum", "step_bounds",
                "val_src", "diag_src")

# (matrix, strategy, k): growlocal packs sparse ER into one superstep, so
# wavefront plans supply the multi-round exchanges
_MAKERS = {
    "er": (lambda: jer(400, 0.01, seed=7), "growlocal", 8),
    "er_wavefront": (lambda: jer(300, 0.02, seed=5), "wavefront", 8),
    "band": (lambda: jnb(400, 0.2, 6, seed=3), "growlocal", 8),
    "er_k6_wavefront": (lambda: jer(350, 0.015, seed=9), "wavefront", 6),
}


def _jax_plan(name):
    make, strategy, k = _MAKERS[name]
    L = make()
    s = jget_scheduler(strategy)(jdag(L), JOptions(k=k))
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    return jcore.compile_plan(L2, s2)


def _port_plan(jplan):
    return exec_plan_from_numpy(
        {f: np.asarray(getattr(jplan, f)) for f in _PLAN_FIELDS}
        | {"n": jplan.n, "k": jplan.k, "W": jplan.W}
    )


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _assert_same_partition(p, j):
    assert isinstance(p, RowShardPlan)
    for f in dataclasses.fields(j):
        name = f.name
        pv, jv = getattr(p, name), getattr(j, name)
        if name == "shards":
            assert len(pv) == len(jv)
            for i, (ps, js) in enumerate(zip(pv, jv)):
                assert (ps.n, ps.k, ps.W) == (js.n, js.k, js.W)
                for g in _PLAN_FIELDS:
                    _assert_same_array(getattr(ps, g), getattr(js, g), f"shard {i} {g}")
        elif name == "rounds":
            assert len(pv) == len(jv)
            for r, (pr, jr) in enumerate(zip(pv, jv)):
                assert isinstance(pr, HaloRound)
                assert (pr.buf_size, pr.n_values) == (jr.buf_size, jr.n_values)
                for g in ("send_slot", "send_pos", "recv_pos", "recv_slot"):
                    _assert_same_array(getattr(pr, g), getattr(jr, g), f"round {r} {g}")
                assert [h for h, _, _ in pr.hops] == [h for h, _, _ in jr.hops]
                for (h, pss, prt), (_, jss, jrt) in zip(pr.hops, jr.hops):
                    _assert_same_array(pss, jss, f"round {r} hop {h} send")
                    _assert_same_array(prt, jrt, f"round {r} hop {h} recv")
        elif isinstance(jv, np.ndarray):
            _assert_same_array(pv, jv, name)
        else:
            assert pv == jv and type(pv) is type(jv), (name, pv, jv)
    for prop in ("slots", "scratch", "n_rounds"):
        assert getattr(p, prop) == getattr(j, prop), prop
    _assert_same_array(p.b_scatter, j.b_scatter, "b_scatter")
    _assert_same_array(p.x_gather, j.x_gather, "x_gather")
    assert p.comm_stats() == j.comm_stats()


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
@pytest.mark.parametrize("fused", [False, True], ids=["per_superstep", "elastic"])
@pytest.mark.parametrize("name", list(_MAKERS))
def test_partition_equals_jax(name, fused, n_shards):
    jplan = _jax_plan(name)
    pplan = _port_plan(jplan)
    kw_j = kw_p = {}
    if fused:
        jb = tuple(int(x) for x in jcore.elastic_transform(jplan, 8).fused_bounds)
        pb = tuple(int(x) for x in elastic_transform(pplan, 8).fused_bounds)
        assert pb == jb
        kw_j, kw_p = {"exchange_bounds": jb}, {"exchange_bounds": pb}
    _assert_same_partition(
        partition_plan(pplan, n_shards, **kw_p), jcore.partition_plan(jplan, n_shards, **kw_j)
    )


def test_partition_refusals_match_jax():
    jplan = _jax_plan("er")
    pplan = _port_plan(jplan)
    S = pplan.n_supersteps
    for bad in [(0,), (1, S), (0, S + 1), (0, 0, S)]:
        with pytest.raises(ValueError):
            partition_plan(pplan, 2, exchange_bounds=bad)
        with pytest.raises(ValueError):
            jcore.partition_plan(jplan, 2, exchange_bounds=bad)
    with pytest.raises(ValueError, match="n_shards"):
        partition_plan(pplan, 0)
    # one exchange round for the whole plan cannot certify cross-shard reads
    jplan = _jax_plan("er_wavefront")
    pplan = _port_plan(jplan)
    assert partition_plan(pplan, 4).halo_pairs == jcore.partition_plan(jplan, 4).halo_pairs > 0
    S = pplan.n_supersteps
    with pytest.raises(ValueError, match="certif"):
        partition_plan(pplan, 4, exchange_bounds=(0, S))
