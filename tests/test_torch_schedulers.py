"""The port's seven scheduling strategies against the JAX package's (CPU;
JAX is the oracle), on the conftest matrices (ER 700, NB 700, IC(0) of the
24 × 24 Poisson grid), k in {4, 8}, and ``block`` with n_blocks in {2, 4}.

Every comparison is exact: ``pi``, ``sigma``, ``rank`` and
``n_supersteps`` array-equal in value and dtype; ``check_validity``
passes; the §5 reorder is a topological order; the §4 stages
(``transitive_sparsify``, ``funnel_partition``, ``coarsen_dag``,
``pull_back_schedule``) array-equal; ``bsp_cost``, ``schedule_step_count``,
``step_cost``, ``elastic_cost`` and ``schedule_stats`` equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch.core as tcore
import repro_torch.sparse as tsparse
from repro.pipeline import schedule as jschedule
from repro.sparse.dag import is_topological_order as j_is_topo
from repro_torch.pipeline import ScheduleOptions, available_strategies, schedule
from repro_torch.sparse.dag import is_topological_order

STRATEGIES = ("block", "funnel-gl", "growlocal", "hdagg", "serial", "spmp", "wavefront")
MATRICES = ("er", "nb", "ichol")
# (strategy, extra options) cells: every strategy at its defaults, block
# also at n_blocks=2
CELLS = [(s, {}) for s in STRATEGIES] + [("block", {"n_blocks": 2})]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX matrix, port matrix), each from its own generators."""
    if name == "er":
        return (jsparse.erdos_renyi_lower(700, 2e-3, seed=11),
                tsparse.erdos_renyi_lower(700, 2e-3, seed=11))
    if name == "nb":
        return (jsparse.narrow_band_lower(700, 0.14, 10, seed=12),
                tsparse.narrow_band_lower(700, 0.14, 10, seed=12))
    return (jsparse.ichol0(jsparse.poisson2d_matrix(24)),
            tsparse.ichol0(tsparse.poisson2d_matrix(24)))


@functools.lru_cache(maxsize=None)
def _dags(name):
    jA, tA = _pair(name)
    return jsparse.dag_from_lower_csr(jA), tsparse.dag_from_lower_csr(tA)


@functools.lru_cache(maxsize=None)
def _schedules(name, strategy, k, n_blocks=None):
    jd, td = _dags(name)
    kw = {} if n_blocks is None else {"n_blocks": n_blocks}
    return (jschedule(jd, k, strategy=strategy, **kw),
            schedule(td, k, strategy=strategy, **kw))


def _assert_arrays_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _assert_schedule_equal(js, ts):
    assert (ts.n, ts.k, ts.n_supersteps) == (js.n, js.k, js.n_supersteps)
    for f in ("pi", "sigma", "rank"):
        _assert_arrays_equal(getattr(js, f), getattr(ts, f))


def _cell_id(cell):
    s, kw = cell
    return s + "".join(f"-{k}{v}" for k, v in kw.items())


def test_available_strategies_match_jax():
    from repro.pipeline import available_strategies as javailable

    assert available_strategies() == javailable() == STRATEGIES


def test_schedule_options_match_jax():
    from repro.pipeline import ScheduleOptions as JOptions

    assert [f.name for f in dataclasses.fields(ScheduleOptions)] == [
        f.name for f in dataclasses.fields(JOptions)]
    assert dataclasses.asdict(ScheduleOptions()) == dataclasses.asdict(JOptions())


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
@pytest.mark.parametrize("name", MATRICES)
def test_schedule_array_equal_to_jax(name, cell, k):
    strategy, kw = cell
    js, ts = _schedules(name, strategy, k, kw.get("n_blocks"))
    _assert_schedule_equal(js, ts)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
@pytest.mark.parametrize("name", MATRICES)
def test_schedule_valid_and_reorder_topological(name, cell, k):
    strategy, kw = cell
    _, ts = _schedules(name, strategy, k, kw.get("n_blocks"))
    _, td = _dags(name)
    _, tA = _pair(name)
    tcore.check_validity(td, ts)
    m2, s2, _, r = tcore.apply_reordering(tA, ts)
    assert is_topological_order(td, r.perm)
    # the reordered matrix is still lower triangular and its schedule valid
    assert m2.is_lower_triangular()
    tcore.check_validity(tsparse.dag_from_lower_csr(m2), s2)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
@pytest.mark.parametrize("name", MATRICES)
def test_cost_model_equal_to_jax(name, cell, k):
    strategy, kw = cell
    js, ts = _schedules(name, strategy, k, kw.get("n_blocks"))
    jd, td = _dags(name)
    assert tcore.bsp_cost(td, ts) == jcore.bsp_cost(jd, js)
    assert tcore.schedule_step_count(ts) == jcore.schedule_step_count(js)
    assert tcore.step_cost(td, ts) == jcore.step_cost(jd, js)
    for slack in (1, 4, 8):
        assert tcore.elastic_cost(td, ts, slack) == jcore.elastic_cost(jd, js, slack)
    assert tcore.schedule_stats(td, ts) == jcore.schedule_stats(jd, js)
    assert tcore.schedule_stats(td, ts, L=50.0) == jcore.schedule_stats(jd, js, L=50.0)


def test_cost_model_constants_match_jax():
    assert (tcore.DEFAULT_L, tcore.DEFAULT_L_STEP, tcore.L_P2P_EFFECTIVE) == (
        jcore.DEFAULT_L, jcore.DEFAULT_L_STEP, jcore.L_P2P_EFFECTIVE)


@pytest.mark.parametrize("name", MATRICES)
def test_is_topological_order_matches_jax(name):
    jd, td = _dags(name)
    n = td.n
    ident = np.arange(n)
    assert is_topological_order(td, ident) and j_is_topo(jd, ident)
    rev = ident[::-1].copy()
    assert is_topological_order(td, rev) == j_is_topo(jd, rev) is False


def _assert_dag_equal(jd, td):
    assert (td.n, td.n_edges) == (jd.n, jd.n_edges)
    for f in ("parent_ptr", "parent_idx", "weights"):
        _assert_arrays_equal(getattr(jd, f), getattr(td, f))


@pytest.mark.parametrize("max_size", [16, 64])
@pytest.mark.parametrize("name", MATRICES)
def test_coarsening_stages_array_equal_to_jax(name, max_size):
    jd, td = _dags(name)
    jw, tw = jcore.transitive_sparsify(jd), tcore.transitive_sparsify(td)
    _assert_dag_equal(jw, tw)
    jp = jcore.funnel_partition(jw, max_size=max_size)
    tp = tcore.funnel_partition(tw, max_size=max_size)
    _assert_arrays_equal(jp, tp)
    jc, tc = jcore.coarsen_dag(jw, jp), tcore.coarsen_dag(tw, tp)
    _assert_arrays_equal(jc.part, tc.part)
    _assert_dag_equal(jc.coarse, tc.coarse)
    assert len(jc.members) == len(tc.members)
    for a, b in zip(jc.members, tc.members):
        _assert_arrays_equal(a, b)
    # the coarse schedule each package pulls back: GrowLocal at k = 4
    jcs, tcs = jcore.grow_local(jc.coarse, 4), tcore.grow_local(tc.coarse, 4)
    _assert_schedule_equal(jcs, tcs)
    jf = jcore.pull_back_schedule(jc, jcs, jd.n)
    tf = tcore.pull_back_schedule(tc, tcs, td.n)
    _assert_schedule_equal(jf, tf)
    tcore.check_validity(td, tf)


@pytest.mark.parametrize("name", ["er", "nb"])
def test_funnel_parts_are_cascades(name):
    # Prop. 4.3's premise on a sample of parts, as the JAX checker says
    jd, td = _dags(name)
    tp = tcore.funnel_partition(td, max_size=16)
    jp = jcore.funnel_partition(jd, max_size=16)
    for part_id in range(0, int(tp.max()) + 1, max(1, int(tp.max()) // 12)):
        members = np.nonzero(tp == part_id)[0]
        assert tcore.is_cascade(td, members) is jcore.is_cascade(jd, members) is True
        _assert_arrays_equal(members, np.nonzero(jp == part_id)[0])


@pytest.mark.parametrize("split", ["contiguous", "cyclic"])
@pytest.mark.parametrize("name", MATRICES)
def test_wavefront_splits_array_equal_to_jax(name, split):
    jd, td = _dags(name)
    js = jcore.wavefront_schedule(jd, 8, split=split)
    ts = tcore.wavefront_schedule(td, 8, split=split)
    _assert_schedule_equal(js, ts)
    tcore.check_validity(td, ts)
    with pytest.raises(ValueError, match="split"):
        tcore.wavefront_schedule(td, 8, split="zigzag")


@pytest.mark.parametrize("n_blocks", [1, 3, 5])
def test_block_helpers_equal_to_jax(n_blocks):
    jd, td = _dags("nb")
    ranges = tcore.split_ranges(td.n, n_blocks)
    assert ranges == jcore.split_ranges(jd.n, n_blocks)
    lo, hi = ranges[-1]
    _assert_dag_equal(jcore.block_sub_dag(jd, lo, hi), tcore.block_sub_dag(td, lo, hi))
    # the thread pool and the serial loop give the same schedule
    ser = tcore.block_parallel_schedule(
        td, 4, n_blocks, lambda d, k: tcore.grow_local(d, k), parallel=False)
    par = tcore.block_parallel_schedule(td, 4, n_blocks, lambda d, k: tcore.grow_local(d, k))
    _assert_schedule_equal(ser, par)
    _assert_schedule_equal(
        jcore.block_parallel_schedule(jd, 4, n_blocks, lambda d, k: jcore.grow_local(d, k)), par)


@pytest.mark.parametrize("sparsify", [True, False])
def test_spmp_and_funnel_knobs_equal_to_jax(sparsify):
    jd, td = _dags("er")
    _assert_schedule_equal(jcore.spmp_like_schedule(jd, 8, sparsify=sparsify),
                           tcore.spmp_like_schedule(td, 8, sparsify=sparsify))
    _assert_schedule_equal(
        jcore.funnel_grow_local(jd, 8, max_size=32, sparsify=sparsify),
        tcore.funnel_grow_local(td, 8, max_size=32, sparsify=sparsify))


def test_hdagg_balance_tau_equal_to_jax():
    jd, td = _dags("ichol")
    for tau in (1.0, 1.5):
        _assert_schedule_equal(jcore.hdagg_schedule(jd, 8, balance_tau=tau),
                               tcore.hdagg_schedule(td, 8, balance_tau=tau))
