"""The level kernels' layout and plain version, on the CPU:

  * the level order of a plan (``kernels.levels.level_order``) on ER, NB and
    IC(0) plans at n ~ 2,000, k in {4, 8, 16}, width in {None, 2, 3} (widths
    2 and 3 force accumulate rows): ``perm`` covers every real lane-step
    once, each vertex's steps are contiguous and in plan order, supersteps
    come in order, and every in-neighbour of a vertex sits at a strictly
    lower level (at exactly one level below for the deepest one);
  * the order over runs of ``slack`` supersteps (``mode="elastic"``) for
    slack in {1, 2, 3, 8, at least the superstep count} on ER, NB, chain
    and IC(0) plans: array-equal to an order built by its definition in
    plain Python (``slack=1`` array-equal to the default order), every
    vertex reads only rows of earlier runs or of lower levels of its run,
    levels fall as runs merge, and one run has as many levels as the
    vertex DAG's longest path;
  * ``sptrsv_level_ref`` == ``sptrsv_ref`` == the JAX package's
    ``solve_with_plan``, bitwise, in f32 and f64, and on inputs that hold
    signed zeros and explicit zero entries;
  * the wrappers' checks: ``sptrsv_level_cuda``'s input checks, and its
    refusal of tensors that lie neither on the CPU nor on a CUDA device;
  * ``TriangularSolver(..., device="cpu").solve(B)`` through the level
    wrapper with a 2-D b, bitwise equal to the JAX front door;
  * the column-group layout that ``kernels.level_sweep`` times against
    the shipped column grid: ``pack_groups`` / ``unpack_groups`` (b
    f[n+1, m] <-> f[G, n+1, C] for m in {1, 3, 5, 32, 33} and C in {1, 2,
    4, 8}, bitwise, the pad columns +0 and dropped again, the scratch row
    +0, C = 1 the column-major copy), and its plain version
    ``sptrsv_groups_ref`` == ``sptrsv_ref`` == the JAX scan executor,
    bitwise, in f32 and f64, signed zeros included.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
from repro.pipeline import TriangularSolver as JSolver
from repro.solver.executor import plan_arrays as jplan_arrays
from repro.solver.executor import solve_with_plan as jsolve_with_plan
from repro_torch.convert import csr_from_numpy, exec_plan_from_numpy
from repro_torch.kernels import level_sweep, ops, sptrsv
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import level_plan_arrays
from repro_torch.kernels.ref import sptrsv_level_ref, sptrsv_ref
from repro_torch.solver.executor import pad_rhs, plan_arrays
from repro_torch.sparse import erdos_renyi_lower, ichol0, narrow_band_lower, poisson2d_matrix

_TORCH = {"float32": torch.float32, "float64": torch.float64}


@functools.lru_cache(maxsize=None)
def _port_plan(name, k, width):
    L = {
        "er": lambda: erdos_renyi_lower(2000, 2e-3, seed=3),
        "nb": lambda: narrow_band_lower(2000, 0.14, 10, seed=4),
        "ichol": lambda: ichol0(poisson2d_matrix(45)),
    }[name]()
    return repro_torch.TriangularSolver.plan(
        L, k=k, width=width, device="cpu", backend="scan"
    ).exec_plan


@pytest.mark.parametrize("width", [None, 2, 3])
@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_level_order_properties(name, k, width):
    plan = _port_plan(name, k, width)
    n, W = plan.n, plan.W
    order = level_order(plan)
    perm, vp, lp = order.perm, order.vert_ptr, order.level_ptr
    V, n_levels = len(vp) - 1, order.n_levels

    # perm covers every real lane-step exactly once
    assert np.array_equal(np.sort(perm), np.flatnonzero(plan.row_ids.reshape(-1) != n))
    assert vp[0] == 0 and vp[-1] == perm.size and (np.diff(vp) > 0).all()
    assert lp[0] == 0 and lp[-1] == V and (np.diff(lp) > 0).all()

    # each vertex: consecutive steps of one lane in plan order, one row,
    # accumulating at every step but its last
    step, lane = np.divmod(perm, plan.k)
    rows = plan.row_ids.reshape(-1)[perm]
    vertex = np.repeat(np.arange(V), np.diff(vp))
    same = vertex[1:] == vertex[:-1]
    assert (lane[1:][same] == lane[:-1][same]).all()
    assert (step[1:][same] == step[:-1][same] + 1).all()
    assert (rows[1:][same] == rows[:-1][same]).all()
    last = np.append(~same, True)
    assert np.array_equal(plan.accum.reshape(-1)[perm], ~last)
    assert np.array_equal(np.sort(rows[last]), np.arange(n))  # each row finished once

    # supersteps in order, one per level (the default order runs each
    # superstep on its own)
    bounds = np.asarray(plan.step_bounds)
    superstep = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))[step]
    assert (np.diff(superstep) >= 0).all()
    level = np.repeat(np.arange(n_levels), np.diff(lp))  # level of each vertex
    assert order.slack == 1
    assert np.array_equal(order.level_run[level], superstep[vp[:-1]])

    # every in-neighbour sits at a strictly lower level; a vertex's deepest
    # in-neighbour of its own superstep one level below (levels are tight)
    finisher = np.empty(n, np.int64)
    finisher[rows[last]] = vertex[last]
    cols = plan.col_idx.reshape(-1, W)[perm]
    p, w = np.nonzero(cols != n)
    u, v = finisher[cols[p, w]], vertex[p]
    assert (level[u] < level[v]).all()
    own = order.level_run[level[u]] == order.level_run[level[v]]
    deepest = np.full(V, -1)
    np.maximum.at(deepest, v[own], level[u[own]])
    first_level = np.concatenate([[True], np.diff(order.level_run) != 0])
    assert np.array_equal(deepest >= 0, ~first_level[level])
    has = deepest >= 0
    assert (deepest[has] == level[has] - 1).all()

    stats = order.stats()
    assert stats["levels"] == n_levels and sum(stats["levels_per_run"]) == n_levels
    assert stats["level_width_max"] == int(np.diff(lp).max())


# ------------------------------------------------- runs of supersteps
_RUN_PLANS = ("er", "nb", "chain", "ichol")
_SLACKS = (1, 2, 3, 8, "all")  # "all": at least the superstep count


@functools.lru_cache(maxsize=None)
def _run_plan(name):
    """A plan of several supersteps (width 2 forces accumulate rows)."""
    if name == "chain":
        from repro.autotune.corpus import chain_lower

        c = chain_lower(600, seed=1)
        L = csr_from_numpy(c.n_rows, c.n_cols, c.indptr, c.indices, c.data)
        return repro_torch.TriangularSolver.plan(
            L, k=4, width=2, device="cpu", backend="scan"
        ).exec_plan
    return _port_plan(name, 8, 2)


def _slack(plan, slack):
    return plan.n_supersteps + 1 if slack == "all" else slack


def _vertex_graph(plan):
    """Vertices by definition, one Python pass over the plan: for each
    lane's accum run plus its finishing step, in (step, lane) order of the
    finishing step, its superstep, lane, first step, flat lane-steps and
    the vertices it reads."""
    n, k = plan.n, plan.k
    bounds = np.asarray(plan.step_bounds)
    superstep = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    finisher = {}  # row -> vertex
    open_steps = [[] for _ in range(k)]
    verts = []
    for t in range(plan.n_steps):
        for lane in range(k):
            if plan.row_ids[t, lane] == n:
                continue
            open_steps[lane].append(t)
            if plan.accum[t, lane]:
                continue
            steps, open_steps[lane] = open_steps[lane], []
            reads = {finisher[c] for s in steps for c in plan.col_idx[s, lane] if c != n}
            finisher[int(plan.row_ids[t, lane])] = len(verts)
            verts.append(dict(ss=int(superstep[steps[0]]), lane=lane, step=steps[0],
                              flat=[s * k + lane for s in steps], reads=reads))
    return verts


def _reference_order(plan, slack):
    """The level order over runs of ``slack`` supersteps by its definition:
    a vertex's level is 0, or 1 + the deepest vertex of its own run that it
    reads; order by (run, level, lane, step)."""
    verts = _vertex_graph(plan)
    for v in verts:  # the readers come after what they read
        run = v["ss"] // slack
        own = [verts[u]["level"] for u in v["reads"] if verts[u]["ss"] // slack == run]
        v["run"], v["level"] = run, 1 + max(own, default=-1)
    order = sorted(verts, key=lambda v: (v["run"], v["level"], v["lane"], v["step"]))
    keys = [(v["run"], v["level"]) for v in order]
    level_first = [i for i in range(len(keys)) if i == 0 or keys[i] != keys[i - 1]]
    return (
        np.array([f for v in order for f in v["flat"]], np.int64),
        np.cumsum([0] + [len(v["flat"]) for v in order]).astype(np.int32),
        np.array(level_first + [len(order)], np.int32),
        np.array([keys[i][0] for i in level_first], np.int32),
    )


def _longest_path(plan):
    """Vertices on the longest path of the plan's vertex DAG."""
    depth = []
    for v in _vertex_graph(plan):
        depth.append(1 + max((depth[u] for u in v["reads"]), default=0))
    return max(depth, default=0)


@pytest.mark.parametrize("slack", _SLACKS)
@pytest.mark.parametrize("name", _RUN_PLANS)
def test_level_order_over_runs(name, slack):
    plan = _run_plan(name)
    s = _slack(plan, slack)
    order = level_order(plan, slack=s)
    perm, vp, lp, lrun = _reference_order(plan, s)
    assert np.array_equal(order.perm, perm)
    assert order.vert_ptr.dtype == np.int32 and np.array_equal(order.vert_ptr, vp)
    assert order.level_ptr.dtype == np.int32 and np.array_equal(order.level_ptr, lp)
    assert np.array_equal(order.level_run, lrun) and order.slack == s
    if s == 1:  # the default: the bulk kernel's order, array for array
        default = level_order(plan)
        for a, b in zip(default[:4], order[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    # every vertex reads rows of earlier runs or of lower levels of its run
    n, k, V = plan.n, plan.k, len(vp) - 1
    vertex = np.repeat(np.arange(V), np.diff(vp))
    level = np.repeat(np.arange(order.n_levels), np.diff(lp))
    rows = plan.row_ids.reshape(-1)[perm]
    last = np.append(vertex[1:] != vertex[:-1], True)
    finisher = np.empty(n, np.int64)
    finisher[rows[last]] = vertex[last]
    cols = plan.col_idx.reshape(-1, plan.W)[perm]
    p, w = np.nonzero(cols != n)
    u, v = finisher[cols[p, w]], vertex[p]
    ru, rv = lrun[level[u]], lrun[level[v]]
    assert ((ru < rv) | ((ru == rv) & (level[u] < level[v]))).all()
    # a vertex is consecutive steps of one lane in one superstep
    step, lane = np.divmod(perm, k)
    bounds = np.asarray(plan.step_bounds)
    superstep = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))[step]
    same = ~last[:-1]
    assert (lane[1:][same] == lane[:-1][same]).all()
    assert (step[1:][same] == step[:-1][same] + 1).all()
    assert (superstep[1:][same] == superstep[:-1][same]).all()
    assert (superstep // s == lrun[level[vertex]]).all()
    assert sum(order.stats()["levels_per_run"]) == order.n_levels
    if slack == "all":  # the whole DAG's wavefronts
        assert order.n_levels == _longest_path(plan)
        assert len(set(lrun.tolist())) == 1


@pytest.mark.parametrize("name", _RUN_PLANS)
def test_levels_fall_as_runs_merge(name):
    # a run of s' supersteps that is a union of runs of s takes at most
    # the levels of those runs together (a path through it visits them in
    # order), and no order has fewer levels than the longest path
    plan = _run_plan(name)
    S = plan.n_supersteps
    levels = {s: level_order(plan, slack=_slack(plan, s)).n_levels for s in _SLACKS}
    for s in _SLACKS:
        for t in _SLACKS:
            coarser = t == "all" or (s != "all" and t % s == 0)
            if coarser:
                assert levels[t] <= levels[s], (s, t, levels)
    assert levels["all"] == _longest_path(plan)
    # ER and NB span several supersteps; GrowLocal keeps the chain and
    # IC(0) of a small grid on one core, in one superstep
    assert S > 1 or name in ("chain", "ichol")
    with pytest.raises(ValueError, match="slack"):
        level_order(plan, slack=0)


def _jax_matrix(name):
    return {
        "er": lambda: jsparse.erdos_renyi_lower(700, 2e-3, seed=11),
        "nb": lambda: jsparse.narrow_band_lower(700, 0.14, 10, seed=12),
        "ichol": lambda: jsparse.ichol0(jsparse.poisson2d_matrix(24)),
    }[name]()


def _jax_plan(L, k, width, np_dtype):
    s = jcore.grow_local(jsparse.dag_from_lower_csr(L), k)
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    return jcore.compile_plan(L2, s2, width=width, dtype=np_dtype)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{nd} of {a.size} entries differ"


def _three_solves(jp, b, dtype):
    """x from the level walk, the step walk and the JAX scan executor."""
    plan = exec_plan_from_numpy({f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    tdt = _TORCH[dtype]
    b_pad = pad_rhs(torch.from_numpy(b))
    la = level_plan_arrays(plan, dtype=tdt, device="cpu")
    pa = plan_arrays(plan, dtype=tdt, device="cpu")
    x_level = sptrsv_level_ref(*la[:7], b_pad)
    x_step = sptrsv_ref(*pa[:5], b_pad)
    with jax.enable_x64(dtype == "float64"):
        x_jax = np.asarray(jsolve_with_plan(jplan_arrays(jp, dtype=jnp.dtype(dtype)), jnp.asarray(b)))
    assert x_level[plan.n] == 0.0 and x_level[plan.n].sign() >= 0  # the scratch slot
    return x_level[: plan.n].numpy(), x_step[: plan.n].numpy(), x_jax


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k,width", [(8, None), (4, 2), (16, 3)])
@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_level_ref_bitwise_vs_step_walk_and_jax(name, k, width, dtype):
    jp = _jax_plan(_jax_matrix(name), k, width, np.dtype(dtype))
    b = np.random.default_rng(k).standard_normal(jp.n).astype(dtype)
    x_level, x_step, x_jax = _three_solves(jp, b, dtype)
    _assert_bitwise(x_level, x_step)
    _assert_bitwise(x_level, x_jax)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_level_ref_bitwise_with_signed_zeros(dtype):
    L = _jax_matrix("er")
    rng = np.random.default_rng(5)
    rows = L.row_of_entry()
    off = np.flatnonzero(L.indices != rows)
    data = np.array(L.data, dtype=np.float64)
    zeros = rng.choice(off, off.size // 4, replace=False)  # explicit zero entries
    data[zeros] = np.where(rng.random(zeros.size) < 0.5, -0.0, 0.0)
    jp = _jax_plan(dataclasses.replace(L, data=data), 4, 2, np.dtype(dtype))
    b = rng.standard_normal(jp.n).astype(dtype)
    zero_b = rng.random(jp.n) < 0.5  # half of b is +0 or -0
    b[zero_b] = np.where(rng.random(int(zero_b.sum())) < 0.5, -0.0, 0.0)
    x_level, x_step, x_jax = _three_solves(jp, b, dtype)
    assert (np.signbit(x_level) & (x_level == 0)).any()  # -0 reached x
    _assert_bitwise(x_level, x_step)
    _assert_bitwise(x_level, x_jax)


def test_sptrsv_level_cuda_input_checks():
    plan = _port_plan("nb", 4, 2)
    la = level_plan_arrays(plan, device="cpu")
    b_pad = pad_rhs(torch.from_numpy(np.random.default_rng(0).standard_normal(plan.n)).float())
    args = [*la[:7], b_pad]
    for i, bad, err in [
        (0, la.row_ids.long(), TypeError),  # int64 indices
        (6, la.level_ptr.long(), TypeError),  # int64 level bounds
        (4, la.accum.float(), TypeError),  # float mask
        (7, b_pad.double(), TypeError),  # dtype mismatch with vals
        (1, la.col_idx.t(), ValueError),  # not contiguous
        (3, la.diag[:-1], ValueError),  # wrong shape
        (7, b_pad[:, None, None].contiguous(), ValueError),  # b f[n+1] or f[n+1, m] only
    ]:
        a = list(args)
        a[i] = bad
        with pytest.raises(err):
            sptrsv.sptrsv_level_cuda(*a)
    sptrsv.reset_launches()
    x = sptrsv.sptrsv_level_cuda(*args)
    _assert_bitwise(x.numpy(), sptrsv_level_ref(*args).numpy())
    assert not any(sptrsv.launches.values())  # the plain version is no launch


def test_single_rhs_off_the_cpu_is_the_level_kernels():
    # tensors off the CPU never take a plain version: the level wrapper
    # launches a kernel for one right-hand side and for m, or raises
    plan = _port_plan("er", 8, None)
    la = level_plan_arrays(plan, device="meta")
    for shape in ((plan.n + 1,), (plan.n + 1, 5)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            sptrsv.sptrsv_level_cuda(*la[:7], torch.zeros(shape, device="meta"))


@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_front_door_mrhs_through_level_wrapper_bitwise_vs_jax(monkeypatch, name):
    L = _jax_matrix(name)
    calls = []

    def spy(*args):
        calls.append(tuple(args[-1].shape))
        return sptrsv.sptrsv_level_cuda(*args)

    monkeypatch.setattr(ops, "sptrsv_level_cuda", spy)
    ts = repro_torch.TriangularSolver.plan(
        csr_from_numpy(L.n_rows, L.n_cols, L.indptr, L.indices, L.data), device="cpu")
    assert ts.backend == "kernel"
    B = np.random.default_rng(3).standard_normal((L.n_rows, 6))
    x = ts.solve(B)
    assert calls == [(L.n_rows + 1, 6)]  # one call, b f[n+1, m]
    _assert_bitwise(JSolver.plan(L).solve(B), x.numpy())


@pytest.mark.parametrize("cols", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 3, 5, 32, 33])
def test_pack_round_trip(m, cols):
    rng = np.random.default_rng(m * 10 + cols)
    b = rng.standard_normal((40, m)).astype(np.float32)
    b[rng.random(b.shape) < 0.2] = -0.0  # signed zeros survive the trip
    b_pad = pad_rhs(torch.from_numpy(b))
    packed = level_sweep.pack_groups(b_pad, cols)
    G = -(-m // cols)
    assert packed.shape == (G, 41, cols) and packed.is_contiguous()
    for g in range(G):  # group g holds columns g*C .. g*C + C - 1, then +0
        live = min(cols, m - g * cols)
        _assert_bitwise(packed[g, :, :live], b_pad[:, g * cols : g * cols + live])
        _assert_bitwise(packed[g, :, live:], np.zeros((41, cols - live), np.float32))
    _assert_bitwise(packed[:, 40], np.zeros((G, cols), np.float32))  # the scratch row, +0
    back = level_sweep.unpack_groups(packed, m)
    assert back.shape == (41, m)
    _assert_bitwise(back, b_pad)
    if cols == 1:  # the column grid's column-major copy
        _assert_bitwise(packed[:, :, 0], b_pad.T.contiguous())


@functools.lru_cache(maxsize=None)
def _group_plan(name, signed_zeros, dtype):
    """A JAX plan (k = 4, width 2), its matrix with a quarter of the
    off-diagonal entries explicit +0 or -0 where ``signed_zeros``."""
    L = _jax_matrix(name)
    if signed_zeros:
        rng = np.random.default_rng(5)
        off = np.flatnonzero(L.indices != L.row_of_entry())
        data = np.array(L.data, dtype=np.float64)
        zeros = rng.choice(off, off.size // 4, replace=False)  # explicit zero entries
        data[zeros] = np.where(rng.random(zeros.size) < 0.5, -0.0, 0.0)
        L = dataclasses.replace(L, data=data)
    return _jax_plan(L, 4, 2, np.dtype(dtype))


@pytest.mark.parametrize("cols", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,signed_zeros", [("er", False), ("nb", False), ("ichol", False),
                                               ("er", True)])
def test_group_ref_bitwise_vs_step_walk_and_jax(name, signed_zeros, dtype, cols):
    jp = _group_plan(name, signed_zeros, dtype)
    rng = np.random.default_rng(cols)
    m = 5  # a part-filled last group for every C > 1
    b = rng.standard_normal((jp.n, m)).astype(dtype)
    if signed_zeros:  # a third of b is +0 or -0
        zero_b = rng.random(b.shape) < 0.3
        b[zero_b] = np.where(rng.random(int(zero_b.sum())) < 0.5, -0.0, 0.0)
    plan = exec_plan_from_numpy({f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    tdt = _TORCH[dtype]
    b_pad = pad_rhs(torch.from_numpy(b))
    la = level_plan_arrays(plan, dtype=tdt, device="cpu")
    x_groups = level_sweep.sptrsv_groups_ref(*la[:7], level_sweep.pack_groups(b_pad, cols))
    assert (x_groups[:, plan.n] == 0).all() and not x_groups[:, plan.n].signbit().any()
    x = level_sweep.unpack_groups(x_groups, m)
    _assert_bitwise(x, sptrsv_ref(*plan_arrays(plan, dtype=tdt, device="cpu")[:5], b_pad))
    with jax.enable_x64(dtype == "float64"):
        x_jax = np.asarray(jsolve_with_plan(jplan_arrays(jp, dtype=jnp.dtype(dtype)),
                                            jnp.asarray(b)))
    _assert_bitwise(x[: plan.n], x_jax)
    if signed_zeros:
        assert (x.signbit() & (x == 0)).any()  # -0 reached x
