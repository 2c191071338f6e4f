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
    bitwise, in f32 and f64, signed zeros included;
  * the level walk's chunk table and stage layout
    (``kernels.levels.level_chunks``) on ER-like and IC(0) plans, wide
    synthetic levels and a bank of two lanes, f32 and f64: the chunks cover
    every vertex once and in order, none crosses a level or holds more than
    992 vertices (the kernel's consumer threads), every staged chunk's
    slices, rounded out to 16 bytes as the kernel copies them, fit its
    stage, ``level_chunk`` sliced by a
    level range or a lane's offset gives that range's or lane's chunks,
    and a vertex wider than a stage is a chunk of its own, not staged;
  * the value refresh of bounds that hold level tensors
    (``ops.refresh_level_values`` through ``ops.level_sources``) bitwise
    the level tensors of the plan refreshed on the host, bulk, elastic and
    a distributed position's.
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
from repro_torch.backends.base import expected_entry_count
from repro_torch.convert import csr_from_numpy, exec_plan_from_numpy
from repro_torch.kernels import level_sweep, ops, sptrsv
from repro_torch.kernels import levels
from repro_torch.kernels.levels import level_order
from repro_torch.kernels.ops import level_plan_arrays
from repro_torch.kernels.ref import sptrsv_level_bank_ref, sptrsv_level_ref, sptrsv_ref
from repro_torch.solver import distributed as dist
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

    def spy(*args, **kwargs):
        calls.append(tuple(args[-1].shape))
        return sptrsv.sptrsv_level_cuda(*args, **kwargs)

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


# ------------------------------------------------------------ the level bank
def _bank_members(name, dtype):
    """Three clones of one plan with distinct values (one width class):
    their level tensors and row permutations, on the CPU."""
    L = {"er": lambda: erdos_renyi_lower(600, 4e-3, seed=13),
         "nb": lambda: narrow_band_lower(600, 0.14, 10, seed=14)}[name]()
    s0 = repro_torch.TriangularSolver.plan(L, device="cpu", dtype=_TORCH[dtype])
    rng = np.random.default_rng(15)
    clones = [s0.clone_with_values(L.data * rng.uniform(0.5, 1.5, L.nnz)) for _ in range(3)]
    return ([c.bound._la for c in clones], [c._perm for c in clones],
            [c._inv for c in clones], clones)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["er", "nb"])
def test_level_bank_ref_is_level_ref_per_column(name, dtype):
    """``sptrsv_level_bank_ref`` == ``sptrsv_level_ref`` on each column's
    own lane, bitwise; the wrapper on CPU tensors is the plain version and
    counts no launch; lanes repeat and every lane is used."""
    las, perms, invs, _ = _bank_members(name, dtype)
    bank = ops.stack_level_bank(las, perms, invs)
    n = bank.n
    lane_idx = torch.tensor([2, 0, 1, 1, 0, 3, 2, 0], dtype=torch.int32)  # lane 3 pads lane 0
    b_col = torch.from_numpy(np.random.default_rng(16).standard_normal((8, n + 1))).to(
        _TORCH[dtype])
    b_col[:, n] = 0
    x = sptrsv_level_bank_ref(*bank[:9], lane_idx, b_col)
    assert x.shape == b_col.shape and x.dtype == b_col.dtype
    for j, lane in enumerate(lane_idx.tolist()):
        la = las[[0, 1, 2, 0][lane]]
        _assert_bitwise(x[j].numpy(), sptrsv_level_ref(*la[:7], b_col[j]).numpy())
    assert not np.array_equal(x[1].numpy(), x[2].numpy())  # distinct values per lane
    sptrsv.reset_launches()
    _assert_bitwise(sptrsv.sptrsv_level_bank_cuda(*bank[:9], lane_idx, b_col).numpy(),
                    x.numpy())
    assert not any(sptrsv.launches.values())


def test_level_bank_layout():
    """The concatenation: each lane's slice (``bank_lane``) is its own
    level tensors exactly; the lane axis pads to a power of two with
    lane 0's levels and no copy of plan data; perm / inv stack per lane."""
    from repro_torch.kernels.ref import bank_lane

    las, perms, invs, _ = _bank_members("er", "float32")
    bank = ops.stack_level_bank(las, perms, invs)
    assert bank.level_off.tolist()[3] == 0 and bank.n_levels.shape == (4,)
    assert bank.row_ids.shape[0] == sum(la.row_ids.shape[0] for la in las)
    assert bank.perm.shape == (4, bank.n) and torch.equal(bank.perm[3], perms[0])
    assert torch.equal(bank.inv[1], invs[1])
    for lane, la in enumerate(las + [las[0]]):
        got = bank_lane(*bank[:9], lane)
        for a, b in zip(got, la[:7]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    one = ops.stack_level_bank(las[:1], perms[:1], invs[:1])
    assert one.level_off.tolist() == [0]  # one member, no padding


def test_level_bank_rejects_mixed_classes_and_int32_overflow(monkeypatch):
    las, perms, invs, _ = _bank_members("er", "float32")
    other = repro_torch.TriangularSolver.plan(erdos_renyi_lower(500, 4e-3, seed=13),
                                              device="cpu")
    with pytest.raises(ValueError, match="width class"):  # another n
        ops.stack_level_bank([las[0], other.bound._la], perms[:2], invs[:2])
    monkeypatch.setattr(ops, "_INT32_MAX", las[0].row_ids.shape[0] + 1)
    with pytest.raises(ValueError, match="pass int32"):
        ops.stack_level_bank(las, perms, invs)


def test_level_bank_wrapper_checks():
    las, perms, invs, _ = _bank_members("nb", "float32")
    bank = ops.stack_level_bank(las, perms, invs)
    n = bank.n
    b_col = torch.zeros((2, n + 1))
    good = torch.tensor([0, 3], dtype=torch.int32)
    sptrsv.sptrsv_level_bank_cuda(*bank[:9], good, b_col)
    for lanes, err in [
        (torch.tensor([0, 4], dtype=torch.int32), ValueError),  # no lane 4
        (torch.tensor([-1, 0], dtype=torch.int32), ValueError),
        (torch.tensor([0], dtype=torch.int32), ValueError),  # m != columns of b
        (torch.tensor([0.0, 1.0]), TypeError),  # not an integer tensor
        ([0, 1], TypeError),  # not a tensor
    ]:
        with pytest.raises(err):
            sptrsv.sptrsv_level_bank_cuda(*bank[:9], lanes, b_col)
    with pytest.raises(TypeError):
        sptrsv.sptrsv_level_bank_cuda(*bank[:7], bank.level_off.long(), bank.n_levels, good,
                                      b_col)
    with pytest.raises(TypeError):  # b dtype against vals
        sptrsv.sptrsv_level_bank_cuda(*bank[:9], good, b_col.double())
    meta = ops.LevelBank(*(t.to("meta") for t in bank[:9]), bank.perm, bank.inv, n)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sptrsv.sptrsv_level_bank_cuda(*meta[:9], good, torch.zeros((2, n + 1), device="meta"))


# ------------------------------------------------- the level walk's chunks
def _stage_copies(lo, hi, W, itemsize, bases):
    """The kernel's copies of chunk [lo, hi) (vertex, lane-step bounds), as
    csrc/level.cuh::issue makes them from tensors at byte addresses
    ``bases``: (aligned source, bytes, stage offset) per slice."""
    (v0, p0), (v1, p1) = lo, hi
    nv, np_ = v1 - v0, p1 - p0
    starts = (4 * v0, 4 * p0 * W, itemsize * p0 * W, 4 * p0, itemsize * p0, p0)
    lens = (4 * (nv + 1), 4 * np_ * W, itemsize * np_ * W, 4 * np_, itemsize * np_, np_)
    out, at = [], 0
    for base, start, n in zip(bases, starts, lens):
        a = base + start
        a0, end = a // 16 * 16, -(-(a + n) // 16) * 16
        out.append((a0, end - a0, at))
        at += end - a0
    return out


def _check_chunks(ch, vert_ptr, level_ptr, W, itemsize):
    vp, lp = np.asarray(vert_ptr, np.int64), np.asarray(level_ptr, np.int64)
    cp, lc = np.asarray(ch.chunk_ptr, np.int64), np.asarray(ch.level_chunk, np.int64)
    C = cp.shape[0] - 1
    # every vertex once, in order; lane-step bounds read off vert_ptr
    assert cp[0, 0] == lp[0] == 0 and cp[-1, 0] == lp[-1]
    assert (np.diff(cp[:, 0]) > 0).all() and np.array_equal(cp[:, 1], vp[cp[:, 0]])
    # no chunk crosses a level: each level is exactly its chunks
    assert lc[0] == 0 and lc[-1] == C and (np.diff(lc) > 0).all()
    assert np.array_equal(cp[lc, 0], lp)
    assert (np.diff(cp[:, 0]) <= levels.CHUNK_VERTICES).all()
    # the stage layout fits the block's shared memory
    assert levels.MIN_STAGES <= ch.n_stages <= levels.MAX_STAGES
    assert ch.stage_bytes % 16 == 0
    # the stage layout fits half the block's shared memory: the rest stays L1
    assert levels.STAGE_HEAD_BYTES + ch.n_stages * ch.stage_bytes <= levels.SMEM_BYTES // 2
    # a staged chunk's copies fit its stage, 16-byte aligned, wherever the
    # tensors start; an unstaged chunk is a single vertex
    nv, np_ = np.diff(cp[:, 0]), np.diff(cp[:, 1])
    assert ch.staged.shape == (C,)
    assert np.array_equal(ch.staged, levels.stage_need(nv, np_, W, itemsize) <= ch.stage_bytes)
    assert (nv[~ch.staged] == 1).all()
    for shift in (0, 4, 8, 12):
        bases = [4096 * (i + 1) + shift * (itemsize if i in (2, 4) else 1) // 4 * 4
                 for i in range(6)]
        for c in np.flatnonzero(ch.staged):
            copies = _stage_copies(cp[c], cp[c + 1], W, itemsize, bases)
            assert all(a % 16 == 0 and n % 16 == 0 and at % 16 == 0 for a, n, at in copies)
            assert sum(n for _, n, _ in copies) <= ch.stage_bytes
    return cp, lc


def _synthetic_levels(seed, widths, max_steps):
    """vert_ptr / level_ptr of levels of the given widths whose vertices
    take 1 to ``max_steps`` lane-steps."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, max_steps + 1, int(sum(widths)))
    return (np.concatenate([[0], np.cumsum(steps)]).astype(np.int32),
            np.concatenate([[0], np.cumsum(widths)]).astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,k,width", [("er", 8, None), ("er", 4, 2), ("ichol", 8, None),
                                          ("ichol", 16, 3), ("wide", 12, 1), ("wide", 12, 3)])
def test_level_chunks_cover_levels_and_fit_stages(name, k, width, dtype):
    """The chunk table of plans and of wide synthetic levels ("wide": W =
    k, levels of up to 5,000 vertices of 1 to ``width`` lane-steps, cut by
    the vertex count and by the stage's bytes)."""
    itemsize = torch.empty(0, dtype=_TORCH[dtype]).element_size()
    if name == "wide":
        W = k
        vert_ptr, level_ptr = _synthetic_levels(5, [1, 5000, 700, 992, 993, 3], width)
    else:
        order = level_order(_port_plan(name, k, width))
        W = _port_plan(name, k, width).W
        vert_ptr, level_ptr = order.vert_ptr, order.level_ptr
    ch = levels.level_chunks(vert_ptr, level_ptr, W, itemsize)
    cp, lc = _check_chunks(ch, vert_ptr, level_ptr, W, itemsize)
    assert ch.staged.all()  # no vertex of these is wider than a stage
    assert ch.stats() == {"stages": ch.n_stages, "stage_bytes": ch.stage_bytes,
                          "chunks": cp.shape[0] - 1, "chunks_staged": cp.shape[0] - 1,
                          "levels": len(level_ptr) - 1}
    # a level range's chunks are level_chunk sliced as level_ptr is sliced
    L = len(level_ptr) - 1
    for lo, hi in ((0, L), (1, max(1, L // 2)), (L // 2, L), (L - 1, L)):
        c_lo, c_hi = lc[lo], lc[hi]
        assert cp[c_lo, 0] == level_ptr[lo] and cp[c_hi, 0] == level_ptr[hi]
    if name == "wide":  # the wide levels are cut: by 992 vertices, and by bytes at W = 12
        assert (np.diff(lc) > 1).any()
    # bound with the level tensors, on the device the tensors are on
    if name != "wide":
        la = level_plan_arrays(_port_plan(name, k, width), dtype=_TORCH[dtype], device="cpu")
        assert la.chunks.stage_bytes == ch.stage_bytes and la.chunks.n_stages == ch.n_stages
        assert np.array_equal(la.chunks.chunk_ptr.numpy(), ch.chunk_ptr)
        assert np.array_equal(la.chunks.level_chunk.numpy(), ch.level_chunk)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_level_chunks_leave_a_vertex_wider_than_a_stage_unstaged(dtype):
    itemsize = torch.empty(0, dtype=_TORCH[dtype]).element_size()
    W = 12
    # level 1 holds a vertex of 5,000 lane-steps, more than the stages'
    # room, between vertices of one step
    steps = np.array([1, 1, 1, 5000, 1, 1, 1])
    vert_ptr = np.concatenate([[0], np.cumsum(steps)]).astype(np.int32)
    level_ptr = np.array([0, 2, 7], np.int32)
    ch = levels.level_chunks(vert_ptr, level_ptr, W, itemsize)
    cp, _ = _check_chunks(ch, vert_ptr, level_ptr, W, itemsize)
    assert ch.n_stages == levels.MIN_STAGES  # the stage is as large as the room allows
    wide = int(np.flatnonzero(cp[:-1, 0] == 3)[0])
    assert cp[wide + 1, 0] == 4 and not ch.staged[wide]
    assert ch.staged.sum() == ch.staged.size - 1
    assert ch.stats()["chunks_staged"] == ch.stats()["chunks"] - 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["er", "nb"])
def test_level_bank_chunks_are_each_lanes_chunks(name, dtype):
    """A bank of two lanes: lane l's ``level_chunk[level_off[l] ..
    level_off[l] + n_levels[l]]`` names its own chunks, shifted by its
    vertex and lane-step offsets; one stage layout fits every lane."""
    las, perms, invs, _ = _bank_members(name, dtype)
    las, perms, invs = las[:2], perms[:2], invs[:2]
    bank = ops.stack_level_bank(las, perms, invs)
    itemsize = bank.vals.element_size()
    W = bank.col_idx.shape[1]
    cp, lc = _check_chunks(bank.chunks, bank.vert_ptr, bank.level_ptr, W, itemsize)
    v_off = p_off = 0
    for lane, la in enumerate(las):
        l0, nl = int(bank.level_off[lane]), int(bank.n_levels[lane])
        own = la.chunks
        mine = cp[lc[l0] : lc[l0 + nl] + 1]
        assert np.array_equal(mine, own.chunk_ptr.numpy() + [v_off, p_off])
        assert own.stage_bytes <= bank.chunks.stage_bytes
        assert own.n_stages >= bank.chunks.n_stages
        v_off += la.vert_ptr.shape[0] - 1
        p_off += la.row_ids.shape[0]
    assert bank.chunks.staged.all()


@pytest.mark.parametrize("mode", ["bsp", "elastic"])
@pytest.mark.parametrize("name", ["er", "ichol"])
def test_kernel_bound_describes_its_staging(name, mode):
    """``describe()["staging"]``: the bound order's chunk table as the
    kernel walks it; every chunk of these plans is staged."""
    L = {"er": lambda: erdos_renyi_lower(2000, 2e-3, seed=3),
         "ichol": lambda: ichol0(poisson2d_matrix(45))}[name]()
    d = repro_torch.TriangularSolver.plan(L, device="cpu", mode=mode).bound.describe()
    st = d["staging"]
    assert set(st) == {"stages", "stage_bytes", "chunks", "chunks_staged", "levels"}
    assert st["levels"] == d["n_levels"] and st["chunks"] >= st["levels"]
    assert st["chunks_staged"] == st["chunks"]
    assert levels.STAGE_HEAD_BYTES + st["stages"] * st["stage_bytes"] <= levels.SMEM_BYTES // 2


@pytest.mark.parametrize("order", ["bulk", "elastic", "position"])
@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_level_refresh_is_the_refreshed_plans_layout(name, order):
    """The value refresh of every bound of level tensors
    (``ops.refresh_level_values`` through ``ops.level_sources``: the
    kernel bound's and the distributed backend's) gives, bit for bit, the
    level tensors of the plan refreshed on the host: in the bulk order, the
    slack-3 elastic order and a distributed position's ``RoundLevels``
    (lane 1 of the plan), at width 2 (accumulate rows, -1 padding), on data
    holding signed and explicit zeros."""
    plan = _port_plan(name, 8, 2)
    rng = np.random.default_rng(5)
    data = rng.uniform(-2.0, 2.0, expected_entry_count(plan))
    data[1::5] = np.where(np.arange(data[1::5].size) % 2, -0.0, 0.0)
    fresh = dataclasses.replace(plan, vals=plan.vals.copy(), diag=plan.diag.copy())
    fresh.numeric_update(data)
    assert (plan.val_src < 0).any()  # padding, which the refresh keeps
    slack = 3 if order == "elastic" else 1
    if order == "position":
        plan, fresh = dist.lane_plan(plan, 1), dist.lane_plan(fresh, 1)
        rl = ops.round_level_arrays(plan, np.arange(plan.n_supersteps + 1), device="cpu")
        la, val_src, diag_src = rl.la, rl.val_src, rl.diag_src
    else:
        la = level_plan_arrays(plan, device="cpu", order=level_order(plan, slack))
        val_src, diag_src = ops.level_sources(plan, la.order, device="cpu")
    old = [t.clone() for t in la[:8]]
    got = ops.refresh_level_values(la, val_src, diag_src,
                                   torch.from_numpy(data.astype(np.float32)))
    want = level_plan_arrays(fresh, device="cpu", order=level_order(fresh, slack))
    for pair in (*zip(got[:8], want[:8]), *zip(la[:8], old)):  # and its input untouched
        if pair[0].is_floating_point():
            _assert_bitwise(*pair)
        else:
            assert torch.equal(*pair)
