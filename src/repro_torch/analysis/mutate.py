"""Mutation harness — seeded corruptions that MUST fail verification.

A copy of the JAX package's ``analysis/mutate.py`` over the port's
pipeline, with a fifth family of its own, ``levels``: corruptions of the
level order the CUDA kernels walk (``kernels/levels.py``), each of which
``analysis.level_check`` must catch.

A verifier's dangerous failure mode is silence: it runs, reports
nothing, and everyone trusts a plan it never actually checked.  The
harness closes that hole by construction — each operator injects one
realistic bug (the kind a scheduler/compiler/partitioner regression
would produce) into an otherwise-valid artifact set, and the tier-1
suite asserts ``verify_artifacts`` flags **every** mutant while the
pristine artifacts stay clean.

Operators never touch producer code: they corrupt the *artifacts*
(schedule arrays, plan tensors, certificates, halo tables, level
orders), exactly
where a buggy producer would have left the damage.  An operator may
return ``None`` when the artifact set has no site for its bug (e.g. no
accum chains at wide W, one shard); the runner treats that as "not
applicable", and the harness setup guarantees every family has at least
one applicable artifact set.

Usage::

    arts = build_artifacts(matrix, strategy="growlocal", k=8,
                           slack=4, n_shards=4)
    for m in MUTATIONS:
        bad = m.apply(arts, np.random.default_rng(0))
        assert bad is None or not verify_artifacts(bad, level="full").ok
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.analysis import Artifacts

__all__ = [
    "MUTATIONS",
    "Mutation",
    "build_artifacts",
    "run_harness",
]


def build_artifacts(
    a,
    *,
    strategy: str = "growlocal",
    k: int = 8,
    lower: bool = True,
    slack: int = 0,
    n_shards: int = 1,
    width: Optional[int] = None,
    dtype=np.float32,
    levels: bool = True,
) -> Artifacts:
    """Run the inspector pipeline on matrix ``a`` and keep every
    intermediate artifact (the pipeline's ``plan()`` discards the
    pre-rebase state the verifier wants).  Mirrors ``pipeline.solver``'s
    build: mirror -> DAG -> schedule -> §5 reorder -> compile ->
    elastic -> rowshard, plus (``levels``) the level orders the ``kernel``
    backend's bind builds: the bulk one, and with ``slack`` the elastic
    one.  Host-side only — no backend is bound."""
    from repro_torch.core.elastic import elastic_transform
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.reorder import apply_reordering
    from repro_torch.core.rowshard import partition_plan
    from repro_torch.kernels.levels import level_order
    from repro_torch.pipeline.registry import ScheduleOptions, get_scheduler
    from repro_torch.pipeline.solver import mirror_to_lower
    from repro_torch.sparse.dag import dag_from_lower_csr

    m0, _ = mirror_to_lower(a, lower)
    dag = dag_from_lower_csr(m0)
    o = ScheduleOptions(k=k, slack=slack)
    s = get_scheduler(strategy)(dag, o)
    m2, s2, _, r = apply_reordering(m0, s)
    plan = compile_plan(m2, s2, width=width, dtype=dtype)
    ep = None
    if slack > 0:
        ep = elastic_transform(plan, slack)
        plan.elastic = ep
    rsp = None
    if n_shards > 1:
        rsp = partition_plan(
            plan, n_shards,
            exchange_bounds=None if ep is None else ep.fused_bounds,
        )
    lv = elv = None
    if levels:
        lv = level_order(plan)
        if ep is not None:
            elv = level_order(plan, slack=ep.slack)
    return Artifacts(
        L=m2, sched=s2, plan=plan, perm=r.perm, sched_pre=s,
        elastic=ep, rowshard=rsp, levels=lv, elastic_levels=elv,
    )


# -- copy helpers (operators must never alias the pristine artifacts) -------

def _copy_sched(s):
    return dataclasses.replace(
        s, pi=np.array(s.pi), sigma=np.array(s.sigma), rank=np.array(s.rank)
    )


def _copy_plan(p):
    q = dataclasses.replace(
        p,
        row_ids=np.array(p.row_ids),
        col_idx=np.array(p.col_idx),
        vals=np.array(p.vals),
        diag=np.array(p.diag),
        accum=np.array(p.accum),
        step_bounds=np.array(p.step_bounds),
        val_src=None if p.val_src is None else np.array(p.val_src),
        diag_src=None if p.diag_src is None else np.array(p.diag_src),
    )
    q.elastic = p.elastic
    return q


def _with_sched(art: Artifacts, s2) -> Artifacts:
    return dataclasses.replace(art, sched=s2)


def _with_plan(art: Artifacts, p) -> Artifacts:
    return dataclasses.replace(art, plan=p)


# -- schedule family --------------------------------------------------------

def schedule_swap_steps(art: Artifacts, rng) -> Optional[Artifacts]:
    """Move a dependent vertex to its producer's superstep on another
    core — the classic barrier-elision race."""
    from repro_torch.analysis.schedule_check import strict_lower_edges

    s = _copy_sched(art.sched)
    u, v = strict_lower_edges(art.L)
    cross = (s.pi[u] != s.pi[v]) & (s.sigma[u] < s.sigma[v])
    if not cross.any():
        return None
    i = int(rng.choice(np.nonzero(cross)[0]))
    s.sigma[v[i]] = s.sigma[u[i]]
    return _with_sched(art, s)


def schedule_backward_edge(art: Artifacts, rng) -> Optional[Artifacts]:
    """Schedule a consumer strictly before its producer."""
    from repro_torch.analysis.schedule_check import strict_lower_edges

    s = _copy_sched(art.sched)
    u, v = strict_lower_edges(art.L)
    fwd = s.sigma[u] < s.sigma[v]
    if not fwd.any():
        return None
    i = int(rng.choice(np.nonzero(fwd)[0]))
    s.sigma[v[i]] = s.sigma[u[i]] - 1
    if s.sigma[v[i]] < 0:
        s.sigma[u[i]] += 1
        s.sigma[v[i]] += 1
    return _with_sched(art, s)


def schedule_chain_rank_flip(art: Artifacts, rng) -> Optional[Artifacts]:
    """Reverse in-chain rank across a same-(step, core) dependency."""
    from repro_torch.analysis.schedule_check import strict_lower_edges

    s = _copy_sched(art.sched)
    u, v = strict_lower_edges(art.L)
    chain = (s.pi[u] == s.pi[v]) & (s.sigma[u] == s.sigma[v])
    if not chain.any():
        return None
    i = int(rng.choice(np.nonzero(chain)[0]))
    s.rank[u[i]], s.rank[v[i]] = s.rank[v[i]], int(s.rank[u[i]])
    return _with_sched(art, s)


def reorder_collide(art: Artifacts, rng) -> Optional[Artifacts]:
    """Duplicate an id in the §5 permutation (a broken argsort)."""
    if art.perm is None or len(art.perm) < 2:
        return None
    perm = np.array(art.perm)
    perm[0] = perm[1]
    return dataclasses.replace(art, perm=perm)


# -- plan family ------------------------------------------------------------

def plan_swap_rows(art: Artifacts, rng) -> Optional[Artifacts]:
    """Swap two finalizing slots across supersteps — rows finish in the
    wrong step, breaking both write discipline and the lane layout."""
    p = _copy_plan(art.plan)
    sb = np.asarray(p.step_bounds)
    final = (p.row_ids != p.n) & ~p.accum
    t, lane = np.nonzero(final)
    if len(t) < 2:
        return None
    sup = np.searchsorted(sb, t, side="right") - 1
    first = (t == t.min()) if (sup == sup[0]).all() else (sup == sup.min())
    a = int(np.nonzero(first)[0][0])
    b = int(np.nonzero(~first)[0][-1]) if (~first).any() else -1
    if b < 0:
        return None
    (ta, la), (tb, lb) = (t[a], lane[a]), (t[b], lane[b])
    ra, rb = int(p.row_ids[ta, la]), int(p.row_ids[tb, lb])
    p.row_ids[ta, la], p.row_ids[tb, lb] = rb, ra
    return _with_plan(art, p)


def plan_oob_gather(art: Artifacts, rng) -> Optional[Artifacts]:
    """Point one real gather past the scratch slot."""
    p = _copy_plan(art.plan)
    real = p.val_src is not None and (np.asarray(p.val_src) >= 0)
    if not np.any(real):
        return None
    t, lane, w = (int(x[0]) for x in np.nonzero(real))
    p.col_idx[t, lane, w] = p.n + 5
    return _with_plan(art, p)


def plan_double_write(art: Artifacts, rng) -> Optional[Artifacts]:
    """A padding slot claims a row some other slot already finalizes."""
    p = _copy_plan(art.plan)
    pad = p.row_ids == p.n
    if not pad.any():
        return None
    t, lane = (int(x[0]) for x in np.nonzero(pad))
    real = p.row_ids[p.row_ids != p.n]
    if not len(real):
        return None
    p.row_ids[t, lane] = int(real[0])
    return _with_plan(art, p)


def plan_corrupt_padding(art: Artifacts, rng) -> Optional[Artifacts]:
    """Nonzero values on a padding slot — inert lanes start contributing."""
    p = _copy_plan(art.plan)
    pad = p.row_ids == p.n
    if not pad.any():
        return None
    t, lane = (int(x[0]) for x in np.nonzero(pad))
    p.vals[t, lane, :] = 1.0
    return _with_plan(art, p)


def plan_scratch_escape(art: Artifacts, rng) -> Optional[Artifacts]:
    """A real slot's scratch-padded gather gets a nonzero coefficient —
    the scratch slot's transient garbage leaks into the solve."""
    p = _copy_plan(art.plan)
    if p.val_src is None:
        return None
    realrow = p.row_ids != p.n
    scratch = (np.asarray(p.col_idx) == p.n) & realrow[:, :, None]
    if not scratch.any():
        return None
    t, lane, w = (int(x[0]) for x in np.nonzero(scratch))
    p.vals[t, lane, w] = 0.5
    return _with_plan(art, p)


def plan_accum_reorder(art: Artifacts, rng) -> Optional[Artifacts]:
    """Flip a split row's accum flags so the chain finalizes first and
    accumulates afterwards — the partial sums are lost."""
    p = _copy_plan(art.plan)
    acc = np.asarray(p.accum)
    if not acc.any():
        return None
    t, lane = (int(x[0]) for x in np.nonzero(acc))
    row = int(p.row_ids[t, lane])
    chain = np.nonzero((p.row_ids == row).any(axis=1))[0]
    last = int(chain[-1])
    lane_last = int(np.nonzero(p.row_ids[last] == row)[0][0])
    p.accum[t, lane] = False
    p.accum[last, lane_last] = True
    return _with_plan(art, p)


def plan_zero_diag(art: Artifacts, rng) -> Optional[Artifacts]:
    """Zero diagonal on a finalizing slot — a guaranteed NaN/Inf row."""
    p = _copy_plan(art.plan)
    final = (p.row_ids != p.n) & ~p.accum
    if not final.any():
        return None
    t, lane = (int(x[0]) for x in np.nonzero(final))
    p.diag[t, lane] = 0.0
    return _with_plan(art, p)


# -- elastic family ---------------------------------------------------------

def _copy_elastic(ep):
    return dataclasses.replace(
        ep,
        ready_step=np.array(ep.ready_step),
        wave_id=np.array(ep.wave_id),
        n_waves=np.array(ep.n_waves),
        fused_bounds=np.array(ep.fused_bounds),
    )


def _with_elastic(art: Artifacts, ep) -> Artifacts:
    p = _copy_plan(art.plan)
    p.elastic = ep
    return dataclasses.replace(art, plan=p, elastic=ep)


def elastic_widen_wave(art: Artifacts, rng) -> Optional[Artifacts]:
    """Fuse a dependent step into its producer's wave (erase the first
    wave break of some window)."""
    if art.elastic is None:
        return None
    ep = _copy_elastic(art.elastic)
    wave = ep.wave_id
    brk = np.nonzero(np.diff(wave, axis=1) == 1)
    if not len(brk[0]):
        return None
    m, j = int(brk[0][0]), int(brk[1][0])
    wave[m, j + 1:] -= 1
    ep = dataclasses.replace(ep, n_waves=wave[:, -1] + 1)
    return _with_elastic(art, ep)


def elastic_shrink_ready(art: Artifacts, rng) -> Optional[Artifacts]:
    """Certify a step ready one plan-step early."""
    if art.elastic is None:
        return None
    ep = _copy_elastic(art.elastic)
    pos = np.nonzero(ep.ready_step > 0)[0]
    if not len(pos):
        return None
    ep.ready_step[int(pos[0])] -= 1
    return _with_elastic(art, ep)


def elastic_widen_fused_run(art: Artifacts, rng) -> Optional[Artifacts]:
    """Drop an interior fused-bounds barrier — either a cross-core read
    lands inside its own run, or the run exceeds the slack cap."""
    if art.elastic is None or len(art.elastic.fused_bounds) < 3:
        return None
    ep = _copy_elastic(art.elastic)
    fb = np.delete(ep.fused_bounds, 1)
    ep = dataclasses.replace(ep, fused_bounds=fb)
    return _with_elastic(art, ep)


# -- rowshard family --------------------------------------------------------

def _copy_rsp(rsp):
    rounds = []
    for rd in rsp.rounds:
        rounds.append(dataclasses.replace(
            rd,
            hops=tuple(
                (h, np.array(ss), np.array(rt)) for h, ss, rt in rd.hops
            ),
            send_slot=np.array(rd.send_slot),
            send_pos=np.array(rd.send_pos),
            recv_pos=np.array(rd.recv_pos),
            recv_slot=np.array(rd.recv_slot),
        ))
    return dataclasses.replace(
        rsp,
        shards=list(rsp.shards),
        owner=np.array(rsp.owner),
        local_slot=np.array(rsp.local_slot),
        rounds=rounds,
    )


def _with_rsp(art: Artifacts, rsp) -> Artifacts:
    return dataclasses.replace(art, rowshard=rsp)


def _first_psum_round(rsp):
    for i, rd in enumerate(rsp.rounds):
        realR = np.asarray(rd.recv_slot) != rsp.scratch
        if realR.any():
            return i, realR
    return None, None


def rowshard_drop_halo(art: Artifacts, rng) -> Optional[Artifacts]:
    """Silence one shipment in both lowered forms — a consumer's halo
    slot never receives its boundary value."""
    if art.rowshard is None:
        return None
    rsp = _copy_rsp(art.rowshard)
    i, realR = _first_psum_round(rsp)
    if i is None:
        return None
    rd = rsp.rounds[i]
    d, p_ = (int(x[0]) for x in np.nonzero(realR))
    slot = int(rd.recv_slot[d, p_])
    rd.recv_slot[d, p_] = rsp.scratch
    rd.recv_pos[d, p_] = int(rd.buf_size)
    for h, ss, rt in rd.hops:
        hit = rt[d] == slot
        if hit.any():
            rt[d, np.nonzero(hit)[0]] = rsp.scratch
            src = (d - h) % rsp.n_shards
            ss[src, np.nonzero(hit)[0]] = rsp.scratch
    return _with_rsp(art, rsp)


def rowshard_wrong_round(art: Artifacts, rng) -> Optional[Artifacts]:
    """Swap two occupied exchange rounds' tables — the later round's
    values now ship before the round that writes them."""
    if art.rowshard is None or len(art.rowshard.rounds) < 2:
        return None
    rsp = _copy_rsp(art.rowshard)
    occ = [
        i for i, rd in enumerate(rsp.rounds)
        if (np.asarray(rd.recv_slot) != rsp.scratch).any()
    ]
    if len(occ) < 2:
        return None
    i, j = occ[0], occ[1]
    rsp.rounds[i], rsp.rounds[j] = rsp.rounds[j], rsp.rounds[i]
    return _with_rsp(art, rsp)


def rowshard_wrong_slot(art: Artifacts, rng) -> Optional[Artifacts]:
    """Rotate one psum recv slot inside the halo region — the consumer's
    gathers now read a different boundary row's value."""
    if art.rowshard is None or art.rowshard.n_halo < 1:
        return None
    rsp = _copy_rsp(art.rowshard)
    i, realR = _first_psum_round(rsp)
    if i is None:
        return None
    rd = rsp.rounds[i]
    d, p_ = (int(x[0]) for x in np.nonzero(realR))
    n_loc, n_halo = rsp.n_loc, rsp.n_halo
    slot = int(rd.recv_slot[d, p_])
    rot = n_loc + (slot - n_loc + 1) % n_halo
    if rot == slot:
        return None
    rd.recv_slot[d, p_] = rot
    return _with_rsp(art, rsp)


def rowshard_owner_flip(art: Artifacts, rng) -> Optional[Artifacts]:
    """Assign one row to a shard whose lanes never finalize it."""
    if art.rowshard is None or art.rowshard.n_shards < 2:
        return None
    rsp = _copy_rsp(art.rowshard)
    rsp.owner[0] = (int(rsp.owner[0]) + 1) % rsp.n_shards
    return _with_rsp(art, rsp)


# -- levels family ----------------------------------------------------------
# The order is read by attribute (``perm``, ``vert_ptr``, ``level_ptr``,
# ``level_run``, ``slack``) and rebuilt with ``_replace``; the operators
# corrupt the bulk order ``art.levels``.

def _with_levels(art: Artifacts, **arrays) -> Artifacts:
    lv = art.levels
    new = lv._replace(**{k: np.array(v) for k, v in arrays.items()})
    return dataclasses.replace(art, levels=new)


def levels_merge_dependent(art: Artifacts, rng) -> Optional[Artifacts]:
    """Drop the barrier between two levels of one run where the later
    reads a row the earlier finishes — the two run as one level, a race
    the order's structure alone does not show."""
    if art.levels is None:
        return None
    lv, p = art.levels, art.plan
    perm = np.asarray(lv.perm, dtype=np.int64)
    vp = np.asarray(lv.vert_ptr, dtype=np.int64)
    lp = np.asarray(lv.level_ptr, dtype=np.int64)
    run = np.asarray(lv.level_run, dtype=np.int64)
    # each walked lane-step's level, and the level that finishes each row
    vid = np.repeat(np.arange(len(vp) - 1), np.diff(vp))
    lvl = np.repeat(np.arange(len(lp) - 1), np.diff(lp))[vid]
    fin = ~np.asarray(p.accum).reshape(-1)[perm]
    rows = np.asarray(p.row_ids).reshape(-1)[perm].astype(np.int64)
    w_lvl = np.full(p.n + 1, -1, dtype=np.int64)
    w_lvl[rows[fin]] = lvl[fin]
    cols = np.asarray(p.col_idx).reshape(-1, p.W)[perm].astype(np.int64)
    reads_prev = w_lvl[np.minimum(cols, p.n)] == (lvl - 1)[:, None]
    dep = (lvl > 0) & reads_prev.any(axis=1)
    dep &= run[lvl] == run[np.maximum(lvl - 1, 0)]
    if not dep.any():
        return None
    g = int(lvl[dep][0])
    return _with_levels(
        art, level_ptr=np.delete(lp, g), level_run=np.delete(run, g),
    )


def levels_move_finish(art: Artifacts, rng) -> Optional[Artifacts]:
    """Move a vertex's finishing step into the next vertex — the row is
    finished by a vertex of another lane, and the chain it ended is left
    open (an accumulator the kernel never writes out)."""
    lv = art.levels
    if lv is None or len(lv.vert_ptr) < 3:
        return None
    sizes = np.diff(np.asarray(lv.vert_ptr))[:-1]  # vertices with a successor
    multi = np.flatnonzero(sizes > 1)
    v = int(multi[0]) if multi.size else 0
    vp = np.array(lv.vert_ptr)
    vp[v + 1] -= 1
    return _with_levels(art, vert_ptr=vp)


def levels_shift_run(art: Artifacts, rng) -> Optional[Artifacts]:
    """Put the last level in the next run — its vertices claim a run of
    supersteps they do not belong to."""
    lv = art.levels
    if lv is None or len(lv.level_run) < 1:
        return None
    run = np.array(lv.level_run)
    run[-1] += 1
    return _with_levels(art, level_run=run)


def levels_reverse_chain(art: Artifacts, rng) -> Optional[Artifacts]:
    """Walk an accum chain backwards — the same steps and the same
    finishing step, but the partial sums are added in another order."""
    lv = art.levels
    if lv is None:
        return None
    vp = np.asarray(lv.vert_ptr)
    multi = np.flatnonzero(np.diff(vp) > 1)
    if not multi.size:
        return None
    v = int(multi[0])
    perm = np.array(lv.perm)
    perm[vp[v]:vp[v + 1]] = perm[vp[v]:vp[v + 1]][::-1].copy()
    return _with_levels(art, perm=perm)


@dataclasses.dataclass(frozen=True)
class Mutation:
    name: str
    family: str  # schedule | plan | elastic | rowshard | levels
    apply: Callable[[Artifacts, np.random.Generator], Optional[Artifacts]]


MUTATIONS: Tuple[Mutation, ...] = tuple(
    Mutation(fn.__name__, family, fn)
    for family, fns in (
        ("schedule", (
            schedule_swap_steps, schedule_backward_edge,
            schedule_chain_rank_flip, reorder_collide,
        )),
        ("plan", (
            plan_swap_rows, plan_oob_gather, plan_double_write,
            plan_corrupt_padding, plan_scratch_escape,
            plan_accum_reorder, plan_zero_diag,
        )),
        ("elastic", (
            elastic_widen_wave, elastic_shrink_ready,
            elastic_widen_fused_run,
        )),
        ("rowshard", (
            rowshard_drop_halo, rowshard_wrong_round,
            rowshard_wrong_slot, rowshard_owner_flip,
        )),
        ("levels", (
            levels_merge_dependent, levels_move_finish, levels_shift_run,
            levels_reverse_chain,
        )),
    )
    for fn in fns
)


def run_harness(
    artifact_sets: List[Tuple[str, Artifacts]], *, seed: int = 0
) -> List[dict]:
    """Apply every mutation to every artifact set; one record per
    (mutation, set) with the verifier's verdict.  ``caught`` is None
    where the operator found no site (not applicable)."""
    from repro_torch.analysis import verify_artifacts

    rows: List[dict] = []
    for m in MUTATIONS:
        for label, art in artifact_sets:
            rng = np.random.default_rng(seed)
            bad = m.apply(art, rng)
            caught = None
            codes: Tuple[str, ...] = ()
            if bad is not None:
                rep = verify_artifacts(bad, level="full")
                caught = not rep.ok
                codes = rep.codes()
            rows.append({
                "mutation": m.name,
                "family": m.family,
                "artifacts": label,
                "caught": caught,
                "codes": list(codes),
            })
    return rows
