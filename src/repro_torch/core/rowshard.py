"""Row partitioner — split one compiled ``ExecPlan`` across shards, with a
static *halo exchange plan* instead of an O(n) all-gather.

A NumPy copy of the JAX package's ``core/rowshard.py``;
``tests/test_torch_rowshard.py`` holds every ``RowShardPlan`` array equal
to the original's, in value and dtype. It is the host-side partition: the
``distributed`` backend's ``shard="rows"`` executor
(``solver.rowsharded``) binds each shard's local plan on a mesh position
and runs the exchange tables, and the verifier
(``analysis.rowshard_check``) audits the partition after that bind.

The partition rides the paper's own machinery instead of a graph
partitioner:

  * The §5 reordering has already laid rows out contiguously by
    (superstep, core, rank), so *cores are contiguous row blocks*.
    ``partition_plan`` groups the plan's ``k`` cores into ``n_shards``
    contiguous blocks of ``k_local = k / n_shards`` cores — on
    banded/locality DAGs neighboring cores hold neighboring row bands,
    so almost all dependencies stay inside a shard.
  * BSP validity (Def. 2.1) guarantees every cross-core — hence every
    cross-shard — dependency crosses a superstep barrier.  The schedule
    certificate is therefore *also* the halo-exchange correctness
    certificate: exchanging boundary values only at barriers suffices.
  * The elastic fused-run certificate (``core.elastic``) extends this:
    a fused run has no cross-core reads of values written inside it, so
    one exchange per fused run (``exchange_bounds``) is equally valid —
    barrier fusion and halo exchange compose.

Each shard gets a *local* ``ExecPlan`` over its own index space:
``[0, n_loc)`` owned rows (global-id order), ``[n_loc, n_loc+n_halo)``
halo slots for remote rows it reads, and a trailing scratch slot that
padding reads/writes (always zero).  Row/column ids are remapped to
local slots so a per-shard executor is the ordinary single-plan
executor — same gathers, same fixed-order lane reduction, same scatter.

For every exchange round the partitioner emits exact
(source shard, row) -> (dest shard, slot) index tensors in two lowered
forms (``HaloRound``): a **ring** form (one point-to-point send per
occupied hop distance; bitwise-safe) and a **sparse-psum** form (one sum
reduction of a compact boundary buffer per round).  Both move each
boundary value to each consumer exactly once per solve.

Pure NumPy, inspector-phase work: everything is O(nnz + n) vectorized
passes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.elastic import step_dependencies
from repro_torch.core.plan import ExecPlan


@dataclasses.dataclass
class HaloRound:
    """Static exchange plan for one barrier: the boundary x-entries
    finalized during this round, as gather/scatter index tensors.

    Ring form (``hops``): one ``(h, send_slot, recv_slot)`` triple per
    occupied hop distance ``h`` — shard ``i`` sends
    ``x[send_slot[i, :]]`` to shard ``(i + h) % n_shards`` (one
    point-to-point send), and the receiver scatters position ``p`` into local
    slot ``recv_slot[dst, p]``.  Sender and receiver tables are ordered
    identically (by global row id within each (src, dst) pair), so the
    positional correspondence IS the routing.  Padding positions send
    the scratch slot (always 0) and land on the receiver's scratch slot.

    Sparse-psum form: a shared buffer of ``buf_size`` distinct boundary
    rows (+1 trash position).  Owners scatter-add their fresh values at
    ``send_pos``, one sum reduction across shards adds them, consumers gather
    ``recv_pos`` into their halo slots.  One collective per round
    regardless of hop structure, at the price of the ``x + 0.0``
    negative-zero hazard (``-0.0 + 0.0 == +0.0``): not bitwise-safe
    when a solved boundary value is ``-0.0``, which is why the executor
    defaults to the ring form.
    """

    hops: Tuple  # ((h, send_slot i32[n_shards, H], recv_slot ...), ...)
    send_slot: np.ndarray  # int32[n_shards, Hs]  (psum form)
    send_pos: np.ndarray  # int32[n_shards, Hs]
    recv_pos: np.ndarray  # int32[n_shards, Hr]
    recv_slot: np.ndarray  # int32[n_shards, Hr]
    buf_size: int  # distinct boundary rows this round
    n_values: int  # real (row -> dest shard) pairs exchanged this round

    @property
    def ring_values(self) -> int:
        """Values moved per device this round in ring form (padded)."""
        return int(sum(ss.shape[1] for _, ss, _ in self.hops))


@dataclasses.dataclass
class RowShardPlan:
    """A row-partitioned plan: per-shard local ``ExecPlan``s plus the
    halo exchange schedule.  ``shards[j]`` is a complete, valid plan
    over shard ``j``'s local slot space (its scratch slot is
    ``n_loc + n_halo``); all shards share identical tensor shapes so
    they stack into SPMD operands.

    ``owner[g]`` / ``local_slot[g]`` map global row ``g`` (plan order)
    to its shard and owned slot; ``b_scatter``/``x_gather`` are the
    precomputed flat index maps the executor uses to scatter the rhs
    into per-shard buffers and gather the solution back out.
    ``exchange_bounds`` are superstep indices: exchange round ``r``
    covers supersteps ``[exchange_bounds[r], exchange_bounds[r+1])``
    and is followed by one halo exchange (``rounds[r]``, absent after
    the last round).
    """

    n: int
    n_shards: int
    k_local: int
    n_loc: int
    n_halo: int
    W: int
    T: int
    shards: List[ExecPlan]
    owner: np.ndarray  # int32[n]
    local_slot: np.ndarray  # int64[n]
    step_bounds: tuple  # len S+1 (plan step indices)
    exchange_bounds: tuple  # len F+1 (superstep indices)
    rounds: List[HaloRound]  # len F-1 (no exchange after the last round)
    halo_pairs: int  # total (boundary row -> dest shard) pairs

    @property
    def slots(self) -> int:
        """Local x length: owned + halo + trailing scratch slot."""
        return self.n_loc + self.n_halo + 1

    @property
    def scratch(self) -> int:
        return self.n_loc + self.n_halo

    @property
    def n_rounds(self) -> int:
        return len(self.exchange_bounds) - 1

    @property
    def b_scatter(self) -> np.ndarray:
        """int64[n]: flat index into ``[n_shards * slots]`` placing
        ``b[g]`` at (owner, owned slot)."""
        return self.owner.astype(np.int64) * self.slots + self.local_slot

    @property
    def x_gather(self) -> np.ndarray:
        """int64[n]: flat index into ``[n_shards * n_loc]`` recovering
        ``x[g]`` from the stacked owned regions."""
        return self.owner.astype(np.int64) * self.n_loc + self.local_slot

    def comm_stats(self, itemsize: int = 4) -> dict:
        """The comm-volume model, per device per RHS (JSON-ready).

        ``allgather_values`` is what the model-axis executor's full
        ``all_gather`` moves (every core's xv at every step: ``k * T``);
        the halo numbers are what this partition moves instead.
        ``halo_ratio`` is the headline: padded ring traffic over the
        all-gather baseline."""
        ring = int(sum(r.ring_values for r in self.rounds))
        psum = int(sum(r.buf_size for r in self.rounds))
        per_round = [r.ring_values for r in self.rounds]
        ag = int(self.n_shards * self.k_local * self.T)
        return {
            "n_shards": self.n_shards,
            "exchange_rounds": self.n_rounds,
            "active_exchanges": int(sum(1 for r in self.rounds if r.n_values)),
            "halo_pairs": int(self.halo_pairs),
            "halo_values_per_solve": ring,
            "halo_bytes_per_solve": ring * itemsize,
            "halo_values_psum": psum,
            "halo_values_max_round": int(max(per_round, default=0)),
            "allgather_values": ag,
            "allgather_bytes": ag * itemsize,
            "halo_ratio": ring / max(ag, 1),
        }


def _pad_lanes(plan: ExecPlan, kp: int) -> ExecPlan:
    """Pad the plan's core axis UP to ``kp`` lanes so the cores split
    evenly into shards.  Padding lanes follow the plan's own protocol —
    row id n (scratch), self-gathers, val 0 / diag 1, source maps -1 —
    so they compute harmless writes to the scratch slot."""
    k = plan.k
    if kp == k:
        return plan
    T, pad = plan.n_steps, kp - k

    def padk(a, fill):
        block = np.full((T, pad, *a.shape[2:]), fill, dtype=a.dtype)
        return np.concatenate([a, block], axis=1)

    return dataclasses.replace(
        plan,
        k=kp,
        row_ids=padk(plan.row_ids, plan.n),
        col_idx=padk(plan.col_idx, plan.n),
        vals=padk(plan.vals, 0),
        diag=padk(plan.diag, 1),
        accum=padk(plan.accum, False),
        val_src=None if plan.val_src is None else padk(plan.val_src, -1),
        diag_src=None if plan.diag_src is None else padk(plan.diag_src, -1),
    )


def _group_pad(shard_ids, values, n_shards: int, fill: int) -> np.ndarray:
    """``int32[n_shards, H]`` table: ``values`` grouped by ``shard_ids``
    (input order preserved within each group — callers pre-sort), padded
    with ``fill``.  ``H`` is the max group size (0 groups everywhere ->
    ``[n_shards, 0]``)."""
    shard_ids = np.asarray(shard_ids, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    c = np.bincount(shard_ids, minlength=n_shards)
    H = int(c.max()) if shard_ids.size else 0
    out = np.full((n_shards, H), fill, dtype=np.int32)
    if shard_ids.size:
        order = np.argsort(shard_ids, kind="stable")
        offs = np.concatenate([[0], np.cumsum(c)])
        sid = shard_ids[order]
        ranks = np.arange(shard_ids.size, dtype=np.int64) - offs[sid]
        out[sid, ranks] = values[order]
    return out


def _build_round(
    n_shards: int, scratch: int, u, src, dst, send, recv
) -> HaloRound:
    """Lower one round's (row, src shard, dest shard) pairs to both
    exchange forms.  ``send``/``recv`` are the per-pair local slots."""
    u = np.asarray(u, dtype=np.int64)
    nv = int(u.size)
    hops = []
    if nv:
        hop = (dst - src) % n_shards
        for h in np.unique(hop):
            m = hop == h
            # order pairs by (src, row id): sender and receiver tables
            # get the same per-pair positions (dst = src + h is a
            # bijection, so per-shard group sizes match on both sides)
            o = np.lexsort((u[m], src[m]))
            ss = _group_pad(src[m][o], send[m][o], n_shards, scratch)
            rt = _group_pad(dst[m][o], recv[m][o], n_shards, scratch)
            hops.append((int(h), ss, rt))
    # sparse-psum form: one buffer position per distinct boundary row
    # (a row read by several shards is sent once, gathered by each)
    u_uniq, first = np.unique(u, return_index=True)
    R = int(u_uniq.size)
    pos_of = np.searchsorted(u_uniq, u) if nv else np.zeros(0, np.int64)
    send_slot = _group_pad(src[first], send[first], n_shards, scratch)
    send_pos = _group_pad(
        src[first], np.arange(R, dtype=np.int64), n_shards, R
    )
    recv_pos = _group_pad(dst, pos_of, n_shards, R)
    recv_slot = _group_pad(dst, recv, n_shards, scratch)
    return HaloRound(
        hops=tuple(hops),
        send_slot=send_slot,
        send_pos=send_pos,
        recv_pos=recv_pos,
        recv_slot=recv_slot,
        buf_size=R,
        n_values=nv,
    )


def partition_plan(
    plan: ExecPlan, n_shards: int, *, exchange_bounds=None
) -> RowShardPlan:
    """Partition ``plan``'s rows across ``n_shards`` by contiguous core
    blocks and derive the halo exchange schedule.

    ``exchange_bounds`` (optional, ``int[F+1]`` superstep indices) fuses
    barriers: one exchange per run instead of per superstep.  Pass the
    elastic certificate's ``fused_bounds`` (``core.elastic``) — the
    partitioner *verifies* that no cross-shard dependency is read in the
    round that writes it, so an invalid fusion fails here, at inspection
    time, instead of producing silent garbage on device."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if plan.n_steps == 0 or plan.n == 0:
        raise ValueError("cannot partition an empty plan")
    n, W = plan.n, plan.W
    padded = _pad_lanes(plan, -(-plan.k // n_shards) * n_shards)
    kp = padded.k
    k_local = kp // n_shards
    T = padded.n_steps
    S = padded.n_supersteps
    sb = np.asarray(padded.step_bounds, dtype=np.int64)

    if exchange_bounds is None:
        fb = np.arange(S + 1, dtype=np.int64)
    else:
        fb = np.asarray(exchange_bounds, dtype=np.int64)
    if len(fb) < 2 or fb[0] != 0 or fb[-1] != S or np.any(np.diff(fb) < 1):
        raise ValueError(
            f"exchange_bounds must be increasing superstep bounds "
            f"covering [0, {S}]; got {fb.tolist()}"
        )
    F = len(fb) - 1
    round_of_sup = np.repeat(np.arange(F, dtype=np.int64), np.diff(fb))
    sup_of_step = np.repeat(np.arange(S, dtype=np.int64), np.diff(sb))

    writer_step, writer_lane, _ = step_dependencies(padded)
    owner = (writer_lane // k_local).astype(np.int32)
    writer_round = round_of_sup[sup_of_step[writer_step]]  # per row

    # owned slots: rows sorted by (owner, global id) — after the §5
    # reorder global ids are (superstep, core, rank)-sorted, so each
    # shard's owned region is a run of contiguous row bands
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    offs = np.concatenate([[0], np.cumsum(counts)])
    local_slot = np.empty(n, dtype=np.int64)
    local_slot[order] = np.arange(n, dtype=np.int64) - offs[owner[order]]
    n_loc = max(int(counts.max()), 1)

    # cross-shard dependency edges: every real gather whose column's
    # owner differs from the reading lane's shard
    shape = padded.col_idx.shape
    lane = np.broadcast_to(np.arange(kp, dtype=np.int64)[None, :, None], shape)
    reader_shard = lane // k_local
    owner_pad = np.concatenate([owner.astype(np.int64), [-1]])
    cross = (padded.col_idx != n) & (owner_pad[padded.col_idx] != reader_shard)
    u_all = padded.col_idx[cross].astype(np.int64)
    dst_all = reader_shard[cross]

    # the certificate check: a cross-shard value must be written in an
    # earlier exchange round than every read of it (Def. 2.1 for the
    # per-superstep bounds; the fused-run certificate otherwise)
    t_idx = np.broadcast_to(
        np.arange(T, dtype=np.int64)[:, None, None], shape
    )
    reader_round = round_of_sup[sup_of_step[t_idx[cross]]]
    bad = writer_round[u_all] >= reader_round
    if np.any(bad):
        g = int(u_all[bad][0])
        raise ValueError(
            f"exchange_bounds do not certify this partition: row {g} is "
            f"read across shards in the round that writes it "
            f"(round {int(writer_round[g])}) — the schedule/fusion "
            f"certificate is violated"
        )

    key = u_all * n_shards + dst_all
    ukey = np.unique(key)
    u_h = ukey // n_shards
    dst_h = ukey % n_shards
    halo_pairs = int(ukey.size)

    # halo slot ranks per dest shard, ordered by (dst, global row id)
    order_h = np.lexsort((u_h, dst_h))
    hcounts = np.bincount(dst_h, minlength=n_shards)
    hoffs = np.concatenate([[0], np.cumsum(hcounts)])
    halo_rank = np.empty(halo_pairs, dtype=np.int64)
    halo_rank[order_h] = (
        np.arange(halo_pairs, dtype=np.int64) - hoffs[dst_h[order_h]]
    )
    n_halo = int(hcounts.max()) if halo_pairs else 0

    # per-shard global -> local slot lookup (scratch by default, so the
    # global scratch column n and never-referenced rows stay harmless)
    scratch = n_loc + n_halo
    g2l = np.full((n_shards, n + 1), scratch, dtype=np.int64)
    g2l[owner, np.arange(n)] = local_slot
    if halo_pairs:
        g2l[dst_h, u_h] = n_loc + halo_rank

    sidx = np.arange(n_shards)

    def stack(a):  # [T, kp, ...] -> [n_shards, T, k_local, ...]
        moved = a.reshape(T, n_shards, k_local, *a.shape[2:])
        return np.ascontiguousarray(np.moveaxis(moved, 1, 0))

    rows_st = stack(padded.row_ids)
    cols_st = stack(padded.col_idx)
    row_loc = g2l[sidx[:, None, None], rows_st].astype(np.int32)
    col_loc = g2l[sidx[:, None, None, None], cols_st].astype(np.int32)
    vals_st = stack(padded.vals)
    diag_st = stack(padded.diag)
    acc_st = stack(padded.accum)
    vsrc_st = None if padded.val_src is None else stack(padded.val_src)
    dsrc_st = None if padded.diag_src is None else stack(padded.diag_src)

    shards = [
        ExecPlan(
            n=scratch,
            k=k_local,
            W=W,
            row_ids=row_loc[j],
            col_idx=col_loc[j],
            vals=vals_st[j],
            diag=diag_st[j],
            accum=acc_st[j],
            step_bounds=np.asarray(padded.step_bounds).copy(),
            val_src=None if vsrc_st is None else vsrc_st[j],
            diag_src=None if dsrc_st is None else dsrc_st[j],
        )
        for j in range(n_shards)
    ]

    # exchange rounds: boundary rows grouped by the round that writes
    # them (each value moves to each consumer exactly once, right after
    # it is finalized; it then stays resident in the halo slot)
    src_h = owner_pad[u_h]
    wr_h = writer_round[u_h]
    send_local = local_slot[u_h]
    recv_local = n_loc + halo_rank
    rounds = []
    for r in range(max(F - 1, 0)):
        m = wr_h == r
        rounds.append(
            _build_round(
                n_shards, scratch,
                u_h[m], src_h[m], dst_h[m], send_local[m], recv_local[m],
            )
        )

    return RowShardPlan(
        n=n,
        n_shards=n_shards,
        k_local=k_local,
        n_loc=n_loc,
        n_halo=n_halo,
        W=W,
        T=T,
        shards=shards,
        owner=owner,
        local_slot=local_slot,
        step_bounds=tuple(int(t) for t in padded.step_bounds),
        exchange_bounds=tuple(int(s) for s in fb),
        rounds=rounds,
        halo_pairs=halo_pairs,
    )
