"""Row-sharded SpTRSV executor, ``shard="rows"``: local levels + halo exchange.

The port's counterpart of the JAX package's ``solver/rowsharded.py``, the
device half of the ``distributed`` backend's ``shard="rows"`` mode
(partition in ``core.rowshard``; bind through
``get_backend("distributed").bind(plan, mesh=mesh, shard="rows")``).

Model position j owns shard j: a contiguous block of ``k_local`` schedule
cores and their rows, as a local ``ExecPlan`` over its own slots
``[owned | halo | scratch]``. Its x is resident in those slots, and its
plan is bound in the bulk level order with the level range of each
exchange round (``rowshard_plan_args``). A solve runs round by round:
every shard walks its round's levels on its resident x, one range launch
of the level kernel (``kernels.sptrsv.sptrsv_level_range_cuda``; the plain
version for a position on the CPU), then the halo exchange moves only the
boundary values another shard reads, by the static tables of
``core.rowshard``. Each row gets the plan's own chain of fused
multiply-adds on the same values, so the answer is bitwise the
single-device scan's (the reference's own contract).

Two forms of the same exchange (``rowshard_halo_args``):

  * ``mode="ring"`` (the bind's): per occupied hop distance h, shard i's
    ``x[send_slot[i]]`` lands in shard ``(i + h) % n``'s ``recv_slot``.
    Values are copied, so bits move unchanged. The port copies all of a
    shard's hops with one gather, and each receiver takes its hops with one
    scatter.
  * ``mode="psum"``: owners add their fresh values into a shared
    ``[buf_size + 1]`` buffer, the buffers are summed over shards in shard
    order, and receivers gather their positions. One owner writes each
    position, so the sum is value + zeros: exact, but ``-0.0 + 0.0`` is
    ``+0.0``, so it is not bitwise-safe. Opt-in, as in JAX.

The right-hand sides split over the ``data`` axis (m padded to a multiple
of it; one right-hand side runs on data row 0). ``lower_rowsharded_solve``
lowers XLA for the JAX package's dry run and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.rowshard import RowShardPlan
from repro_torch.kernels.ops import round_level_arrays
from repro_torch.solver.distributed import launch_round, per_position, positions


@dataclasses.dataclass(frozen=True)
class RowShardSpec:
    """What the executor reads of a row-sharded solve, built once at bind."""

    n_loc: int  # owned slots per shard
    step_bounds: Tuple[int, ...]
    exchange_bounds: Tuple[int, ...]
    mode: str = "ring"  # "ring" | "psum"

    @property
    def n_rounds(self) -> int:
        return len(self.exchange_bounds) - 1


def rowshard_spec(rsp: RowShardPlan, *, mode="ring") -> RowShardSpec:
    if mode not in ("ring", "psum"):
        raise ValueError(f"exchange mode must be 'ring' or 'psum': {mode!r}")
    return RowShardSpec(
        n_loc=rsp.n_loc,
        step_bounds=tuple(int(t) for t in rsp.step_bounds),
        exchange_bounds=tuple(int(s) for s in rsp.exchange_bounds),
        mode=mode,
    )


def rowshard_plan_args(rsp: RowShardPlan, mesh, dtype=torch.float32) -> List[list]:
    """``[data][model]`` ``RoundLevels``: model position j holds shard j's
    local plan in the bulk level order on its device, with the level range
    of each exchange round (cut at ``rsp.exchange_bounds``) and its
    level-ordered GLOBAL entry sources, from which one gather refreshes
    every shard's values."""
    if mesh.shape["model"] != rsp.n_shards:
        raise ValueError(f"{rsp.n_shards} shards on a model axis of {mesh.shape['model']}")
    return per_position(mesh, lambda dev, j: round_level_arrays(
        rsp.shards[j], rsp.exchange_bounds, dtype=dtype, device=dev))


class RingRound(NamedTuple):
    """One round's ring exchange, ``[data][model]`` int64 tensors on the
    positions' devices. ``send[d][j]`` holds the local slots shard j sends,
    its hops' tables concatenated in hop order; ``recv[d][j]`` the slots it
    receives into, in the same order. ``hops`` gives ``(h, H)`` per
    occupied hop: a shard's values for hop h sit at offset ``sum(H before)``
    of its send, H wide (padding sends the scratch slot, 0, to the
    receiver's scratch slot)."""

    send: list
    recv: list
    hops: tuple


class PsumRound(NamedTuple):
    """One round's sparse-psum exchange, ``[data][model]`` int64 tensors."""

    send_slot: list
    send_pos: list
    recv_pos: list
    recv_slot: list
    buf_size: int


def halo_args_for_round(rsp: RowShardPlan, mesh, r: int, mode="ring"):
    """The exchange tables of round ``r`` (``RingRound`` or ``PsumRound``)."""
    hr = rsp.rounds[r]

    def table(a):
        return per_position(mesh, lambda dev, j: torch.as_tensor(
            np.asarray(a[j], np.int64)).to(dev))

    if mode == "ring":
        cat = (lambda ts: np.concatenate(ts, axis=1) if ts else  # noqa: E731
               np.zeros((rsp.n_shards, 0), np.int64))
        return RingRound(
            send=table(cat([ss for _, ss, _ in hr.hops])),
            recv=table(cat([rt for _, _, rt in hr.hops])),
            hops=tuple((int(h), int(ss.shape[1])) for h, ss, _ in hr.hops),
        )
    if mode != "psum":
        raise ValueError(f"exchange mode must be 'ring' or 'psum': {mode!r}")
    return PsumRound(
        send_slot=table(hr.send_slot),
        send_pos=table(hr.send_pos),
        recv_pos=table(hr.recv_pos),
        recv_slot=table(hr.recv_slot),
        buf_size=int(hr.buf_size),
    )


def rowshard_halo_args(rsp: RowShardPlan, mesh, mode="ring") -> list:
    """The exchange tables of every round but the last (none follows it)."""
    return [halo_args_for_round(rsp, mesh, r, mode) for r in range(len(rsp.rounds))]


def _exchange_ring(mesh, d, xs_row, rr: RingRound) -> None:
    """One ring round along data row ``d``: each shard gathers everything
    it sends this round on its own stream; each receiver waits on its
    sources, concatenates its hops' values (hop h from shard ``(dst - h) %
    n``) and scatters them into its halo slots. Values move unchanged."""
    n = len(xs_row)
    if not rr.hops:
        return
    sends, evs = [], []
    for j in range(n):
        with mesh.on((d, j)):
            sends.append(xs_row[j].index_select(-1, rr.send[d][j]))
        evs.append(mesh.mark((d, j)))
    for dst in range(n):
        srcs = [(dst - h) % n for h, _ in rr.hops]
        mesh.wait((d, dst), [evs[s] for s in set(srcs)])
        with mesh.on((d, dst)):
            parts, off = [], 0
            for (_, width), src in zip(rr.hops, srcs):
                part = sends[src].narrow(-1, off, width)
                parts.append(mesh.move(part, (d, src), (d, dst)))
                off += width
            vals = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            xs_row[dst].index_copy_(-1, rr.recv[d][dst], vals)


def _exchange_psum(mesh, d, xs_row, pr: PsumRound) -> None:
    """One sparse-psum round along data row ``d``: owners add their fresh
    boundary values into a zeroed ``[buf_size + 1]`` buffer (the last
    position takes the padding), the buffers are summed over shards in
    shard order on position (d, 0), and receivers gather their positions
    into their halo slots."""
    n = len(xs_row)
    bufs, evs = [], []
    for j in range(n):
        with mesh.on((d, j)):
            x = xs_row[j]
            buf = x.new_zeros((*x.shape[:-1], pr.buf_size + 1))
            # repro: blessed-reduction — one owner writes each position
            # (the trash position takes only padding zeros), so this is
            # value + 0; -0.0 + 0.0 == +0.0 is why the bind keeps the ring
            buf.index_add_(-1, pr.send_pos[d][j], x.index_select(-1, pr.send_slot[d][j]))
            bufs.append(buf)
        evs.append(mesh.mark((d, j)))
    home = (d, 0)
    mesh.wait(home, evs)
    with mesh.on(home):
        total = bufs[0]
        for j in range(1, n):  # the sum over shards, in shard order
            total = total + mesh.move(bufs[j], (d, j), home)
    ev = mesh.mark(home)
    for dst in range(n):
        mesh.wait((d, dst), [ev])
        with mesh.on((d, dst)):
            got = mesh.move(total, home, (d, dst)).index_select(-1, pr.recv_pos[d][dst])
            xs_row[dst].index_copy_(-1, pr.recv_slot[d][dst], got)


def place_local_rhs(mesh, b_loc) -> tuple:
    """``(bs, xs)`` ``[data][model]``: shard j's local right-hand side on
    each position that takes part, and a zeroed resident x beside it.
    ``b_loc`` is f[n_shards, slots] (one right-hand side, data row 0) or
    f[n_shards, slots, batch] (batch a multiple of the data axis; data row
    d takes columns ``[d m_local, (d+1) m_local)``, column-major f[m_local,
    slots] on the position)."""
    D, K = mesh.shape["data"], mesh.shape["model"]
    single = b_loc.dim() == 2
    bs = [[None] * K for _ in range(D)]
    xs = [[None] * K for _ in range(D)]
    ml = 0 if single else b_loc.shape[2] // D
    for d, j in positions(mesh, single):
        part = b_loc[j] if single else b_loc[j, :, d * ml:(d + 1) * ml].T
        bs[d][j] = part.to(mesh.device((d, j))).contiguous()
        xs[d][j] = torch.zeros_like(bs[d][j])
    return bs, xs


def run_round(mesh, spec: RowShardSpec, plan_args, halo_r, r, bs, xs, single) -> int:
    """Round ``r``: every shard's range launch, then (before every round
    but the last) the halo exchange of every data row. Returns the number
    of positions that launched."""
    used = positions(mesh, single)
    busy = launch_round(mesh, plan_args, r, bs, xs, used)
    if halo_r is not None:
        exchange = _exchange_ring if spec.mode == "ring" else _exchange_psum
        for d in sorted({d for d, _ in used}):
            exchange(mesh, d, xs[d], halo_r)
    return busy


def collect_owned(mesh, spec: RowShardSpec, xs, single, home) -> torch.Tensor:
    """The stacked owned regions on ``home``: f[n_shards, n_loc] or
    f[n_shards, n_loc, batch] (``RowShardPlan.x_gather`` recovers global
    order)."""
    K = mesh.shape["model"]
    if single:
        return torch.stack([xs[0][j][: spec.n_loc].to(home) for j in range(K)])
    return torch.stack([
        torch.cat([xs[d][j][:, : spec.n_loc].to(home) for d in range(mesh.shape["data"])]).T
        for j in range(K)
    ])


def build_rowsharded_solver(spec: RowShardSpec, mesh):
    """Returns ``solve(plan_args, halo_args, b_loc) -> x_owned``.
    ``b_loc`` is the right-hand side pre-scattered into local slots
    (``RowShardPlan.b_scatter``) on the caller's device: f[n_shards, slots]
    or f[n_shards, slots, batch]. Returns the stacked owned regions
    f[n_shards, n_loc(, batch)] on that device, as the JAX package's
    solver does."""

    def solve(plan_args, halo_args, b_loc):
        single = b_loc.dim() == 2
        bs, xs = place_local_rhs(mesh, b_loc)
        used = positions(mesh, single)
        mesh.fork(used)
        for r in range(spec.n_rounds):
            halo = halo_args[r] if r < spec.n_rounds - 1 else None
            run_round(mesh, spec, plan_args, halo, r, bs, xs, single)
        mesh.join(used)
        return collect_owned(mesh, spec, xs, single, b_loc.device)

    return solve


def build_rowsharded_round(spec: RowShardSpec, mesh, r: int):
    """One exchange round as its own call, for the timed path:
    ``round(plan_args, halo_r, bs, xs) -> positions that launched``, on
    the resident per-position ``bs`` / ``xs`` of ``place_local_rhs``
    (updated in place), waiting on the caller's stream before and making
    it wait after. ``halo_r`` is ``halo_args_for_round(..., r)``, or None
    for the last round."""

    def round_fn(plan_args, halo_r, bs, xs):
        single = bs[0][0].dim() == 1
        used = positions(mesh, single)
        mesh.fork(used)
        busy = run_round(mesh, spec, plan_args, halo_r, r, bs, xs, single)
        mesh.join(used)
        return busy

    return round_fn
