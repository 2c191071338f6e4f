"""Continuous batching — persistent device-resident RHS slots, no drain
barrier between dispatches.

The paper's thesis is that SpTRSV speed comes from removing
synchronization barriers (12.07x fewer than HDagg, §7). The microbatch
serving loop still contains one: every dispatch *forms* a batch (waits
up to ``max_wait_us`` for company), solves it, and fully *drains* it
before the next batch forms — a barrier per microbatch, paid by every
request's tail latency. This module removes it, JetStream-style:

  * one ``SlotEngine`` per width class owns ``n_slots`` persistent
    device lanes: a resident rhs bank ``B[n, S]`` plus the width class's
    stacked plan bank (``repro_torch.pipeline.GroupBank`` — restacked
    only on membership change, never per dispatch);
  * admission is *slot allocation* (``SlotState.admit``): a free lane is
    assigned and the request's rhs is written into the resident bank's
    column on the device (``BoundSolve.insert_lane``) — no host-side
    batch stacking, no bank rebuild, no formation deadline;
  * ONE always-running dispatch loop (``SlotDispatcher``) drives every
    engine: it drains the shared admission queue, round-robins one
    solve pass per engine with pending work
    (``BoundSolve.solve_resident``; lanes allocate lowest-first, so
    each pass dispatches the smallest pow2 lane prefix covering the
    occupants — a lightly-loaded bank never pays the full-S solve);
    completion extracts the lane's column (``extract_lane``), fulfills
    the ticket, and frees the lane — newly queued requests take freed
    lanes on the very next pass, while the pass they missed is still
    what bounds their wait. There is no drain barrier: the loop never
    waits for a bank to empty or fill.

One dispatch thread, not one per engine, on purpose: passes serialize
on the device anyway, so per-class threads buy no overlap — they only
oversubscribe the host (a request mix spanning k width classes would
spawn k loops whose GIL/scheduler preemption shows up directly in the
open-loop tail, badly on small machines) — and a single mutator thread
is what makes every ``SlotState``, resident bank and bank-membership
mutation in the whole service lock-free by construction.

Slot lifecycle::

    submit -> AdmissionQueue -> admit (free lane) -> insert_lane
           -> solve_resident pass -> extract_lane -> fulfill -> release

Bitwise contract — unchanged from the microbatch path and now holding
with neighbors churning in adjacent lanes: the banked solve's lanes are
data-independent (a block per column in the kernel, elementwise
operations in the plain executor), so a lane's bits depend only on its
own (plan, rhs) at the dispatched (width, position) = (pass width, lane).
Free lanes keep whatever stale column the previous occupant left (and a
filler plan key); by lane independence those bits never reach an
occupied lane, so the engine never wastes a write zeroing them. Each
completed ticket records ``batch_width`` (its pass width),
``batch_position = lane`` and ``served_by = GroupReplay(solver)`` —
exactly the replay reference ``direct_reference`` already verifies
grouped results against.

A pass reads its results back to the host in one copy, which waits for
the kernel: ``solve`` returns before the kernel has run, so a request's
latency and the pass's ``solve_seconds`` include the solve on the device.

``SlotState`` is the pure lane-allocation state machine, kept free of
any device or threading concern so property tests can drive it through
random admit/complete/evict sequences and audit its invariants directly.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.pipeline import GroupBank
from repro_torch.serve.batcher import AdmissionQueue, pad_width
from repro_torch.serve.metrics import ServeMetrics


class SlotsFull(RuntimeError):
    """Raised by ``SlotState.admit`` when every lane is occupied."""


class SlotState:
    """Pure lane-allocation state machine for ``n_slots`` device lanes.

    No device state, no locks, no clock — a deterministic object the
    property tests can drive in isolation. Invariants (audited by
    :meth:`check`):

      * a lane is either free or holds exactly one token — ``admit``
        never double-occupies, ``release``/``evict`` of a free lane
        raises;
      * a token occupies at most one lane — re-admitting a live token
        raises;
      * ``free + occupied`` is always a partition of ``range(n_slots)``.

    ``release`` (completion) and ``evict`` (failure/shutdown) are the
    same transition with different books — every admitted token leaves
    through exactly one of them, which is how the engine guarantees
    every ticket terminates exactly once.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        # stack, reversed so lane 0 is allocated first — deterministic
        # lane assignment keeps replay tests and telemetry readable
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._occupant: Dict[int, Hashable] = {}  # lane -> token
        self._lane_of: Dict[Hashable, int] = {}  # token -> lane
        self.admitted = 0
        self.completed = 0
        self.evicted = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return len(self._occupant)

    def occupants(self) -> Dict[int, Hashable]:
        """lane -> token snapshot (copy; mutating it changes nothing)."""
        return dict(self._occupant)

    def lane_of(self, token) -> Optional[int]:
        return self._lane_of.get(token)

    def admit(self, token) -> int:
        """Allocate a free lane to ``token``; returns the lane."""
        if token in self._lane_of:
            raise ValueError(
                f"token {token!r} already occupies lane "
                f"{self._lane_of[token]}"
            )
        if not self._free:
            raise SlotsFull(f"all {self.n_slots} lanes occupied")
        lane = self._free.pop()
        self._occupant[lane] = token
        self._lane_of[token] = lane
        self.admitted += 1
        return lane

    def _vacate(self, lane: int):
        if lane not in self._occupant:
            raise ValueError(
                f"lane {lane} is already free (or out of range)"
            )
        token = self._occupant.pop(lane)
        del self._lane_of[token]
        self._free.append(lane)
        return token

    def release(self, lane: int):
        """Completion: free ``lane``, returning its token."""
        token = self._vacate(lane)
        self.completed += 1
        return token

    def evict(self, lane: int):
        """Failure/shutdown path: free ``lane`` without counting a
        completion, returning its token."""
        token = self._vacate(lane)
        self.evicted += 1
        return token

    def check(self) -> None:
        """Audit every invariant; raises AssertionError on violation.
        Cheap enough for the property tests to call after every step."""
        assert len(self._free) + len(self._occupant) == self.n_slots
        assert set(self._free).isdisjoint(self._occupant.keys())
        assert set(self._free) | set(self._occupant) == set(
            range(self.n_slots)
        )
        assert sorted(self._lane_of.values()) == sorted(self._occupant)
        for lane, token in self._occupant.items():
            assert self._lane_of[token] == lane
        assert self.admitted == (
            self.completed + self.evicted + len(self._occupant)
        )


class SlotRequest:
    """One queued continuous-mode request: the ticket, its pinned
    ``(fingerprint, version)`` bank key, that version's solver, and the
    rhs."""

    __slots__ = ("ticket", "key", "solver", "b")

    def __init__(self, ticket, key, solver, b):
        self.ticket = ticket
        self.key = key
        self.solver = solver
        self.b = b


class SlotEngine:
    """One width class's continuous-batching context: persistent device
    lanes, the class's stacked plan bank, and the pass executor — driven
    by a :class:`SlotDispatcher`, never by its own thread (see module
    docstring for why the dispatch loop is shared).

    ``is_live(key) -> bool`` and ``on_complete(key, count)`` decouple
    the engine from the service's version registry: completions unpin
    the served versions through ``on_complete`` (mirroring the worker
    loops' ``VersionedPlans.complete``), and bank lanes of retired
    versions are pruned with ``is_live``. Everything that touches
    ``SlotState``, the resident bank, or the plan bank's membership runs
    on the dispatcher thread — producers only ever append to the shared
    admission queue — so the engine needs no slot-level locking.
    """

    def __init__(
        self,
        *,
        n_slots: int,
        metrics: Optional[ServeMetrics] = None,
        is_live: Optional[Callable[[Hashable], bool]] = None,
        on_complete: Optional[Callable[[Hashable, int], None]] = None,
        name: str = "slots",
    ):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        # pow2 lane count: together with the plan bank's pow2 lane
        # padding this keeps the distinct pass widths logarithmic
        self.n_slots = 1 << (int(n_slots) - 1).bit_length()
        self.name = name
        self.state = SlotState(self.n_slots)
        self.bank = GroupBank()
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._is_live = is_live if is_live is not None else (lambda k: True)
        self._on_complete = (
            on_complete if on_complete is not None else (lambda k, c: None)
        )
        self.passes = 0  # dispatch passes actually executed
        self.occupancy_hist: Counter = Counter()  # occupancy -> passes
        # device residency, fixed by the first admitted solver
        self._cls = None  # the width class's BoundSolve subclass
        self._B = None  # resident rhs bank f[n, n_slots]

    def _ensure_device(self, solver) -> None:
        if self._cls is None:
            self._cls = type(solver._bound)
            self._B = self._cls.blank_rhs(
                solver.n, self.n_slots, solver.dtype, solver.device
            )

    def _run_pass(self, reqs: List[SlotRequest]) -> None:
        # lazy import: service.py imports this module at load time
        from repro_torch.serve.service import GroupReplay

        admitted = []
        for r in reqs:
            try:
                self._ensure_device(r.solver)
                self.bank.add(r.key, r.solver)
                lane = self.state.admit(r.ticket)
            except Exception as e:
                r.ticket._fulfill(None, e)
                self.metrics.record_failure(r.ticket.fingerprint, 1)
                self._on_complete(r.key, 1)
                continue
            admitted.append((lane, r))
        if not admitted:
            return
        t0 = time.perf_counter()
        cls, B = self._cls, self._B
        for lane, r in admitted:
            B = cls.insert_lane(B, lane, r.b)
            r.ticket.t_admit = time.perf_counter()
        self._B = B
        occupied = {lane: r for lane, r in admitted}
        # dispatch the smallest pow2 lane prefix covering the occupants
        # (lanes allocate lowest-first, so the prefix is tight): a
        # lightly-loaded bank solves at width 2, not n_slots
        width = pad_width(max(occupied) + 1, self.n_slots)
        # free lanes inside the prefix solve their stale columns against
        # a filler plan — discarded results; lane independence keeps
        # them from ever touching an occupied lane's bits
        filler = admitted[0][1].key
        keys = [
            occupied[lane].key if lane in occupied else filler
            for lane in range(width)
        ]
        try:
            with obs.span(
                "serve.slot_pass",
                cat="serve",
                width=width,
                occupied=len(occupied),
            ):
                # one read of the pass to the host, which waits for it
                X = self.bank.solve_resident(keys, B).cpu()
            xs = {lane: cls.extract_lane(X, lane).numpy() for lane in occupied}
        except Exception as e:  # scatter the failure, keep serving
            for lane, r in occupied.items():
                self.state.evict(lane)
                r.ticket._fulfill(None, e)
            for fp, cnt in Counter(
                r.ticket.fingerprint for r in occupied.values()
            ).items():
                self.metrics.record_failure(fp, cnt)
            for key, cnt in Counter(
                r.key for r in occupied.values()
            ).items():
                self._on_complete(key, cnt)
            return
        t1 = time.perf_counter()
        for lane, r in occupied.items():
            t = r.ticket
            t.batch_width = width
            t.batch_position = lane
            t.served_by = GroupReplay(r.solver)
            t._fulfill(np.ascontiguousarray(xs[lane]))
            self.state.release(lane)
        self.passes += 1
        self.occupancy_hist[len(occupied)] += 1
        tickets = [r.ticket for r in occupied.values()]
        self.metrics.record_slot_pass(
            [t.fingerprint for t in tickets],
            queue_waits=[t.t_admit - t.t_submit for t in tickets],
            slot_times=[t.t_done - t.t_admit for t in tickets],
            e2e=[t.t_done - t.t_submit for t in tickets],
            solve_seconds=t1 - t0,
            occupancy=len(occupied),
            n_slots=self.n_slots,
        )
        for key, cnt in Counter(r.key for r in occupied.values()).items():
            self._on_complete(key, cnt)
        # retire bank lanes of drained, superseded versions — queried
        # per key at prune time (under the bank lock): any key with a
        # queued or in-lane request is pinned, hence still live
        self.bank.prune(self._is_live)

    # ------------------------------------------------------------- warm-up
    def warm(self, key, solver) -> None:
        """Run every dispatch this engine can make for ``key``'s width
        class once: an insert/extract pair and the resident pass at each
        pow2 prefix width (the first launch builds and loads the kernel's
        library; the bank is stacked). Call BEFORE offering traffic (the
        service's ``prewarm`` does) — warming shares the resident device
        state with the dispatch thread and is only safe while that thread
        is idle."""
        self._ensure_device(solver)
        self.bank.add(key, solver)
        cls, B = self._cls, self._B
        b = np.zeros(solver.n)
        cls.extract_lane(cls.insert_lane(B, 0, b), 0).cpu()
        w = 1
        while w <= self.n_slots:
            width = pad_width(w, self.n_slots)
            cls.extract_lane(self.bank.solve_resident([key] * width, B), 0).cpu()
            if width >= self.n_slots:
                break
            w = width * 2

    # ----------------------------------------------------------- telemetry
    def describe(self) -> dict:
        return {
            "n_slots": self.n_slots,
            "passes": self.passes,
            "occupancy": self.state.occupancy,
            "occupancy_hist": dict(sorted(self.occupancy_hist.items())),
            "admitted": self.state.admitted,
            "completed": self.state.completed,
            "evicted": self.state.evicted,
            "bank": self.bank.describe(),
        }


class SlotDispatcher:
    """The single always-running dispatch loop behind every
    :class:`SlotEngine` of a service (see module docstring for why the
    loop is shared rather than per-engine).

    Producers ``submit(engine, ticket, key, solver, b)`` into one shared
    :class:`~repro_torch.serve.batcher.AdmissionQueue`; the loop drains it,
    routes each request to its engine's pending deque, and round-robins
    ONE solve pass per engine with work — so a burst on one width class
    cannot starve the others for more than a pass, and every piece of
    slot/bank/resident state in the service is mutated by exactly this
    thread. When a class's pending backlog exceeds its free lanes the
    remainder simply stays pending and the next round picks it up —
    overflow costs extra passes, never an error.

    ``close`` stops admissions, lets the loop drain BOTH the shared
    queue and every pending deque (shutdown never strands a ticket),
    and joins the thread.
    """

    def __init__(self, name: str = "slots"):
        self._queue = AdmissionQueue()
        self._thread = threading.Thread(
            target=self._loop, name=f"slot-dispatch-{name}", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------- admission
    def depth(self) -> int:
        """Requests accepted but not yet in a lane — the continuous
        path's share of the service's ``max_queue`` back-pressure bound
        (in-lane requests are counted by the engines' occupancy)."""
        return self._queue.depth()

    def submit(self, engine: SlotEngine, ticket, key, solver, b) -> None:
        """Queue one request for slot allocation on ``engine``. Raises
        RuntimeError once the dispatcher is closed (the service maps
        that to its own closed-state error)."""
        self._queue.put((engine, SlotRequest(ticket, key, solver, b)))

    # ------------------------------------------------------ dispatch loop
    def _loop(self) -> None:
        pending: Dict[SlotEngine, deque] = {}
        while True:
            if any(pending.values()):
                # work in hand: top up without blocking so a queued
                # burst lands in this round's passes
                items = self._queue.drain()
            else:
                items = self._queue.take(self._queue.UNBOUNDED)
                if not items:
                    return  # closed, shared queue and deques drained
            for engine, req in items:
                pending.setdefault(engine, deque()).append(req)
            self._queue.mark_pending(
                sum(len(q) for q in pending.values())
            )
            for engine, q in pending.items():
                if not q:
                    continue
                take = min(engine.state.free_count, len(q))
                if take:
                    engine._run_pass([q.popleft() for _ in range(take)])
            self._queue.mark_pending(
                sum(len(q) for q in pending.values())
            )

    # ----------------------------------------------------------- lifecycle
    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop admissions, drain everything queued or pending (every
        accepted request is still served), join the loop thread.
        Returns True once the thread has exited."""
        self._queue.close()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def alive(self) -> bool:
        return self._thread.is_alive()
