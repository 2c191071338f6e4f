"""Pattern-routed microbatching — the heart of the solve service.

Requests are keyed by *route* — ``(pattern fingerprint, plan version)`` —
because only requests that share both the sparsity pattern and the factor
values can legally ride one multi-RHS ``solve(B[n, m])``. A route's group
is dispatched when it reaches ``max_batch`` or when its oldest request has
waited ``max_wait_us`` (the classic throughput/latency knob pair of
serving systems), whichever comes first. ``close()`` flushes every
remaining group immediately, so shutdown never strands a request.

Bitwise contract: at a fixed batch width and column position, the
multi-RHS solve never lets neighbor columns change a column's bits (each
output column's operations read only its own column — a block per column
in the kernels, elementwise operations in the plain executor), so
coalescing never changes a request's bits relative to a direct solve of a
batch with the same shape and placement. The contract fixes the (width,
position) as the JAX package's does; ``pad_width`` quantizes every
dispatch to a power-of-two width — pinning down the (width, position) a
request was served at (recorded on its ticket) and keeping each plan at
log2(max_batch) distinct dispatch widths.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Hashable, List, Optional, Tuple


def normalize_max_batch(max_batch: int) -> int:
    """The effective batch cap: ``max_batch`` rounded DOWN to a power of
    two (24 -> 16). The serving contract promises at most
    ``log2(max_batch)`` dispatch widths per plan — a non-pow2 cap would
    dispatch a non-pow2 width the moment a group fills, breaking that
    bound, so the cap is quantized once at construction
    (``SolveService`` / ``MicroBatcher``) and everything downstream sees
    only the normalized value."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    return 1 << (int(max_batch).bit_length() - 1)


def pad_width(m: int, max_batch: int) -> int:
    """Batch width actually dispatched for ``m`` queued requests: the next
    power of two >= max(m, 2), capped at ``normalize_max_batch(max_batch)``
    — every dispatched width is a power of two, keeping the
    log2(max_batch) width bound exact. ``max_batch=1`` (the
    no-batching baseline) is the one width-1 escape hatch."""
    cap = normalize_max_batch(max_batch)
    if cap <= 1:
        return 1
    w = 2
    while w < m:
        w *= 2
    return min(w, cap)


class MicroBatcher:
    """Thread-safe grouping queue: ``put(route, item)`` from any number of
    producers, ``next_batch()`` from worker threads. FIFO within a route.
    Across routes the dispatch order is: any FULL group first (the first
    one found, in route-insertion order — not the fullest), otherwise the
    group whose oldest item's ``max_wait_us`` deadline expires first.
    ``max_batch`` is normalized to a power of two at construction
    (``normalize_max_batch``), so dispatched group sizes always respect
    the pow2 width quantization."""

    def __init__(self, *, max_batch: int = 32, max_wait_us: int = 2000):
        self.max_batch = normalize_max_batch(max_batch)
        self.max_wait = max_wait_us / 1e6
        self._cond = threading.Condition()
        self._groups: "OrderedDict[Hashable, List]" = OrderedDict()
        self._arrival: dict = {}  # route -> perf_counter of oldest item
        self._closed = False

    def depth(self) -> int:
        with self._cond:
            return sum(len(g) for g in self._groups.values())

    def put(self, route: Hashable, item) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            group = self._groups.get(route)
            if group is None:
                group = self._groups[route] = []
                self._arrival[route] = time.perf_counter()
            group.append(item)
            self._cond.notify()

    def _pop(self, route) -> Tuple[Hashable, List]:
        """Take up to ``max_batch`` items; a longer group keeps its place
        (and its arrival time, so the remainder dispatches next)."""
        group = self._groups[route]
        if len(group) <= self.max_batch:
            del self._groups[route]
            del self._arrival[route]
            return route, group
        self._groups[route] = group[self.max_batch:]
        return route, group[: self.max_batch]

    def next_batch(self) -> Optional[Tuple[Hashable, List]]:
        """Block until a group is dispatchable; None once closed AND
        drained (the worker-loop exit signal)."""
        with self._cond:
            while True:
                if self._groups:
                    # any full group dispatches immediately
                    for route, group in self._groups.items():
                        if len(group) >= self.max_batch:
                            return self._pop(route)
                    if self._closed:  # flush: deadlines no longer apply
                        return self._pop(next(iter(self._groups)))
                    oldest = min(self._arrival, key=self._arrival.get)
                    deadline = self._arrival[oldest] + self.max_wait
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return self._pop(oldest)
                    self._cond.wait(remaining)
                else:
                    if self._closed:
                        return None
                    self._cond.wait()

    def close(self) -> None:
        """Stop admissions and wake every worker; queued groups still
        drain (flushed immediately) before ``next_batch`` returns None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class AdmissionQueue:
    """Slot-allocation admission for the continuous engine
    (``repro_torch.serve.slots``).

    The microbatcher above implements *group formation*: it deliberately
    holds a route's backlog for up to ``max_wait_us`` hoping more
    requests arrive to share the dispatch — a batch-formation deadline
    that is itself a small synchronization barrier. Continuous mode has
    no such barrier: requests go into persistent device lanes, so there
    is nothing to form. This queue is therefore a plain FIFO — ``take``
    blocks only while the queue is EMPTY, and hands the dispatch loop
    everything queued the moment it comes back for work. The only wait
    a request ever experiences here is for the loop, never for company.

    The dispatcher routes taken items into per-engine pending deques
    before dispatching them; ``mark_pending`` lets it report that
    in-hand count so ``depth`` (the service's back-pressure signal)
    keeps covering requests that are accepted but not yet in a lane.
    """

    UNBOUNDED = 1 << 30  # take(k) cap meaning "everything queued"

    def __init__(self):
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._pending = 0  # items the consumer took but hasn't dispatched
        self._closed = False

    def depth(self) -> int:
        with self._cond:
            return len(self._items) + self._pending

    def mark_pending(self, n: int) -> None:
        """Report the consumer's in-hand (taken, undispatched) count."""
        with self._cond:
            self._pending = n

    def put(self, item) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("admission queue is closed")
            self._items.append(item)
            self._cond.notify()

    def take(self, k: int) -> List:
        """Up to ``k`` queued items, FIFO. Blocks while empty; an empty
        list means closed AND drained — the dispatch-loop exit signal
        (mirrors ``MicroBatcher.next_batch`` returning None)."""
        with self._cond:
            while not self._items:
                if self._closed:
                    return []
                self._cond.wait()
            take = min(k, len(self._items))
            return [self._items.popleft() for _ in range(take)]

    def drain(self) -> List:
        """Everything queued right now, without blocking — the
        dispatcher's top-up path while it still has pending work in
        hand (blocking would stall those)."""
        with self._cond:
            items = list(self._items)
            self._items.clear()
            return items

    def close(self) -> None:
        """Stop admissions and wake the dispatch loop; queued requests
        still drain before ``take`` returns empty."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
