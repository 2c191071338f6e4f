"""Serving telemetry — per-pattern and global, lock-guarded, snapshot-able.

What a serving operator actually wants to see, per sparsity pattern and
in aggregate:

  * queue depth (how far behind the workers are),
  * the batch-size histogram (is microbatching actually coalescing?),
  * p50/p95/p99/p99.9 end-to-end latency plus the queue-wait share of
    it (p99.9 because the continuous engine exists for the tail of the
    tail — the open-loop regime where a batch-formation deadline shows
    up two nines out),
  * continuous mode: slot-pass count, the occupancy histogram (are the
    lanes actually full?) and time-in-queue vs time-in-slot — the split
    that says whether latency is spent waiting for a lane or solving,
  * throughput (completed solves per second),
  * plan-cache hit rate and live plan versions.

Latencies go through a bounded reservoir (the most recent ``cap``
samples) so a long-running service computes percentiles over recent
traffic in O(cap) instead of growing without bound. ``snapshot()``
returns a plain dict (JSON-ready, consumed by ``serve.loadgen`` reports)
and ``pretty()`` renders it for humans.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, Optional

import numpy as np

PERCENTILES = (50, 95, 99, 99.9)


class LatencyReservoir:
    """Bounded sample window; percentiles over the most recent ``cap``.

    Internally thread-safe: ``add`` and ``percentiles_us`` may race from
    different threads. Without the lock, iterating the deque
    (``np.fromiter``) while a concurrent ``add`` rotates it past
    ``maxlen`` raises ``RuntimeError: deque mutated during iteration`` —
    a real crash under serving load, regression-tested by
    ``tests/test_torch_serve.py::test_latency_reservoir_threaded``. The lock is
    a leaf (nothing is called while holding it), so reservoir methods
    are safe to call under the ``ServeMetrics`` lock."""

    def __init__(self, cap: int = 4096):
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=cap)
        self.count = 0  # lifetime, not window

    def add(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1

    def extend(self, seconds_iter) -> None:
        # one lock round-trip for the whole batch, not one per sample
        seconds = list(seconds_iter)
        with self._lock:
            self._samples.extend(seconds)
            self.count += len(seconds)

    def samples(self) -> list:
        """A consistent copy of the current window (the accessor
        ``ServeMetrics.snapshot`` pools global percentiles from —
        never iterate ``_samples`` directly)."""
        with self._lock:
            return list(self._samples)

    def percentiles_us(self) -> Dict[str, float]:
        """{"p50": ..., ..., "p99.9": ...} in microseconds (NaN-free:
        empty reservoirs report 0.0 so JSON stays parseable)."""
        return _percentiles_us(np.asarray(self.samples(), dtype=np.float64))


def _percentiles_us(arr: np.ndarray) -> Dict[str, float]:
    if arr.size == 0:
        return {f"p{q}": 0.0 for q in PERCENTILES}
    vals = np.percentile(arr, PERCENTILES)
    return {
        f"p{q}": round(float(v) * 1e6, 1)
        for q, v in zip(PERCENTILES, vals)
    }


class _PatternStats:
    __slots__ = (
        "submitted", "completed", "failed", "rejected", "batches",
        "batch_hist", "queue_wait", "e2e", "updates",
    )

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0  # bounced at admission (max_queue back-pressure)
        self.batches = 0
        self.updates = 0  # numeric_update version swaps
        self.batch_hist: Counter = Counter()  # actual batch size -> count
        self.queue_wait = LatencyReservoir()
        self.e2e = LatencyReservoir()


class ServeMetrics:
    """Thread-safe telemetry sink shared by the service and its workers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Zero all counters and reservoirs — benchmarks call this after
        their warm-up phase so compile-time latencies don't pollute the
        measured percentiles."""
        with self._lock:
            self._patterns: Dict[str, _PatternStats] = {}
            self._solve = LatencyReservoir()  # per-batch device solve time
            self._grouped_batches = 0  # cross-pattern width-class batches
            self._grouped_hist: Counter = Counter()
            # continuous mode: dispatch passes over the resident slots
            self._slot_passes = 0
            self._slot_occ_hist: Counter = Counter()  # occupancy -> passes
            self._slot_width = 0  # lane count S of the last-seen engine
            self._slot_time = LatencyReservoir()  # per-request time in slot
            self._t_first: Optional[float] = None
            self._t_last: Optional[float] = None

    # ------------------------------------------------------------- record
    def _pat(self, fp: str) -> _PatternStats:
        p = self._patterns.get(fp)
        if p is None:
            p = self._patterns[fp] = _PatternStats()
        return p

    def record_submit(self, fp: str) -> None:
        with self._lock:
            if self._t_first is None:
                self._t_first = time.perf_counter()
            self._pat(fp).submitted += 1

    def record_update(self, fp: str) -> None:
        with self._lock:
            self._pat(fp).updates += 1

    def record_rejected(self, fp: str) -> None:
        with self._lock:
            self._pat(fp).rejected += 1

    def record_batch(
        self,
        fp: str,
        size: int,
        *,
        queue_waits,
        e2e,
        solve_seconds: float,
    ) -> None:
        with self._lock:
            p = self._pat(fp)
            p.completed += size
            p.batches += 1
            p.batch_hist[size] += 1
            p.queue_wait.extend(queue_waits)
            p.e2e.extend(e2e)
            self._solve.add(solve_seconds)
            self._mark_completion_locked()

    def record_grouped_batch(
        self,
        fps,
        *,
        queue_waits,
        e2e,
        solve_seconds: float,
    ) -> None:
        """One width-class grouped batch: request j came from pattern
        ``fps[j]`` (``queue_waits``/``e2e`` aligned). Completions and
        latencies are attributed per pattern; the batch itself is counted
        once, globally, as a grouped batch — attributing it to any single
        pattern would misstate that pattern's batching."""
        with self._lock:
            for fp, qw, el in zip(fps, queue_waits, e2e):
                p = self._pat(fp)
                p.completed += 1
                p.queue_wait.add(qw)
                p.e2e.add(el)
            self._grouped_batches += 1
            self._grouped_hist[len(fps)] += 1
            self._solve.add(solve_seconds)
            self._mark_completion_locked()

    def record_slot_pass(
        self,
        fps,
        *,
        queue_waits,
        slot_times,
        e2e,
        solve_seconds: float,
        occupancy: int,
        n_slots: int,
    ) -> None:
        """One continuous-mode dispatch pass over the resident slots:
        request j (pattern ``fps[j]``) rode one of the pass's
        ``occupancy`` occupied lanes (of ``n_slots``). ``queue_waits``
        is time-in-queue (submit -> lane insertion) and ``slot_times``
        time-in-slot (insertion -> completion) — the two halves of
        ``e2e``, split so an operator can see whether the tail comes
        from waiting for a lane or from the solve itself. Completions
        and latencies are attributed per pattern; the pass is counted
        once, globally, like a grouped batch."""
        with self._lock:
            for fp, qw, el in zip(fps, queue_waits, e2e):
                p = self._pat(fp)
                p.completed += 1
                p.queue_wait.add(qw)
                p.e2e.add(el)
            self._slot_time.extend(slot_times)
            self._slot_passes += 1
            self._slot_occ_hist[occupancy] += 1
            self._slot_width = n_slots
            self._solve.add(solve_seconds)
            self._mark_completion_locked()

    def record_failure(self, fp: str, size: int) -> None:
        with self._lock:
            self._pat(fp).failed += size
            self._mark_completion_locked()

    def _mark_completion_locked(self) -> None:
        """Advance the throughput window. The window is anchored on the
        FIRST recorded event — submit or completion, whichever comes
        first: a batch draining after ``reset()`` (warm-up) used to set
        ``_t_last`` while ``_t_first`` stayed None, making every later
        snapshot report 0.0 solves/s despite completions."""
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now

    # ----------------------------------------------------------- snapshot
    def snapshot(self, *, queue_depth: int = 0, extra: dict = None) -> dict:
        """One JSON-ready dict: global aggregates + a per-pattern section.
        ``extra`` (e.g. plan-cache stats, live versions) is merged at the
        top level by the service."""
        with self._lock:
            per_pattern = {}
            tot_sub = tot_done = tot_fail = tot_rej = tot_batches = 0
            hist: Counter = Counter()
            # global percentiles pool every pattern's window uncapped —
            # funneling them through one capped reservoir would silently
            # drop the first-inserted (often hottest) patterns' samples
            all_e2e: list = []
            all_queue: list = []
            for fp, p in self._patterns.items():
                tot_sub += p.submitted
                tot_done += p.completed
                tot_fail += p.failed
                tot_rej += p.rejected
                tot_batches += p.batches
                hist.update(p.batch_hist)
                all_e2e.extend(p.e2e.samples())
                all_queue.extend(p.queue_wait.samples())
                per_pattern[fp] = {
                    "submitted": p.submitted,
                    "completed": p.completed,
                    "failed": p.failed,
                    "rejected": p.rejected,
                    "batches": p.batches,
                    "numeric_updates": p.updates,
                    "batch_size_hist": dict(sorted(p.batch_hist.items())),
                    "latency_us": p.e2e.percentiles_us(),
                    "queue_wait_us": p.queue_wait.percentiles_us(),
                }
            elapsed = (
                (self._t_last or 0.0) - (self._t_first or 0.0)
                if self._t_first is not None
                else 0.0
            )
            # width-class grouped batches and slot passes are counted
            # once, globally (the per-pattern loop above only saw their
            # per-request shares)
            tot_batches += self._grouped_batches + self._slot_passes
            hist.update(self._grouped_hist)
            occ_total = sum(
                occ * cnt for occ, cnt in self._slot_occ_hist.items()
            )
            out = {
                "submitted": tot_sub,
                "completed": tot_done,
                "failed": tot_fail,
                "rejected": tot_rej,
                "queue_depth": queue_depth,
                "batches": tot_batches,
                "grouped_batches": self._grouped_batches,
                "grouped_batch_size_hist": dict(
                    sorted(self._grouped_hist.items())
                ),
                "mean_batch_size": round(tot_done / tot_batches, 2)
                if tot_batches
                else 0.0,
                "batch_size_hist": dict(sorted(hist.items())),
                "elapsed_seconds": round(max(elapsed, 0.0), 4),
                "solves_per_sec": round(tot_done / elapsed, 1)
                if elapsed > 0
                else 0.0,
                "latency_us": _percentiles_us(np.asarray(all_e2e)),
                "queue_wait_us": _percentiles_us(np.asarray(all_queue)),
                "batch_solve_us": self._solve.percentiles_us(),
                # continuous mode: dispatch passes over the resident
                # slots (zeros when the service runs pure microbatch)
                "slots": {
                    "passes": self._slot_passes,
                    "n_slots": self._slot_width,
                    "occupancy_hist": dict(
                        sorted(self._slot_occ_hist.items())
                    ),
                    "mean_occupancy": round(
                        occ_total / self._slot_passes, 2
                    )
                    if self._slot_passes
                    else 0.0,
                    "time_in_slot_us": self._slot_time.percentiles_us(),
                },
                "per_pattern": per_pattern,
            }
        if extra:
            out.update(extra)
        return out


def pretty(snap: dict) -> str:
    """Render a ``ServeMetrics.snapshot()`` dict for terminals."""
    lines = [
        "== serve metrics ==",
        f"requests: {snap['completed']}/{snap['submitted']} completed"
        f" ({snap['failed']} failed, {snap.get('rejected', 0)} rejected, "
        f"queue depth {snap['queue_depth']})",
        f"throughput: {snap['solves_per_sec']} solves/s over "
        f"{snap['elapsed_seconds']}s in {snap['batches']} batches "
        f"(mean batch {snap['mean_batch_size']}, "
        f"{snap.get('grouped_batches', 0)} cross-pattern)",
        f"latency us: {snap['latency_us']}  "
        f"queue wait us: {snap['queue_wait_us']}",
        f"batch size hist: {snap['batch_size_hist']}",
    ]
    slots = snap.get("slots") or {}
    if slots.get("passes"):
        lines.append(
            f"slots: {slots['passes']} passes over {slots['n_slots']} "
            f"lanes (mean occupancy {slots['mean_occupancy']}), "
            f"time in slot us: {slots['time_in_slot_us']}"
        )
    if "plan_cache" in snap:
        lines.append(f"plan cache: {snap['plan_cache']}")
    for fp, p in snap.get("per_pattern", {}).items():
        lines.append(
            f"  {fp[:12]}…: {p['completed']}/{p['submitted']} done, "
            f"{p['batches']} batches, {p['numeric_updates']} updates, "
            f"p50={p['latency_us']['p50']}us p99={p['latency_us']['p99']}us"
        )
    return "\n".join(lines)
