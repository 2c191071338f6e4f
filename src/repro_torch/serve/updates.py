"""Live refactorization — version-tagged plans per sparsity pattern.

The serving regime refreshes factor values *while requests are in
flight* (every Newton step of an outer solver, say). Correctness rule:
a request is pinned at admission to the plan version current at that
moment, and is always executed against exactly that version's values —
an update between admission and execution must neither corrupt nor drop
it. ``VersionedPlans`` enforces this with:

  * immutable versions — an update never mutates a live solver; it
    clones the current one with the new values
    (``TriangularSolver.clone_with_values``, structure shared, value
    tensors owned), so in-flight batches read stable tensors;
  * per-version pin counts — ``admit()`` pins a request to the current
    version, ``complete()`` unpins; a superseded version is retired (its
    solver reference dropped) only once its pin count reaches zero.

The schedule/index structure is shared across all versions (it depends
only on the pattern), so a version swap costs O(nnz) — exactly the
paper's §7.7 amortization argument carried into the serving loop.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np


class VersionedPlans:
    """All live plan versions of one registered pattern."""

    def __init__(self, solver, *, lower: bool = True):
        self.fingerprint = solver.fingerprint
        self.lower = lower
        self.n = solver.n
        # structural solve-graph identity + grouping capability — shared
        # by every version (updates clone values, never the structure),
        # so they are computed once here. The serve batcher routes on
        # width_class when cross-pattern batching is enabled.
        self.width_class = getattr(solver, "width_class", None)
        self.groupable = bool(getattr(solver, "supports_grouping", False))
        # a Condition, not a bare Lock: retirements notify waiters so
        # tests (and operators) can wait for a superseded version to
        # drain without sleep-polling (wait_retired)
        self._lock = threading.Condition()
        self._versions: Dict[int, object] = {0: solver}
        self._pins: Dict[int, int] = {0: 0}
        self.current = 0

    # ------------------------------------------------------------ admission
    def admit(self) -> Tuple[int, object]:
        """Pin one request to the current version; returns
        ``(version, solver)``. The solver reference stays valid until the
        matching ``complete`` even if updates supersede it meanwhile."""
        with self._lock:
            v = self.current
            self._pins[v] += 1
            return v, self._versions[v]

    def solver_for(self, version: int):
        with self._lock:
            return self._versions[version]

    def current_solver(self):
        """The current version's solver, read atomically — reading
        ``vp.current`` and then calling ``solver_for`` without the lock
        can race a concurrent ``update`` retiring the version between
        the two reads (telemetry's KeyError hazard)."""
        with self._lock:
            return self._versions[self.current]

    def current_entry(self):
        """``(version, solver)`` read under ONE lock acquisition.
        Callers that need the pair (e.g. keying a bank lane by version)
        must not read ``current`` and ``current_solver()`` separately —
        an ``update`` between the two reads would pair the old version
        number with the new solver's values."""
        with self._lock:
            return self.current, self._versions[self.current]

    def complete(self, version: int, count: int = 1) -> None:
        """Unpin ``count`` requests from ``version``; retire superseded
        versions that have fully drained."""
        with self._lock:
            self._pins[version] -= count
            self._retire_locked()

    def _retire_locked(self) -> None:
        dead = [
            v
            for v, pins in self._pins.items()
            if v != self.current and pins <= 0
        ]
        for v in dead:
            del self._versions[v]
            del self._pins[v]
        if dead:
            self._lock.notify_all()

    def wait_retired(self, version: int, timeout: float = None) -> bool:
        """Block until ``version`` has retired (drained and superseded);
        True on retirement, False on timeout. The event-based
        alternative to sleep-polling ``live_versions`` in tests and
        drain-aware operators."""
        with self._lock:
            return self._lock.wait_for(
                lambda: version not in self._versions, timeout
            )

    # -------------------------------------------------------------- updates
    def update(self, a_or_data) -> int:
        """Install new factor values as a fresh version and make it
        current. Queued requests keep their admitted version; only
        requests admitted *after* this call see the new values."""
        with self._lock:
            base = self._versions[self.current]
            new = base.clone_with_values(a_or_data)
            v = self.current + 1
            self._versions[v] = new
            self._pins[v] = 0
            self.current = v
            self._retire_locked()
            return v

    def values_match(self, data: np.ndarray) -> bool:
        """True when ``data`` equals the *current* version's values —
        submit() uses this to decide whether a matrix resubmission is an
        implicit numeric update."""
        with self._lock:
            cur = self._versions[self.current].source_values
        return cur is not None and np.array_equal(cur, data)

    # ------------------------------------------------------------ introspection
    def live_versions(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._versions))

    def pins(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._pins)
