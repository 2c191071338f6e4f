"""Plan cache — pay the inspector once per sparsity pattern.

The paper's motivating workload (§1, Table 7.7) reuses one sparsity
pattern across hundreds of solves; iterative methods even reuse it across
*factorizations* (same pattern, new values every Newton step). The cache
keys on everything that determines the compiled plan and its binding:

    (pattern fingerprint, strategy, options, lower, backend, dtype, W,
     device, slack, mesh, shard)

On a hit the whole DAG-build -> schedule -> reorder -> compile chain is
skipped; only the numeric values are refreshed (``numeric_update`` via the
plan's value-source maps), which is O(nnz) instead of O(|E| log |V|).

The cache also memoizes ``strategy="auto"`` outcomes per fingerprint
(``get_selection`` / ``store_selection``): a repeated pattern resolves to
the previously selected concrete config with zero selection work, then
hits the plan entry stored under that concrete key.

The width-class index (``note_width_class``, ``width_class_members``,
``width_class_sizes``) records which cached plans share one structural
solve identity (``TriangularSolver.width_class``), so the serve layer can
batch across patterns; its entries leave with their plan.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Hashable, Optional

from repro_torch import obs


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    numeric_updates: int = 0
    evictions: int = 0
    # strategy="auto" bookkeeping: selections = feature-extraction +
    # shortlist-scoring runs actually performed; selection_hits = plans
    # that resolved to a concrete config without re-running selection
    selections: int = 0
    selection_hits: int = 0

    @property
    def entries_built(self) -> int:
        return self.misses

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """LRU cache from plan key -> bound ``TriangularSolver``. Thread-safe;
    shared freely across solves, requests and factor pairs."""

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = maxsize
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()
        # strategy="auto" selections live beside the plans. Selection
        # objects are tiny, so they outlive plan eviction (a pattern whose
        # plan was evicted still skips re-selection) — but not unboundedly:
        # FIFO-capped so a stream of distinct patterns cannot grow this
        # forever while the plan entries themselves are being evicted.
        self._selections: "OrderedDict[Hashable, object]" = OrderedDict()
        self._selections_max = max(4 * maxsize, 64) if maxsize else 4096
        # keys exempt from LRU eviction (live-serving plans — see pin())
        self._pinned: set = set()
        # width-class index: structural solve identity -> the plan keys
        # sharing it (``TriangularSolver.width_class``). Index entries leave
        # with their plan, so the index stays bounded by the live entries.
        self._width_classes: "OrderedDict[Hashable, set]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------- auto-strategy memo
    def get_selection(self, key: Hashable):
        """Memoized ``strategy="auto"`` outcome for ``key`` (see
        ``autotune.selector.selection_key``), or None. A hit means
        ``plan()`` resolves straight to a concrete plan key with zero
        selection work."""
        with self._lock:
            sel = self._selections.get(key)
            if sel is not None:
                self.stats.selection_hits += 1
            return sel

    def store_selection(self, key: Hashable, selection: object) -> None:
        with self._lock:
            if key not in self._selections:
                # racing first-plans may both compute a selection (same
                # deterministic outcome, mirroring get_or_build's racing
                # builders); count the distinct key once
                self.stats.selections += 1
            self._selections[key] = selection
            while len(self._selections) > self._selections_max:
                self._selections.popitem(last=False)

    def get_or_build(self, key: Hashable, builder: Callable[[], object]):
        """Return ``(entry, hit)``. ``builder`` runs outside the lock on a
        miss — concurrent misses on the same key keep the first-inserted
        entry (last writer returns the canonical one)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                obs.counter_add("cache.hit")
                return entry, True
        with obs.span("cache.build", cat="cache"):
            built = builder()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:  # lost the race; count as a hit
                self._entries.move_to_end(key)
                self.stats.hits += 1
                obs.counter_add("cache.hit")
                return entry, True
            self.stats.misses += 1
            self._entries[key] = built
            self._evict_locked()
        obs.counter_add("cache.miss")
        return built, False

    def _evict_locked(self) -> None:
        """Evict oldest *unpinned* entries down to maxsize. Pinned entries
        never leave (the cache may exceed maxsize while everything is
        pinned — bounded by the number of live pins)."""
        if self.maxsize is None:
            return
        over = len(self._entries) - self.maxsize
        if over <= 0:
            return
        for key in [k for k in self._entries if k not in self._pinned]:
            self._entries.pop(key)
            self._drop_width_class_locked(key)
            self.stats.evictions += 1
            obs.counter_add("cache.evict")
            over -= 1
            if over <= 0:
                break

    def _drop_width_class_locked(self, key: Hashable) -> None:
        """Remove ``key`` from the width-class index (and drop classes that
        emptied)."""
        for wc in [wc for wc, keys in self._width_classes.items() if key in keys]:
            keys = self._width_classes[wc]
            keys.discard(key)
            if not keys:
                del self._width_classes[wc]

    def pin(self, key: Hashable) -> None:
        """Exempt ``key`` from LRU eviction while it serves live traffic.
        Idempotent; pinning a key with no entry yet is allowed — it
        protects the entry whenever it appears."""
        with self._lock:
            self._pinned.add(key)
        obs.counter_add("cache.pin")

    def unpin(self, key: Hashable) -> None:
        """Drop the eviction exemption (idempotent); the entry itself
        stays until normal LRU pressure removes it."""
        with self._lock:
            self._pinned.discard(key)
            self._evict_locked()
        obs.counter_add("cache.unpin")

    @property
    def pinned(self) -> frozenset:
        with self._lock:
            return frozenset(self._pinned)

    def note_width_class(self, width_class: Hashable, key: Hashable) -> None:
        """Record that plan ``key`` belongs to ``width_class`` (the
        structural solve identity from ``TriangularSolver.width_class``).
        Idempotent."""
        with self._lock:
            self._width_classes.setdefault(width_class, set()).add(key)

    def width_class_members(self, width_class: Hashable) -> frozenset:
        with self._lock:
            return frozenset(self._width_classes.get(width_class, ()))

    def width_class_sizes(self) -> dict:
        """{width_class: member count} — classes with more than one member
        are the cross-pattern batching opportunities."""
        with self._lock:
            return {wc: len(keys) for wc, keys in self._width_classes.items()}

    def replace(self, key: Hashable, entry: object) -> None:
        """Swap the canonical entry for ``key`` (e.g. after a value
        refresh). No-op on the stats; the key must already exist or the
        entry is simply inserted."""
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)

    def note_numeric_update(self) -> None:
        with self._lock:
            self.stats.numeric_updates += 1
        obs.counter_add("cache.numeric_update")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._selections.clear()
            self._pinned.clear()
            self._width_classes.clear()
