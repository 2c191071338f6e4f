"""``SolveService`` — many independent solve requests in, few batched
multi-RHS solves out.

The paper amortizes one schedule across hundreds of solves (§7.7); the
service carries the same idea into a concurrent setting: client threads
``submit(a_or_fingerprint, b)`` single-RHS requests, an admission queue
routes them by sparsity-pattern fingerprint, and a worker loop coalesces
each route's backlog (up to ``max_batch`` / ``max_wait_us``) into one
``TriangularSolver.solve(B[n, m])`` against the cached plan, scattering
the columns back to per-request tickets.

Correctness contracts (the JAX package's, held by
tests/test_torch_serve*.py against it):

  * every served result is bitwise-identical to a direct multi-RHS
    ``solve`` of the same right-hand side on the pinned plan version at
    the dispatched (batch width, column position) — both recorded on the
    ticket; at a fixed width and position the batched solve never lets
    neighbor columns change a request's bits (``direct_reference``);
  * ``numeric_update`` swaps values in *between* microbatches: requests
    are pinned at admission to the then-current plan version
    (``serve.updates``), so an update never corrupts or drops queued work.

The service owns (or shares) a ``PlanCache`` and pins the plan entries it
serves, so cache-eviction pressure from pattern churn cannot evict a plan
with live traffic.

Back-pressure: ``max_queue`` bounds the admission queue. When the
backlog is at the bound, ``submit`` returns a ticket in the ``rejected``
state immediately (``result()`` raises ``QueueFullError``) instead of
letting the queue grow without bound; rejections are counted in the
metrics. Version swaps and numeric updates are never rejected — only
solve admissions are.

``mode="continuous"`` replaces microbatch formation with persistent
device-resident RHS slots (``repro_torch.serve.slots``): admission is slot
allocation into an always-running dispatch loop — no batch-formation
deadline, no drain barrier between dispatches. Both correctness
contracts above carry over unchanged (slot tickets record the pass
width and ``batch_position = lane`` and replay through ``GroupReplay``);
patterns whose binding cannot group (e.g. elastic bounds) fall back to
the microbatch path, visibly in ``stats()``.

On the card. The service solves on the solver's device (the card unless
the plan defaults say ``device="cpu"``): each dispatch moves the batch to
the device and reads its result back with one copy, which waits for the
kernel — ``solve`` returns before the kernel has run, so latencies and
``ServeMetrics`` include the solve on the device. The default backend is
the port's (``kernel``): microbatches launch the m-RHS kernels (bulk or
elastic), width-class batches and continuous passes the banked kernel.
With ``backend="distributed"`` and ``mesh=`` (``repro_torch.mesh``) each
microbatch runs across the mesh's positions, the columns split over its
``data`` axis: the worker loop rounds each dispatch width up to a
multiple of that axis, so batches split evenly instead of padding inside
the backend.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import Counter
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends import get_backend
from repro_torch.pipeline import GroupBank, PlanCache, TriangularSolver, grouped_solve
from repro_torch.serve.batcher import MicroBatcher, normalize_max_batch, pad_width
from repro_torch.serve.metrics import ServeMetrics, pretty
from repro_torch.serve.slots import SlotDispatcher, SlotEngine
from repro_torch.serve.updates import VersionedPlans
from repro_torch.sparse.csr import CSRMatrix, pattern_fingerprint


class QueueFullError(RuntimeError):
    """Raised by ``SolveTicket.result()`` when the request was rejected
    at admission because the service's ``max_queue`` bound was hit."""


class SolveTicket:
    """Future for one submitted request. ``result()`` blocks until the
    microbatch containing this request has been served — or raises
    immediately if the request was ``rejected`` at admission
    (back-pressure)."""

    __slots__ = (
        "fingerprint", "version", "batch_width", "batch_position",
        "served_by", "rejected", "_event", "_result", "_error",
        "t_submit", "t_admit", "t_done",
    )

    def __init__(self, fingerprint: str, version: int):
        self.fingerprint = fingerprint
        self.version = version  # plan version pinned at admission
        self.rejected = False  # True: bounced by the admission bound
        self.batch_width: Optional[int] = None  # set at dispatch
        self.batch_position: Optional[int] = None  # column in the batch
        # the TriangularSolver that served this request — kept on the
        # ticket so verification can replay the exact solve even after
        # the version retires from the service's registry
        self.served_by: Optional[TriangularSolver] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None  # continuous: lane insertion
        self.t_done: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("solve request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def _fulfill(self, x, error: Optional[BaseException] = None) -> None:
        # exactly-once termination: a ticket that completed (or was
        # rejected) can never be fulfilled again — a second fulfill is
        # always a serving-loop bug (e.g. a lane double-completion), so
        # it raises instead of silently overwriting the first result
        if self._event.is_set():
            raise RuntimeError(
                f"ticket for pattern {self.fingerprint[:12]} fulfilled "
                "twice"
            )
        self._result = x
        self._error = error
        self.t_done = time.perf_counter()
        self._event.set()

    def _reject(self, depth: int, bound: int) -> None:
        self.rejected = True
        self._fulfill(
            None,
            QueueFullError(
                f"admission queue full ({depth} >= max_queue={bound}); "
                "request rejected — retry with backoff"
            ),
        )


class _Request:
    __slots__ = ("ticket", "b")

    def __init__(self, ticket: SolveTicket, b: np.ndarray):
        self.ticket = ticket
        self.b = b


def to_host(x) -> np.ndarray:
    """A solve's result on the host: one copy for a tensor on the card
    (which waits for the kernel), the array itself otherwise."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GroupReplay:
    """The bitwise reference solver for a width-class-grouped result.

    A cross-pattern grouped batch executes each column against its own
    plan through the grouped solve (the banked kernel on the ``kernel``
    backend), not the plain multi-RHS one — so the replay for such a
    ticket is the SAME grouped solve with the request's own solver
    replicated into every lane. Lane independence (a lane's bits depend
    only on its own plan and rhs) makes this reproduce the served bits
    exactly at the recorded (width, position). Exposes ``solve(B)`` so
    ``direct_reference`` works on grouped tickets unchanged."""

    __slots__ = ("solver",)

    def __init__(self, solver: TriangularSolver):
        self.solver = solver

    def solve(self, B):
        B = np.asarray(B)
        return grouped_solve([self.solver] * B.shape[1], B)


def _width_class_label(wc) -> str:
    """Stable short handle for a width-class tuple — JSON dict keys in
    ``stats()`` (the raw tuple is neither a string nor hash-stable
    across processes)."""
    return "wc-" + hashlib.sha1(repr(wc).encode()).hexdigest()[:12]


def direct_reference(
    solver: TriangularSolver, b, width: int = 2, position: int = 0
) -> np.ndarray:
    """The bitwise reference for a served result: a direct
    ``solver.solve`` of a batch with ``b`` at column ``position`` (zeros
    elsewhere), at the dispatched width — both recorded on the ticket
    (``batch_width`` / ``batch_position``). At a fixed (width, position),
    a column's bits are independent of what the other columns hold, so
    this reproduces the served bits exactly. Returns x f[n] on the
    host."""
    b = np.asarray(b)
    B = np.zeros((b.shape[0], max(width, 1)), b.dtype)
    B[:, position] = b
    return to_host(solver.solve(B))[:, position]


class SolveService:
    """Batching SpTRSV solve service over ``repro_torch.pipeline``.

    Parameters mirror the two serving knobs plus the plan binding:
    ``max_batch`` / ``max_wait_us`` bound each microbatch's size and
    latency cost (``max_batch`` is normalized DOWN to a power of two —
    the log2 compiled-variant bound); ``max_queue`` bounds the admission
    backlog (None = unbounded; at the bound, submits come back
    ``rejected`` instead of growing the queue); ``n_workers`` executes
    batches concurrently (distinct routes only — one batch owns its
    whole route group); ``width_class_batching=True`` routes requests by
    structural plan identity instead of (pattern, version), so
    structurally-identical patterns coalesce into one grouped multi-RHS
    solve (backends with the ``"grouped"`` capability; each column keeps
    its own pattern/values and its bitwise (width, position) contract
    via ``GroupReplay``); everything in ``plan_defaults`` (strategy,
    backend, dtype, device, k, ...) flows to ``TriangularSolver.plan`` at
    registration. With ``backend="distributed"`` and a ``mesh`` the worker
    loop additionally rounds each dispatch width up to a multiple of the
    mesh's ``data`` axis, so batches shard cleanly instead of padding
    inside the backend.

    ``mode`` selects the serving engine: ``"microbatch"`` (default,
    everything above) or ``"continuous"`` — persistent device-resident
    RHS slots with an always-running dispatch loop per width class
    (``repro_torch.serve.slots``; ``n_slots`` lanes each, default
    ``max_batch``, normalized UP to a power of two). Continuous mode
    requires the backend to advertise the ``"slots"`` capability;
    groupable patterns of one width class share an engine (cross-
    pattern by construction, no ``width_class_batching`` flag needed),
    while non-groupable patterns (elastic bounds, ``slack=N`` in the
    plan defaults) fall back to the microbatch path — the service-level
    ``mode`` knob is about the serving loop, not the solve graph.
    """

    def __init__(
        self,
        *,
        max_batch: int = 32,
        max_wait_us: int = 2000,
        max_queue: Optional[int] = None,
        n_workers: int = 1,
        width_class_batching: bool = False,
        mode: str = "microbatch",
        n_slots: Optional[int] = None,
        cache: Optional[PlanCache] = None,
        strategy: str = "auto",
        **plan_defaults,
    ):
        self.max_batch = normalize_max_batch(max_batch)
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        self.max_queue = max_queue
        self.width_class_batching = width_class_batching
        if mode not in ("microbatch", "continuous"):
            raise ValueError(
                f"mode must be 'microbatch' or 'continuous'; got {mode!r}"
            )
        self.mode = mode
        self.n_slots = self.max_batch if n_slots is None else int(n_slots)
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if mode == "continuous":
            # the port's own default backend ("kernel"), not the JAX one
            backend = plan_defaults.get(
                "backend", TriangularSolver.plan.__kwdefaults__["backend"]
            )
            if "slots" not in get_backend(backend).capabilities():
                raise ValueError(
                    f"mode='continuous' needs a backend with the 'slots' "
                    f"capability (resident RHS slots); backend "
                    f"{backend!r} does not advertise it"
                )
            # continuous serving lives on groupable (bankable) bindings;
            # left to itself, strategy='auto' may flip deep patterns to
            # elastic mode, whose bounds cannot join a bank — silently
            # routing a slice of traffic through the microbatch fallback
            # and re-importing the formation deadline this mode removes.
            # Pin auto selection to bulk-synchronous unless the caller
            # explicitly opts a pattern into elastic (those still serve,
            # via the fallback path).
            plan_defaults.setdefault("mode", "bsp")
        self._engines: Dict[tuple, SlotEngine] = {}  # wc -> slot engine
        # one dispatch loop drives every engine (see slots module doc)
        self._dispatcher = (
            SlotDispatcher() if mode == "continuous" else None
        )
        self.cache = cache if cache is not None else PlanCache()
        self._plan_defaults = dict(strategy=strategy, **plan_defaults)
        # mesh-sharded serving: batches shard over the mesh's 'data' axis,
        # so the worker loop aligns dispatch widths to it up front
        mesh = plan_defaults.get("mesh")
        self._mesh = mesh
        self._batch_align = (
            int(dict(mesh.shape).get("data", 1))
            if mesh is not None
            and plan_defaults.get("backend") == "distributed"
            else 1
        )
        self._patterns: Dict[str, VersionedPlans] = {}
        self._width_classes: Dict[tuple, set] = {}  # wc -> fingerprints
        self._banks: Dict[tuple, GroupBank] = {}  # wc -> device bank
        self._pinned_keys: set = set()  # released at close()
        self._pins_released = False
        self._plock = threading.Lock()
        self._batcher = MicroBatcher(
            max_batch=self.max_batch, max_wait_us=max_wait_us
        )
        self.metrics = ServeMetrics()
        self._closed = False
        self._workers = [
            threading.Thread(
                target=self._worker_loop, name=f"solve-worker-{i}",
                daemon=True,
            )
            for i in range(max(n_workers, 1))
        ]
        self.n_workers = len(self._workers)
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------ patterns
    def register(
        self, a: CSRMatrix, *, lower: bool = True, **plan_kwargs
    ) -> str:
        """Plan (or re-use) the solver for ``a``'s sparsity pattern;
        returns the pattern fingerprint — the cheap handle clients pass
        to ``submit`` to skip re-hashing. Registering an already-known
        pattern with new values is an implicit ``numeric_update``."""
        if self._closed:
            # a post-close registration would pin a cache key that no
            # close() will ever release
            raise RuntimeError("service is closed")
        fp = pattern_fingerprint(a)
        vp = self._patterns.get(fp)
        if vp is not None and vp.lower != lower:
            raise ValueError(
                f"pattern {fp[:12]}… is registered with "
                f"lower={vp.lower}; re-registering it with lower={lower} "
                "would silently change the solve orientation"
            )
        if vp is None:
            # plan outside the registry lock (the inspector can take
            # seconds); racing registrations of one pattern share plan
            # work through the PlanCache and keep the first-inserted entry
            solver = TriangularSolver.plan(
                a,
                cache=self.cache,
                lower=lower,
                **{**self._plan_defaults, **plan_kwargs},
            )
            if solver.plan_key is not None:
                self.cache.pin(solver.plan_key)
                self.cache.note_width_class(
                    solver.width_class, solver.plan_key
                )
                with self._plock:
                    # a close() that already released the pins will never
                    # run again for this key — racing past the _closed
                    # check above must not leak an eternal pin into a
                    # shared cache
                    too_late = self._pins_released
                    if not too_late:
                        self._pinned_keys.add(solver.plan_key)
                if too_late:
                    self.cache.unpin(solver.plan_key)
                    raise RuntimeError("service is closed")
            with self._plock:
                vp = self._patterns.get(fp)
                if vp is None:
                    vp = VersionedPlans(solver, lower=lower)
                    self._patterns[fp] = vp
                    if vp.width_class is not None:
                        self._width_classes.setdefault(
                            vp.width_class, set()
                        ).add(fp)
                    return fp
        if vp.lower != lower:  # racing registration with other orientation
            raise ValueError(
                f"pattern {fp[:12]}… is registered with lower={vp.lower}"
            )
        if not vp.values_match(np.asarray(a.data)):
            self.numeric_update(fp, a.data)
        return fp

    def pattern(self, fp: str) -> VersionedPlans:
        try:
            return self._patterns[fp]
        except KeyError:
            raise KeyError(
                f"unknown pattern fingerprint {fp!r}; submit the CSRMatrix "
                "itself (auto-registers) or call register(a) first"
            ) from None

    # --------------------------------------------------- continuous engines
    def _key_live(self, key) -> bool:
        """Bank-lane liveness for the slot engines' prune: a
        ``(fingerprint, version)`` key is prunable once its version has
        retired from the registry. Queried at prune time under the bank
        lock — any queued or in-lane request pins its version, so a
        live lane can never be seen as dead."""
        fp, version = key
        vp = self._patterns.get(fp)
        return vp is not None and version in vp.live_versions()

    def _key_complete(self, key, count: int) -> None:
        """Unpin ``count`` served requests from their admitted version
        (the slot engines' mirror of the worker loops'
        ``VersionedPlans.complete``)."""
        fp, version = key
        self._patterns[fp].complete(version, count)

    def _engine_for(self, wc) -> SlotEngine:
        """The width class's slot engine, created on first use (lanes
        only materialize on device for classes that actually serve)."""
        with self._plock:
            eng = self._engines.get(wc)
            if eng is None:
                eng = self._engines[wc] = SlotEngine(
                    n_slots=self.n_slots,
                    metrics=self.metrics,
                    is_live=self._key_live,
                    on_complete=self._key_complete,
                    name=_width_class_label(wc),
                )
            return eng

    def _backlog(self) -> int:
        """Total admission backlog across both serving paths — the
        quantity ``max_queue`` bounds."""
        with self._plock:
            engines = list(self._engines.values())
        depth = self._batcher.depth()
        if self._dispatcher is not None:
            depth += self._dispatcher.depth()
        return depth + sum(e.state.occupancy for e in engines)

    # ------------------------------------------------------------- serving
    def submit(
        self,
        a_or_fp: Union[CSRMatrix, str],
        b,
        *,
        lower: Optional[bool] = None,
        **plan_kwargs,
    ) -> SolveTicket:
        """Enqueue one single-RHS solve; returns a ``SolveTicket``.
        ``a_or_fp`` is either a fingerprint from ``register`` (the fast
        path — no hashing, no value comparison; orientation and plan
        binding were fixed at registration, so ``lower``/``plan_kwargs``
        only cross-check) or a ``CSRMatrix`` (auto-registers; same
        pattern with new values triggers an implicit
        ``numeric_update``)."""
        if self._closed:
            raise RuntimeError("service is closed")
        if isinstance(a_or_fp, CSRMatrix):
            fp = self.register(
                a_or_fp,
                lower=True if lower is None else lower,
                **plan_kwargs,
            )
            vp = self.pattern(fp)
        else:
            fp = a_or_fp
            vp = self.pattern(fp)
            if lower is not None and lower != vp.lower:
                raise ValueError(
                    f"pattern {fp[:12]}… was registered with "
                    f"lower={vp.lower}; it cannot serve lower={lower} "
                    "requests"
                )
        b = np.asarray(b)
        if b.ndim != 1 or b.shape[0] != vp.n:
            raise ValueError(
                f"submit takes one right-hand side f[n={vp.n}]; got "
                f"{b.shape} (batching is the service's job)"
            )
        # admission bound: bounce instead of growing the backlog. The
        # check-then-put is advisory (racing submits may briefly overshoot
        # by n_producers), which is the standard cheap admission-control
        # trade-off — the queue stays O(max_queue), never unbounded.
        if self.max_queue is not None:
            depth = self._backlog()
            if depth >= self.max_queue:
                ticket = SolveTicket(fp, -1)
                self.metrics.record_rejected(fp)
                ticket._reject(depth, self.max_queue)
                return ticket
        # continuous mode: groupable patterns go to their width class's
        # slot engine — admission is slot allocation, not group
        # formation. Non-groupable bindings (elastic bounds have no
        # banked twin) fall back to the microbatch path below.
        if self.mode == "continuous" and vp.groupable:
            version, solver = vp.admit()
            ticket = SolveTicket(fp, version)
            self.metrics.record_submit(fp)
            try:
                self._dispatcher.submit(
                    self._engine_for(vp.width_class),
                    ticket,
                    (fp, version),
                    solver,
                    b,
                )
            except RuntimeError:
                vp.complete(version)
                raise
            return ticket
        version, _ = vp.admit()
        ticket = SolveTicket(fp, version)
        self.metrics.record_submit(fp)
        # width-class routing coalesces structurally-identical plans into
        # one grouped dispatch; each request still pins (and is served
        # by) its own (pattern, version) — the route only widens WHO can
        # share a batch, never what values a column sees
        if self.width_class_batching and vp.groupable:
            route = ("wc", vp.width_class)
        else:
            route = (fp, version)
        try:
            self._batcher.put(route, _Request(ticket, b))
        except RuntimeError:
            vp.complete(version)
            raise
        return ticket

    def solve(
        self,
        a_or_fp: Union[CSRMatrix, str],
        b,
        *,
        timeout: Optional[float] = None,
        **kw,
    ) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(a_or_fp, b, **kw).result(timeout)

    def numeric_update(
        self, a_or_fp: Union[CSRMatrix, str], data=None
    ) -> int:
        """Install new factor values for a registered pattern; returns the
        new plan version. Requests already admitted stay pinned to their
        version — the swap is only visible to later submissions."""
        if isinstance(a_or_fp, CSRMatrix):
            fp = pattern_fingerprint(a_or_fp)
            payload = a_or_fp  # clone_with_values re-checks the pattern
        else:
            fp = a_or_fp
            if data is None:
                raise ValueError(
                    "numeric_update(fingerprint) needs the new values"
                )
            payload = np.asarray(data)
        vp = self.pattern(fp)
        v = vp.update(payload)
        self.metrics.record_update(fp)
        return v

    # -------------------------------------------------------------- worker
    def _worker_loop(self) -> None:
        while True:
            item = self._batcher.next_batch()
            if item is None:
                return
            route, reqs = item
            if route and route[0] == "wc":
                self._serve_group(route[1], reqs)
            else:
                fp, version = route
                self._serve_plain(fp, version, reqs)

    def _dispatch_width(self, m: int) -> int:
        """The batch width actually dispatched for ``m`` requests: pow2
        quantization (``pad_width``) then — mesh-sharded serving — round
        UP to a multiple of the mesh's ``data`` axis, so the distributed
        backend splits the batch instead of padding it internally. Still
        at most log2(max_batch) distinct widths."""
        w = pad_width(m, self.max_batch)
        if self._batch_align > 1:
            w = -(-w // self._batch_align) * self._batch_align
        return w

    def _serve_plain(self, fp: str, version: int, reqs) -> None:
        """One (pattern, version) microbatch — the classic multi-RHS
        path; every column shares one solver."""
        vp = self._patterns[fp]
        t0 = time.perf_counter()
        try:
            solver = vp.solver_for(version)
            m = len(reqs)
            B = np.stack([r.b for r in reqs], axis=1)
            w = self._dispatch_width(m)
            if w > m:
                B = np.concatenate(
                    [B, np.zeros((B.shape[0], w - m), B.dtype)], axis=1
                )
            with obs.span(
                "serve.microbatch", cat="serve", size=m, width=w
            ):
                X = to_host(solver.solve(B))
            t1 = time.perf_counter()
            for j, r in enumerate(reqs):
                r.ticket.batch_width = w
                r.ticket.batch_position = j
                r.ticket.served_by = solver
                r.ticket._fulfill(np.ascontiguousarray(X[:, j]))
            self.metrics.record_batch(
                fp,
                m,
                queue_waits=[t0 - r.ticket.t_submit for r in reqs],
                e2e=[r.ticket.t_done - r.ticket.t_submit for r in reqs],
                solve_seconds=t1 - t0,
            )
        except Exception as e:  # scatter the failure, keep serving
            for r in reqs:
                r.ticket._fulfill(None, e)
            self.metrics.record_failure(fp, len(reqs))
        finally:
            vp.complete(version, len(reqs))

    def _serve_group(self, wc, reqs) -> None:
        """One width-class microbatch: columns may come from different
        patterns and plan versions (one solver per column), executed
        through the class's device-side ``GroupBank`` — one dispatch (one
        launch of the banked kernel), no per-dispatch tensor stacking. A group that happens to be
        homogeneous takes the plain path — same bits, same
        ``direct_reference`` contract as before."""
        req_keys = [
            (r.ticket.fingerprint, r.ticket.version) for r in reqs
        ]
        if len(set(req_keys)) == 1:
            fp, version = req_keys[0]
            self._serve_plain(fp, version, reqs)
            return
        t0 = time.perf_counter()
        try:
            solvers = [
                self._patterns[fp].solver_for(version)
                for fp, version in req_keys
            ]
            bank = self._banks.setdefault(wc, GroupBank())
            for key, solver in zip(req_keys, solvers):
                bank.add(key, solver)
            # retire bank lanes of drained, superseded versions (their
            # VersionedPlans entry is gone, so they can never dispatch).
            # Liveness is queried INSIDE the prune (under the bank lock,
            # serialized with concurrent adds) — a hoisted snapshot could
            # go stale against another worker's just-added lane and drop
            # it: any in-flight batch pins its versions, so a
            # query-at-prune-time can never see them as dead.
            fps_touched = {fp for fp, _ in req_keys}
            bank.prune(
                lambda k: k[0] not in fps_touched
                or k[1] in self._patterns[k[0]].live_versions()
            )
            m = len(reqs)
            w = self._dispatch_width(m)
            B = np.stack([r.b for r in reqs], axis=1)
            keys = list(req_keys)
            if w > m:
                B = np.concatenate(
                    [B, np.zeros((B.shape[0], w - m), B.dtype)], axis=1
                )
                keys = keys + [keys[0]] * (w - m)  # padding lanes
            with obs.span(
                "serve.grouped_batch",
                cat="serve",
                size=m,
                width=w,
                patterns=len(fps_touched),
            ):
                X = to_host(bank.solve(keys, B))
            t1 = time.perf_counter()
            for j, r in enumerate(reqs):
                r.ticket.batch_width = w
                r.ticket.batch_position = j
                r.ticket.served_by = GroupReplay(solvers[j])
                r.ticket._fulfill(np.ascontiguousarray(X[:, j]))
            self.metrics.record_grouped_batch(
                [r.ticket.fingerprint for r in reqs],
                queue_waits=[t0 - r.ticket.t_submit for r in reqs],
                e2e=[r.ticket.t_done - r.ticket.t_submit for r in reqs],
                solve_seconds=t1 - t0,
            )
        except Exception as e:  # scatter the failure, keep serving
            for r in reqs:
                r.ticket._fulfill(None, e)
            for fp, cnt in Counter(
                r.ticket.fingerprint for r in reqs
            ).items():
                self.metrics.record_failure(fp, cnt)
        finally:
            done = Counter(
                (r.ticket.fingerprint, r.ticket.version) for r in reqs
            )
            for (fp, version), cnt in done.items():
                self._patterns[fp].complete(version, cnt)

    # ------------------------------------------------------------- warm-up
    def prewarm(self) -> None:
        """Run every dispatch serving can make once — per pattern, each
        pow2 batch width; per width class with cross-pattern batching on,
        the banked solve at each width; in continuous mode each engine's
        passes. The first launch of a kernel builds and loads its library,
        and a bank is stacked on its first solve; benchmarks call this
        before measuring so steady-state percentiles include neither."""
        widths = sorted(
            {
                self._dispatch_width(m)
                for m in range(1, self.max_batch + 1)
            }
        )
        with self._plock:
            patterns = list(self._patterns.items())
            classes = {
                wc: sorted(fps)
                for wc, fps in self._width_classes.items()
            }
        for fp, vp in patterns:
            solver = vp.current_solver()
            for w in widths:
                to_host(solver.solve(np.zeros((vp.n, w))))
        if self.mode == "continuous":
            # run the slot engines' passes per groupable pattern: an
            # insert/extract pair plus the resident pass at every pow2
            # prefix width — in registration order, so the later patterns
            # warm against the bank lane counts the steady state will use
            for fp, vp in patterns:
                if vp.groupable:
                    version, solver = vp.current_entry()
                    self._engine_for(vp.width_class).warm(
                        (fp, version), solver
                    )
        if not self.width_class_batching:
            return
        for wc, fps in classes.items():
            groupable = [
                fp for fp in fps if self._patterns[fp].groupable
            ]
            if len(groupable) < 2:
                continue
            bank = self._banks.setdefault(wc, GroupBank())
            keys = []
            for fp in groupable:
                vp = self._patterns[fp]
                # one atomic read: (version, solver) must pair up, or a
                # racing numeric_update could register a lane keyed by
                # the old version holding the new version's values
                version, solver = vp.current_entry()
                key = (fp, version)
                bank.add(key, solver)
                keys.append(key)
            n = self._patterns[groupable[0]].n
            for w in widths:
                lanes = [keys[j % len(keys)] for j in range(w)]
                to_host(bank.solve(lanes, np.zeros((n, w))))

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: Optional[float] = None) -> dict:
        """Stop admissions, drain the queue, join the workers; release
        the plan-cache eviction pins only once every worker has actually
        exited. A worker still alive after ``timeout`` may hold an
        in-flight batch against a pinned plan — unpinning then would let
        LRU eviction race the batch — so the pins are RETAINED and
        reported instead; call ``close()`` again (it is idempotent and
        retries the join) once the stall clears.

        Returns a report dict: ``workers_alive`` (names of workers that
        missed the timeout), ``pins_released``, ``pins_retained``."""
        self._closed = True
        self._batcher.close()
        deadline = (
            None if timeout is None else time.perf_counter() + timeout
        )
        stuck = []
        for w in self._workers:
            if deadline is None:
                w.join()
            else:
                w.join(max(0.0, deadline - time.perf_counter()))
            if w.is_alive():
                stuck.append(w.name)
        # the slot dispatcher drains its queue and every engine's pending
        # work before exiting — shutdown never strands a continuous-mode
        # ticket
        if self._dispatcher is not None:
            joined = self._dispatcher.close(
                None
                if deadline is None
                else max(0.0, deadline - time.perf_counter())
            )
            if not joined:
                stuck.append("slot-dispatch")
        if stuck:
            with self._plock:
                retained = len(self._pinned_keys)
            return {
                "workers_alive": stuck,
                "pins_released": 0,
                "pins_retained": retained,
            }
        # release the eviction pins — a shared PlanCache outliving this
        # service must regain its normal LRU behavior
        with self._plock:
            keys, self._pinned_keys = self._pinned_keys, set()
            self._pins_released = True
        for key in keys:
            self.cache.unpin(key)
        return {
            "workers_alive": [],
            "pins_released": len(keys),
            "pins_retained": 0,
        }

    def __enter__(self) -> "SolveService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """JSON-ready snapshot: serving telemetry + plan-cache stats +
        live plan versions per pattern."""
        cs = self.cache.stats
        looked_up = cs.hits + cs.misses
        # snapshot under the registry lock: submit(CSRMatrix) auto-registers
        # concurrently, and iterating the live dict while it grows would
        # crash the telemetry thread
        with self._plock:
            patterns = list(self._patterns.items())
            width_classes = {
                wc: sorted(fps) for wc, fps in self._width_classes.items()
            }
            engines = dict(self._engines)
        wc_labels = {wc: _width_class_label(wc) for wc in width_classes}
        return self.metrics.snapshot(
            queue_depth=self._backlog(),
            extra={
                "serving": {
                    "mode": self.mode,
                    "n_workers": self.n_workers,
                    "workers_alive": sum(
                        w.is_alive() for w in self._workers
                    ),
                    "max_batch": self.max_batch,
                    "n_slots": self.n_slots,
                    "batch_align": self._batch_align,
                    "width_class_batching": self.width_class_batching,
                    "mesh": dict(self._mesh.shape)
                    if self._mesh is not None
                    else None,
                },
                "plan_cache": {
                    **cs.as_dict(),
                    "hit_rate": round(cs.hits / looked_up, 3)
                    if looked_up
                    else 0.0,
                },
                # classes with >1 pattern are live cross-pattern batching
                # opportunities (the width mix's whole premise)
                "width_classes": {
                    wc_labels[wc]: {
                        "n_patterns": len(fps),
                        "patterns": fps,
                        # bank telemetry: live device lanes + restacks
                        "bank": self._banks[wc].describe()
                        if wc in self._banks
                        else None,
                        # continuous mode: the class's slot engine
                        "slots": engines[wc].describe()
                        if wc in engines
                        else None,
                    }
                    for wc, fps in width_classes.items()
                },
                "patterns": {
                    fp: {
                        "versions_alive": vp.live_versions(),
                        "current_version": vp.current,
                        "width_class": wc_labels.get(vp.width_class),
                        # the backend BoundSolve's own telemetry (shapes,
                        # device bytes, compiled variants) — registry
                        # backends all speak describe(); current_solver()
                        # reads atomically so a racing update cannot
                        # retire the version mid-lookup
                        "binding": vp.current_solver().bound.describe(),
                    }
                    for fp, vp in patterns
                },
                # repro_torch.obs cross-layer tracing aggregate — one merged
                # telemetry document per service: serve metrics above,
                # span/counter rollup here ({"enabled": False} when
                # tracing is off)
                "obs": obs.summary(),
            },
        )

    def print_stats(self) -> None:
        print(pretty(self.stats()), flush=True)
