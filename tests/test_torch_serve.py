"""``repro_torch.serve`` — the batching solve service of the port, on the
CPU, under concurrency, held against the JAX package
(``tests/test_serve.py`` is the reference; its cases are here on both port
backends where the backend matters):

  * with >= 8 client threads over mixed patterns, every served result is
    bitwise a direct ``TriangularSolver.solve`` at the dispatched batch
    width and position (``direct_reference``);
  * interleaved ``numeric_update``s never corrupt or drop queued requests
    (version pinning);
  * at a fixed (width, position) a column's bits depend only on its own b;
  * served results (microbatch, across a ``numeric_update``) are bitwise
    JAX's ``direct_reference`` on the same values at the same (width,
    position), f32 and f64, on both backends;
  * the launch counters count exactly under 8 threads.

Every threaded wait carries a timeout.
"""
import contextlib
import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsparse
from repro.pipeline import TriangularSolver as JSolver
from repro.serve import direct_reference as jdirect_reference
from repro_torch.kernels import spmv, sptrsv
from repro_torch.mesh import make_mesh
from repro_torch.pipeline import PlanCache, TriangularSolver
from repro_torch.serve import (
    LatencyReservoir,
    MicroBatcher,
    QueueFullError,
    SolveService,
    VersionedPlans,
    direct_reference,
    make_sampler,
    mix_weights,
    pad_width,
    pretty,
    run_closed_loop,
    run_open_loop,
)
from repro_torch.sparse.generators import erdos_renyi_lower, narrow_band_lower

STRATEGY = "growlocal"  # fixed: keeps plan() cheap and deterministic
BACKENDS = ("kernel", "scan")


def _service(backend="kernel", **kw):
    kw.setdefault("strategy", STRATEGY)
    return SolveService(backend=backend, device="cpu", **kw)


@contextlib.contextmanager
def _serving(*args, **kw):
    """A service that closes with a timeout, and must close in it."""
    svc = _service(*args, **kw)
    try:
        yield svc
    finally:
        assert svc.close(timeout=60)["workers_alive"] == []


def _plan(L, backend="kernel", **kw):
    return TriangularSolver.plan(L, strategy=STRATEGY, device="cpu", backend=backend, **kw)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.fixture(scope="module")
def mats():
    return [
        erdos_renyi_lower(120, 0.03, seed=21),
        narrow_band_lower(160, 0.1, 6, seed=22),
        erdos_renyi_lower(200, 0.02, seed=23),
    ]


@pytest.fixture(params=BACKENDS)
def service(request):
    svc = _service(request.param, max_batch=8, max_wait_us=3000)
    yield svc
    svc.close(timeout=60)


# ----------------------------------------------------------- unit: batcher
def test_pad_width_policy():
    assert [pad_width(m, 8) for m in (1, 2, 3, 4, 5, 8)] == [2, 2, 4, 4, 8, 8]
    assert pad_width(9, 12) == 8
    assert pad_width(1, 1) == 1
    assert pad_width(5, 1) == 1


def test_batcher_coalesces_and_splits():
    b = MicroBatcher(max_batch=3, max_wait_us=10_000_000)
    assert b.max_batch == 2
    for i in range(7):
        b.put("r", i)
    assert b.depth() == 7
    assert b.next_batch() == ("r", [0, 1])
    assert b.next_batch() == ("r", [2, 3])
    assert b.next_batch() == ("r", [4, 5])
    b.close()
    assert b.next_batch() == ("r", [6])
    assert b.next_batch() is None
    with pytest.raises(RuntimeError):
        b.put("r", 8)


def test_batcher_deadline_dispatches_partial_group():
    b = MicroBatcher(max_batch=64, max_wait_us=20_000)
    t0 = time.perf_counter()
    b.put("r", "x")
    route, items = b.next_batch()
    waited = time.perf_counter() - t0
    assert (route, items) == ("r", ["x"])
    assert waited >= 0.015
    b.close()
    assert b.next_batch() is None


def test_batcher_routes_are_isolated():
    b = MicroBatcher(max_batch=2, max_wait_us=10_000_000)
    b.put(("fp1", 0), "a")
    b.put(("fp2", 0), "b")
    b.put(("fp1", 0), "c")
    assert b.next_batch() == (("fp1", 0), ["a", "c"])
    b.close()
    assert b.next_batch() == (("fp2", 0), ["b"])


# ------------------------------------------- the bitwise contract's bedrock
@pytest.mark.parametrize("backend", BACKENDS)
def test_neighbor_independence_at_fixed_width_and_position(mats, backend):
    rng = np.random.default_rng(0)
    for L in mats:
        solver = _plan(L, backend)
        n = L.n_rows
        b = rng.standard_normal(n).astype(np.float32)
        for w in (2, 4, 8):
            for pos in (0, w // 2, w - 1):
                ref = direct_reference(solver, b, w, pos)
                for _ in range(2):
                    B = rng.standard_normal((n, w)).astype(np.float32)
                    B[:, pos] = b
                    got = solver.solve(B)[:, pos].numpy()
                    assert np.array_equal(got, ref), (n, w, pos)


# --------------------------------------------------------- service basics
def test_submit_by_matrix_then_fingerprint(service, mats):
    L = mats[0]
    b = np.random.default_rng(1).standard_normal(L.n_rows)
    t1 = service.submit(L, b)
    x1 = t1.result(timeout=60)
    assert isinstance(x1, np.ndarray)
    fp = t1.fingerprint
    x2 = service.solve(fp, b, timeout=60)
    solver = service.pattern(fp).solver_for(t1.version)
    assert t1.served_by is solver
    assert np.array_equal(x1, direct_reference(solver, b, t1.batch_width, t1.batch_position))
    assert np.array_equal(x1, x2)


def test_submit_rejects_bad_shapes_and_unknown_fp(service, mats):
    fp = service.register(mats[0])
    n = mats[0].n_rows
    with pytest.raises(ValueError, match="one right-hand side"):
        service.submit(fp, np.ones((n, 2)))
    with pytest.raises(ValueError, match="one right-hand side"):
        service.submit(fp, np.ones(n + 1))
    with pytest.raises(KeyError, match="unknown pattern"):
        service.submit("deadbeef", np.ones(n))


def test_matrix_resubmission_with_new_values_is_implicit_update(service, mats):
    L = mats[0]
    fp = service.register(L)
    assert service.pattern(fp).current == 0
    L2 = dataclasses.replace(L, data=L.data * 2.0)
    t = service.submit(L2, np.ones(L.n_rows))
    assert t.version == 1
    x = t.result(timeout=60)
    solver = service.pattern(fp).solver_for(1)
    assert np.array_equal(
        x, direct_reference(solver, np.ones(L.n_rows), t.batch_width, t.batch_position))
    service.solve(L2, np.ones(L.n_rows), timeout=60)
    assert service.pattern(fp).current == 1


def test_register_orientation_mismatch_rejected(service):
    from repro_torch.autotune import independent_lower

    d = independent_lower(40, seed=9)
    fp = service.register(d, lower=True)
    with pytest.raises(ValueError, match="registered with lower=True"):
        service.register(d, lower=False)
    with pytest.raises(ValueError, match="registered with lower=True"):
        service.submit(d, np.ones(40), lower=False)
    with pytest.raises(ValueError, match="registered with lower=True"):
        service.submit(fp, np.ones(40), lower=False)
    service.solve(fp, np.ones(40), timeout=60)
    assert service.pattern(fp).lower is True


def test_close_releases_cache_pins(mats):
    cache = PlanCache(maxsize=2)
    with _serving(cache=cache) as svc:
        for L in mats:
            svc.register(L)
        assert len(cache.pinned) == len(mats)
    assert len(cache.pinned) == 0
    assert len(cache) <= 2


def test_closed_service_rejects_submissions(mats):
    svc = _service()
    fp = svc.register(mats[0])
    svc.close(timeout=60)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(fp, np.ones(mats[0].n_rows))
    with pytest.raises(RuntimeError, match="closed"):
        svc.register(mats[1])


def test_distributed_serving_is_refused(mats):
    # distributed serving runs (tests/test_torch_serve_distributed.py);
    # what stays refused: the distributed backend without a mesh, a mesh
    # that is not a repro_torch Mesh, and a mesh on a one-device backend
    with _serving("distributed") as svc:
        with pytest.raises(ValueError, match="distributed"):
            svc.register(mats[0])
        with pytest.raises(TypeError, match="Mesh"):
            svc.register(mats[0], mesh=object())
    with _serving() as svc:
        with pytest.raises(ValueError, match="distributed"):
            svc.register(mats[0], mesh=make_mesh((1, 2), devices="cpu"))


# ----------------------------------------- acceptance: concurrent clients
def test_concurrent_clients_bitwise_identical(service, mats):
    fps = [service.register(L) for L in mats]
    ns = {fp: L.n_rows for fp, L in zip(fps, mats)}
    n_clients, per_client = 8, 6
    out = [[] for _ in range(n_clients)]
    seed_rngs = [np.random.default_rng(100 + i) for i in range(n_clients)]

    def client(ci):
        rng = seed_rngs[ci]
        for j in range(per_client):
            fp = fps[(ci + j) % len(fps)]
            b = rng.standard_normal(ns[fp]).astype(np.float32)
            t = service.submit(fp, b)
            out[ci].append((t, b, t.result(timeout=60)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    served = [s for c in out for s in c]
    assert len(served) == n_clients * per_client
    for ticket, b, x in served:
        solver = service.pattern(ticket.fingerprint).solver_for(ticket.version)
        assert np.array_equal(
            x, direct_reference(solver, b, ticket.batch_width, ticket.batch_position)
        ), (ticket.fingerprint, ticket.batch_width, ticket.batch_position)
    snap = service.stats()
    assert snap["completed"] == len(served) and snap["failed"] == 0
    assert snap["queue_depth"] == 0
    assert "throughput" in pretty(snap)


def test_microbatching_actually_coalesces(mats):
    with _serving(max_batch=8, max_wait_us=300_000) as svc:
        fp = svc.register(mats[0])
        rng = np.random.default_rng(2)
        n = mats[0].n_rows
        tickets = [svc.submit(fp, rng.standard_normal(n)) for _ in range(8)]
        for t in tickets:
            t.result(timeout=60)
        snap = svc.stats()
    assert snap["batches"] < len(tickets)
    assert max(int(k) for k in snap["batch_size_hist"]) >= 2
    assert snap["mean_batch_size"] > 1


# ------------------------------------- acceptance: live numeric updates
@pytest.mark.parametrize("backend", BACKENDS)
def test_version_pinning_across_interleaved_updates(mats, backend):
    L = mats[1]
    n = L.n_rows
    rng = np.random.default_rng(3)
    with _serving(backend, max_batch=64, max_wait_us=150_000) as svc:
        fp = svc.register(L)
        direct = {0: svc.pattern(fp).solver_for(0)}
        admitted = []
        for gen in range(1, 4):
            for _ in range(5):
                b = rng.standard_normal(n).astype(np.float32)
                admitted.append((svc.submit(fp, b), b))
            v = svc.numeric_update(fp, L.data * (1.0 + 0.5 * gen))
            assert v == gen
            direct[v] = svc.pattern(fp).solver_for(v)
        for _ in range(5):
            b = rng.standard_normal(n).astype(np.float32)
            admitted.append((svc.submit(fp, b), b))
        results = [(t, b, t.result(timeout=60)) for t, b in admitted]
    versions = [t.version for t, _, _ in results]
    assert versions == [0] * 5 + [1] * 5 + [2] * 5 + [3] * 5
    for t, b, x in results:
        assert np.array_equal(
            x, direct_reference(direct[t.version], b, t.batch_width, t.batch_position)
        ), f"version {t.version} served with wrong values"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_served_bitwise_jax_direct_reference_across_update(backend, dtype):
    """Microbatch serving on ER and NB, a ``numeric_update`` of ER between
    two bursts: every served result is bitwise JAX's ``direct_reference``
    of the same values at the same (width, position)."""
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    jdt = {"float32": jnp.float32, "float64": jnp.float64}[dtype]
    ndt = {"float32": np.float32, "float64": np.float64}[dtype]
    er, nb = erdos_renyi_lower(150, 0.03, seed=31), narrow_band_lower(150, 0.1, 6, seed=32)
    new = er.data * np.random.default_rng(4).uniform(0.5, 1.5, er.nnz)
    with jax.enable_x64(dtype == "float64"):
        jer = JSolver.plan(jsparse.erdos_renyi_lower(150, 0.03, seed=31), strategy=STRATEGY,
                           dtype=jdt)
        jnb = JSolver.plan(jsparse.narrow_band_lower(150, 0.1, 6, seed=32), strategy=STRATEGY,
                           dtype=jdt)
        jref = {("er", 0): jer, ("er", 1): jer.clone_with_values(new), ("nb", 0): jnb}
    rng = np.random.default_rng(5)
    with _serving(backend, max_batch=8, max_wait_us=200_000, dtype=tdt) as svc:
        names = {svc.register(er): "er", svc.register(nb): "nb"}
        admitted = []
        for burst in range(2):
            for i in range(6):
                fp = list(names)[i % 2]
                b = rng.standard_normal(150).astype(ndt)
                admitted.append((svc.submit(fp, b), b))
            if burst == 0:
                svc.numeric_update(list(names)[0], new)
        results = [(t, b, t.result(timeout=60)) for t, b in admitted]
    assert sorted({(names[t.fingerprint], t.version) for t, _, _ in results}) == [
        ("er", 0), ("er", 1), ("nb", 0)]
    with jax.enable_x64(dtype == "float64"):
        for t, b, x in results:
            ref = np.asarray(jdirect_reference(jref[(names[t.fingerprint], t.version)], b,
                                               t.batch_width, t.batch_position))
            assert x.dtype == ref.dtype == ndt
            assert np.array_equal(_bits(x), _bits(ref)), (names[t.fingerprint], t.version)


def test_update_unknown_fingerprint_and_missing_data(service, mats):
    fp = service.register(mats[0])
    with pytest.raises(KeyError, match="unknown pattern"):
        service.numeric_update("deadbeef", mats[0].data)
    with pytest.raises(ValueError, match="needs the new values"):
        service.numeric_update(fp)


def test_versions_retire_once_drained(mats):
    with _serving(max_batch=4, max_wait_us=1000) as svc:
        fp = svc.register(mats[0])
        n = mats[0].n_rows
        svc.submit(fp, np.ones(n)).result(timeout=60)
        svc.numeric_update(fp, mats[0].data * 3.0)
        svc.submit(fp, np.ones(n)).result(timeout=60)
        assert svc.pattern(fp).wait_retired(0, timeout=10)
        assert svc.pattern(fp).live_versions() == (1,)
        with pytest.raises(KeyError):
            svc.pattern(fp).solver_for(0)


def test_versioned_plans_unit(mats):
    solver = _plan(mats[0])
    vp = VersionedPlans(solver)
    v, s0 = vp.admit()
    assert (v, s0) == (0, solver)
    assert vp.width_class == solver.width_class and vp.groupable
    v1 = vp.update(mats[0].data * 2.0)
    assert v1 == 1 and vp.live_versions() == (0, 1)
    va, s1 = vp.admit()
    assert va == 1 and s1 is not s0
    assert s0.source_values is not None
    assert np.array_equal(s1.source_values, mats[0].data * 2.0)
    vp.complete(0)
    assert vp.live_versions() == (1,)
    vp.complete(1)


# ------------------------------------------------- cache pins + loadgen
def test_plan_cache_pins_are_eviction_safe(mats):
    cache = PlanCache(maxsize=1)
    s0 = _plan(mats[0], cache=cache)
    cache.pin(s0.plan_key)
    _plan(mats[1], cache=cache)
    _plan(mats[2], cache=cache)
    hits0 = cache.stats.hits
    again = _plan(mats[0], cache=cache)
    assert cache.stats.hits == hits0 + 1 and again is s0
    cache.unpin(s0.plan_key)
    assert len(cache) <= 1


def test_service_pins_registered_plans(mats):
    cache = PlanCache(maxsize=1)
    with _serving(cache=cache) as svc:
        fps = [svc.register(L) for L in mats]
        assert len(set(fps)) == len(mats)
        assert len(cache.pinned) == len(mats)
        misses = cache.stats.misses
        for L in mats:
            svc.register(L)
        assert cache.stats.misses == misses


def test_loadgen_mixes_and_closed_loop(mats):
    w = mix_weights("hot", 4)
    assert w[0] > w[-1] and abs(w.sum() - 1) < 1e-12
    assert np.allclose(mix_weights("uniform", 4), 0.25)
    with pytest.raises(ValueError, match="unknown mix"):
        mix_weights("nope", 3)
    with _serving(max_batch=8, max_wait_us=2000) as svc:
        patterns = [(svc.register(L), L.n_rows) for L in mats]
        sampler = make_sampler(patterns, "hot", seed=5)
        kept = []
        report = run_closed_loop(svc, sampler, n_clients=4, requests_per_client=4,
                                 validate=True, timeout=60, keep=kept)
    assert report["requests"] == 16
    assert report["errors"] == 0
    assert report["bitwise_mismatches"] == 0
    assert report["solves_per_sec"] > 0
    assert set(report["latency_us"]) == {"p50", "p95", "p99", "p99.9"}
    assert len(kept) == 16 and all(t.done() for t, _, _ in kept)


def test_loadgen_open_loop(mats):
    with _serving(max_batch=8, max_wait_us=2000) as svc:
        patterns = [(svc.register(mats[0]), mats[0].n_rows)]
        sampler = make_sampler(patterns, "uniform", seed=6)
        report = run_open_loop(svc, sampler, rate_hz=2000.0, n_requests=12, validate=True,
                               timeout=60)
    assert report["requests"] == 12 and report["errors"] == 0
    assert report["bitwise_mismatches"] == 0


# ------------------------------------------------ back-pressure (max_queue)
def test_backpressure_rejects_overflow_keeps_queue_bounded(mats):
    L = mats[0]
    n = L.n_rows
    rng = np.random.default_rng(11)
    with _serving(max_batch=64, max_wait_us=60_000_000, max_queue=4) as svc:
        fp = svc.register(L)
        accepted, rejected = [], []
        for _ in range(10):
            b = rng.standard_normal(n).astype(np.float32)
            t = svc.submit(fp, b)
            (rejected if t.rejected else accepted).append((t, b))
            assert svc._batcher.depth() <= 4
        assert len(accepted) == 4 and len(rejected) == 6
        for t, _ in rejected:
            assert t.done() and t.version == -1
            with pytest.raises(QueueFullError, match="max_queue=4"):
                t.result(1)
        snap = svc.stats()
        assert snap["rejected"] == 6
        assert snap["per_pattern"][fp]["rejected"] == 6
    for t, b in accepted:
        x = t.result(timeout=60)
        assert np.array_equal(
            x, direct_reference(t.served_by, b, t.batch_width, t.batch_position))


def test_backpressure_unbounded_by_default_and_validates_bound(mats):
    with pytest.raises(ValueError, match="max_queue"):
        SolveService(max_queue=0, device="cpu")
    with _serving(max_batch=4, max_wait_us=1000) as svc:
        fp = svc.register(mats[0])
        tickets = [svc.submit(fp, np.ones(mats[0].n_rows)) for _ in range(12)]
        for t in tickets:
            assert not t.rejected
            t.result(timeout=60)
        assert svc.stats()["rejected"] == 0


def test_open_loop_reports_rejections(mats):
    with _serving(max_batch=64, max_wait_us=300_000, max_queue=2) as svc:
        patterns = [(svc.register(mats[0]), mats[0].n_rows)]
        sampler = make_sampler(patterns, "uniform", seed=13)
        report = run_open_loop(svc, sampler, rate_hz=100_000.0, n_requests=10, validate=True,
                               timeout=60)
    assert report["rejected"] == 8
    assert report["errors"] == 0
    assert report["bitwise_mismatches"] == 0
    assert report["completed"] == 2


def test_worker_failure_propagates_to_tickets(mats):
    with _serving(max_batch=4, max_wait_us=1000) as svc:
        fp = svc.register(mats[0])
        vp = svc.pattern(fp)
        n = mats[0].n_rows
        boom = RuntimeError("synthetic backend failure")

        class _Exploding:
            def solve(self, B):
                raise boom

        real = vp._versions[vp.current]
        vp._versions[vp.current] = _Exploding()
        try:
            t = svc.submit(fp, np.ones(n))
            with pytest.raises(RuntimeError, match="synthetic backend"):
                t.result(timeout=60)
        finally:
            vp._versions[vp.current] = real
        x = svc.solve(fp, np.ones(n), timeout=60)
        assert x.shape == (n,)
        snap = svc.stats()
        assert snap["failed"] == 1 and snap["completed"] >= 1


# ---------------------------------------------- thread-safe telemetry
def test_latency_reservoir_threaded():
    """Percentiles read while 4 writers append past the window: no
    ``deque mutated during iteration``."""
    res = LatencyReservoir(cap=256)
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            res.add(i * 1e-6)
            i += 1

    def reader():
        while not stop.is_set():
            try:
                assert set(res.percentiles_us()) == {"p50", "p95", "p99", "p99.9"}
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=writer) for _ in range(4)] + [
        threading.Thread(target=reader) for _ in range(4)
    ]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(10)
    assert errors == []


@pytest.mark.parametrize("module,kind", [(sptrsv, "bank"), (sptrsv, "mrhs"), (spmv, "spmv")])
def test_launch_counters_count_exactly_under_threads(module, kind):
    """The serve layer launches from worker threads and the slot
    dispatcher at once; a launch's count is a read-modify-write under the
    module's lock, so 8 threads counting together lose nothing."""
    module.reset_launches()
    per_thread, n_threads = 20_000, 8
    start = threading.Barrier(n_threads)

    def count():
        start.wait(10)
        for _ in range(per_thread):
            module._count(kind)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
    try:
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert module.launches[kind] == per_thread * n_threads
    module.reset_launches()
    assert not any(module.launches.values())
