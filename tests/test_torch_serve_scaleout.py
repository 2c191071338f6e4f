"""Width-class grouping, banks and cross-pattern serving of the port, on the
CPU, held against the JAX package (``tests/test_serve_scaleout.py`` is the
reference; each of its cases is here on both port backends):

  * structurally identical patterns (one ``width_class``) coalesce into
    grouped dispatches, and every grouped result replays bitwise through
    its ticket's ``served_by`` at the recorded (width, position), across
    interleaved ``numeric_update``s;
  * ``grouped_solve``, ``GroupBank.solve`` and ``solve_resident`` are
    bitwise the JAX package's (rtol = atol = 0, value and dtype) on the
    same seeded inputs, f32 and f64, on the ``shifted_coupling_lower``
    family (n = 96, stride 8) and on clones of small ER / NB plans with
    distinct values; served results are bitwise JAX's ``direct_reference``
    at the same (width, position);
  * ``n_workers > 1``, ``close(timeout)`` keeping pins while a worker is
    alive, the metrics window, the pow2 width quantization.

Every threaded wait carries a timeout.
"""
import contextlib
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsparse
from repro.pipeline import GroupBank as JGroupBank
from repro.pipeline import TriangularSolver as JSolver
from repro.pipeline import grouped_solve as jgrouped_solve
from repro.serve import GroupReplay as JGroupReplay
from repro.serve import direct_reference as jdirect_reference
from repro_torch.pipeline import GroupBank, PlanCache, TriangularSolver, grouped_solve
from repro_torch.serve import (
    GroupReplay,
    ServeMetrics,
    SolveService,
    direct_reference,
    make_sampler,
    normalize_max_batch,
    pad_width,
    run_closed_loop,
    width_class_patterns,
)
from repro_torch.sparse import shifted_coupling_lower
from repro_torch.sparse.csr import csr_to_dense, pattern_fingerprint
from repro_torch.sparse.generators import erdos_renyi_lower, narrow_band_lower

STRATEGY = "wavefront"  # level scheduler: shift-invariant plan shapes
N = 96
BACKENDS = ("kernel", "scan")
_TDT = {"float32": torch.float32, "float64": torch.float64}
_JDT = {"float32": jnp.float32, "float64": jnp.float64}
_NDT = {"float32": np.float32, "float64": np.float64}


def _plan(m, backend="kernel", **kw):
    return TriangularSolver.plan(m, strategy=STRATEGY, device="cpu", backend=backend, **kw)


def _service(backend, **kw):
    return SolveService(strategy=STRATEGY, backend=backend, device="cpu", **kw)


@contextlib.contextmanager
def _serving(*args, **kw):
    """A service that closes with a timeout, and must close in it."""
    svc = _service(*args, **kw)
    try:
        yield svc
    finally:
        assert svc.close(timeout=60)["workers_alive"] == []


@contextlib.contextmanager
def _closing(svc):
    try:
        yield svc
    finally:
        assert svc.close(timeout=60)["workers_alive"] == []


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(jax_x, port_x):
    a = np.asarray(jax_x)
    b = port_x.numpy() if isinstance(port_x, torch.Tensor) else np.asarray(port_x)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{nd} of {a.size} entries differ"


@pytest.fixture(scope="module")
def family():
    return [shifted_coupling_lower(N, j, seed=40 + j) for j in range(4)]


@functools.lru_cache(maxsize=None)
def _family_solvers(backend):
    return tuple(_plan(shifted_coupling_lower(N, j, seed=40 + j), backend) for j in range(4))


@functools.lru_cache(maxsize=None)
def _pair_family(backend, dtype):
    """(JAX solvers, port solvers) of the family in ``dtype``."""
    with jax.enable_x64(dtype == "float64"):
        j = tuple(JSolver.plan(jsparse.shifted_coupling_lower(N, k, seed=40 + k),
                               strategy=STRATEGY, dtype=_JDT[dtype]) for k in range(4))
    t = tuple(_plan(shifted_coupling_lower(N, k, seed=40 + k), backend, dtype=_TDT[dtype])
              for k in range(4))
    return j, t


@functools.lru_cache(maxsize=None)
def _pair_clones(name, backend, dtype):
    """(JAX clones, port clones) of one small ER or NB plan with three
    distinct value sets: one width class, different values per lane."""
    if name == "er":
        jm, tm = jsparse.erdos_renyi_lower(300, 0.02, seed=5), erdos_renyi_lower(300, 0.02, seed=5)
    else:
        jm, tm = (jsparse.narrow_band_lower(300, 0.14, 10, seed=6),
                  narrow_band_lower(300, 0.14, 10, seed=6))
    rng = np.random.default_rng(7)
    datas = [tm.data * rng.uniform(0.5, 1.5, tm.nnz) for _ in range(3)]
    with jax.enable_x64(dtype == "float64"):
        j0 = JSolver.plan(jm, strategy="growlocal", dtype=_JDT[dtype])
        j = tuple(j0.clone_with_values(d) for d in datas)
    t0 = TriangularSolver.plan(tm, strategy="growlocal", device="cpu", backend=backend,
                               dtype=_TDT[dtype])
    t = tuple(t0.clone_with_values(d) for d in datas)
    return j, t


# ------------------------------------------------------ width-class identity
@pytest.mark.parametrize("backend", BACKENDS)
def test_family_is_distinct_patterns_one_width_class(family, backend):
    solvers = _family_solvers(backend)
    fps = {pattern_fingerprint(m) for m in family}
    assert len(fps) == len(family)  # structurally distinct...
    assert len({s.width_class for s in solvers}) == 1  # ...one class
    assert all(s.supports_grouping for s in solvers)


def test_width_class_separates_real_structural_differences():
    s0 = _family_solvers("kernel")[0]
    other = _plan(erdos_renyi_lower(N, 0.05, seed=77))
    assert other.width_class != s0.width_class
    # a different backend binding is a different class even on equal shapes
    assert _family_solvers("scan")[0].width_class != s0.width_class
    # and so is another dtype
    f64 = _plan(shifted_coupling_lower(N, 0, seed=40), dtype=torch.float64)
    assert f64.width_class != s0.width_class


def test_plan_cache_width_class_index(family):
    cache = PlanCache()
    solvers = [_plan(m, cache=cache) for m in family]
    for s in solvers:
        cache.note_width_class(s.width_class, s.plan_key)
    wc = solvers[0].width_class
    assert cache.width_class_members(wc) == frozenset(s.plan_key for s in solvers)
    assert cache.width_class_sizes()[wc] == len(family)
    cache.clear()
    assert cache.width_class_sizes() == {}


def test_plan_cache_width_class_index_bounded_by_eviction(family):
    """Index entries leave with their evicted plan."""
    cache = PlanCache(maxsize=1)
    for m in family:
        s = _plan(m, cache=cache)
        cache.note_width_class(s.width_class, s.plan_key)
    assert sum(cache.width_class_sizes().values()) == 1


# ------------------------------------------------- grouped-solve contracts
@pytest.mark.parametrize("backend", BACKENDS)
def test_grouped_solve_matches_per_solver_solves(family, backend):
    """Each grouped column solves ITS OWN system (dense float64 solve),
    and is bitwise that solver's own solve of the column."""
    solvers = _family_solvers(backend)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((N, len(solvers))).astype(np.float32)
    X = grouped_solve(solvers, B)
    assert X.shape == (N, len(solvers)) and X.dtype == torch.float32
    for j, (m, s) in enumerate(zip(family, solvers)):
        ref = np.linalg.solve(csr_to_dense(m).astype(np.float64), B[:, j].astype(np.float64))
        np.testing.assert_allclose(X[:, j].numpy(), ref, rtol=2e-4, atol=2e-5)
        assert torch.equal(X[:, j], s.solve(B[:, j]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_grouped_lane_independence_and_replay(backend):
    """At a fixed (width, position) a lane's bits depend only on its own
    (plan, b); replaying with the lane's own solver in every lane
    reproduces it."""
    solvers = _family_solvers(backend)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(N).astype(np.float32)
    w = len(solvers)
    for pos in (0, w - 1):
        fixed = None
        for trial in range(3):
            order = list(rng.permutation(w))
            group = [solvers[i] for i in order]
            group[pos] = solvers[0]
            B = rng.standard_normal((N, w)).astype(np.float32)
            B[:, pos] = b
            col = grouped_solve(group, B)[:, pos].numpy()
            if fixed is None:
                fixed = col
            assert np.array_equal(col, fixed), (pos, trial)
        replay = direct_reference(GroupReplay(solvers[0]), b, w, pos)
        assert np.array_equal(replay, fixed)


@pytest.mark.parametrize("backend", BACKENDS)
def test_group_bank_bitwise_matches_grouped_solve(backend):
    """The bank (stacked once) is bitwise the stack-per-call
    ``grouped_solve``, across compositions and bank sizes (pow2 lane
    padding: 4 members, then 2 after churn)."""
    solvers = _family_solvers(backend)
    rng = np.random.default_rng(4)
    bank = GroupBank()
    for i, s in enumerate(solvers):
        bank.add(i, s)
    assert len(bank) == len(solvers)
    for comp in ([0, 1, 2, 3], [3, 3, 0, 2], [1, 0, 1, 0]):
        B = rng.standard_normal((N, len(comp))).astype(np.float32)
        got = bank.solve(comp, B)
        ref = grouped_solve([solvers[i] for i in comp], B)
        assert torch.equal(got, ref), comp
    rebuilds = bank.rebuilds
    bank.drop(3)
    bank.prune(lambda k: k != 2)
    assert len(bank) == 2
    B = rng.standard_normal((N, 2)).astype(np.float32)
    assert torch.equal(bank.solve([0, 1], B), grouped_solve(list(solvers[:2]), B))
    assert bank.rebuilds == rebuilds + 1
    assert bank.describe() == {"n_lanes": 2, "rebuilds": bank.rebuilds}


@pytest.mark.parametrize("backend", BACKENDS)
def test_group_bank_rejects_wrong_members(backend):
    bank = GroupBank()
    bank.add("a", _family_solvers(backend)[0])
    other = _plan(erdos_renyi_lower(N, 0.05, seed=79), backend)
    with pytest.raises(ValueError, match="one width class"):
        bank.add("b", other)
    # an elastic bound has no grouped twin, as in the JAX package
    elastic = _plan(shifted_coupling_lower(N, 0, seed=40), backend, mode="elastic")
    assert not elastic.supports_grouping and not elastic.bound.supports_grouped
    with pytest.raises(NotImplementedError, match="grouped"):
        bank.add("c", elastic)
    with pytest.raises(NotImplementedError, match="grouped"):
        type(elastic.bound).solve_bank(None, [0], np.zeros((N, 1)))


def test_grouped_solve_rejects_mixed_classes_and_bad_shapes():
    solvers = _family_solvers("kernel")
    other = _plan(erdos_renyi_lower(N, 0.05, seed=78))
    with pytest.raises(ValueError, match="one width class"):
        grouped_solve([solvers[0], other], np.zeros((N, 2)))
    with pytest.raises(ValueError, match="one column per solver"):
        grouped_solve(list(solvers[:2]), np.zeros((N, 3)))
    with pytest.raises(ValueError, match="at least one"):
        grouped_solve([], np.zeros((N, 0)))


# ----------------------------------------------- bitwise against the JAX package
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_grouped_bank_resident_bitwise_jax_family(backend, dtype):
    jsolvers, tsolvers = _pair_family(backend, dtype)
    rng = np.random.default_rng(11)
    B = rng.standard_normal((N, 4)).astype(_NDT[dtype])
    comp = [3, 3, 0, 2, 1, 0, 1, 2]
    B8 = rng.standard_normal((N, 8)).astype(_NDT[dtype])
    jbank, tbank = JGroupBank(), GroupBank()
    for i in range(4):
        jbank.add(i, jsolvers[i])
        tbank.add(i, tsolvers[i])
    cls = type(tsolvers[0].bound)
    R = cls.blank_rhs(N, 8, _TDT[dtype], torch.device("cpu"))
    for j in range(8):
        R = cls.insert_lane(R, j, B8[:, j])
    with jax.enable_x64(dtype == "float64"):
        _assert_bitwise(jgrouped_solve(list(jsolvers), B), grouped_solve(list(tsolvers), B))
        jx = jbank.solve(comp, B8)
        _assert_bitwise(jx, tbank.solve(comp, B8))
        # a pow2 prefix of the resident bank: JAX's solve_resident on the
        # same columns (its insert_lane refuses float64 banks: an int32
        # lane index beside int64 zeros under x64)
        JR = jnp.asarray(B8)
        _assert_bitwise(jbank.solve_resident(comp[:4], JR), tbank.solve_resident(comp[:4], R))
        _assert_bitwise(np.asarray(jx)[:, :4], tbank.solve_resident(comp[:4], R))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["er", "nb"])
def test_grouped_clones_bitwise_jax(name, backend, dtype):
    """Clones of one ER / NB plan with distinct values: one width class,
    each lane its own values."""
    jsolvers, tsolvers = _pair_clones(name, backend, dtype)
    assert len({s.width_class for s in tsolvers}) == 1
    n = tsolvers[0].n
    rng = np.random.default_rng(12)
    B = rng.standard_normal((n, 3)).astype(_NDT[dtype])
    comp = [2, 0, 1, 1]
    B4 = rng.standard_normal((n, 4)).astype(_NDT[dtype])
    jbank, tbank = JGroupBank(), GroupBank()
    for i in range(3):
        jbank.add(i, jsolvers[i])
        tbank.add(i, tsolvers[i])
    cls = type(tsolvers[0].bound)
    R = cls.blank_rhs(n, 4, _TDT[dtype], torch.device("cpu"))
    for j in range(4):
        R = cls.insert_lane(R, j, B4[:, j])
    with jax.enable_x64(dtype == "float64"):
        _assert_bitwise(jgrouped_solve(list(jsolvers), B), grouped_solve(list(tsolvers), B))
        jx = jbank.solve(comp, B4)
        _assert_bitwise(jx, tbank.solve(comp, B4))
        _assert_bitwise(jx, tbank.solve_resident(comp, R))
    # every lane used its own values: no two columns of equal b agree
    same = np.repeat(B4[:, :1], 3, axis=1)
    X = tbank.solve([0, 1, 2], same).numpy()
    assert not np.array_equal(X[:, 0], X[:, 1]) and not np.array_equal(X[:, 1], X[:, 2])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_width_class_served_bitwise_jax_across_update(backend, dtype):
    """Width-class serving: requests pinned to v0 and v1 of one pattern
    plus another pattern ride one grouped dispatch; each is bitwise JAX's
    ``direct_reference`` (its GroupReplay) at the same (width, position)
    on the same values."""
    m0 = shifted_coupling_lower(N, 0, seed=60)
    m1 = shifted_coupling_lower(N, 1, seed=61)
    new = m0.data * 2.0
    with jax.enable_x64(dtype == "float64"):
        j0 = JSolver.plan(jsparse.shifted_coupling_lower(N, 0, seed=60), strategy=STRATEGY,
                          dtype=_JDT[dtype])
        j1 = JSolver.plan(jsparse.shifted_coupling_lower(N, 1, seed=61), strategy=STRATEGY,
                          dtype=_JDT[dtype])
        jref = {(0, 0): j0, (0, 1): j0.clone_with_values(new), (1, 0): j1}
    rng = np.random.default_rng(3)
    with _serving(backend, max_batch=8, max_wait_us=400_000, width_class_batching=True,
                  dtype=_TDT[dtype]) as svc:
        fp0, fp1 = svc.register(m0), svc.register(m1)
        which = {fp0: 0, fp1: 1}
        admitted = []
        b = rng.standard_normal(N).astype(_NDT[dtype])
        admitted.append((svc.submit(fp0, b), b))
        svc.numeric_update(fp0, new)  # the queued request stays v0
        for fp in (fp0, fp1):
            b = rng.standard_normal(N).astype(_NDT[dtype])
            admitted.append((svc.submit(fp, b), b))
        results = [(t, b, t.result(timeout=60)) for t, b in admitted]
    assert [t.version for t, _, _ in results] == [0, 1, 0]
    assert {t.batch_width for t, _, _ in results} == {4}
    with jax.enable_x64(dtype == "float64"):
        for t, b, x in results:
            assert isinstance(t.served_by, GroupReplay)
            js = jref[(which[t.fingerprint], t.version)]
            _assert_bitwise(jdirect_reference(JGroupReplay(js), b, t.batch_width,
                                              t.batch_position), x)


# ------------------------------------------------ service: width-class mode
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_coalesces_across_patterns_bitwise(backend):
    with _serving(backend, max_batch=8, max_wait_us=300_000,
                  width_class_batching=True) as svc:
        pats = width_class_patterns(svc, 4, n=N, seed=50)
        rng = np.random.default_rng(2)
        tickets = []
        for i in range(8):
            fp, n = pats[i % len(pats)]
            b = rng.standard_normal(n).astype(np.float32)
            tickets.append((svc.submit(fp, b), b))
        for t, b in tickets:
            x = t.result(timeout=60)
            assert isinstance(t.served_by, GroupReplay)
            assert np.array_equal(
                x, direct_reference(t.served_by, b, t.batch_width, t.batch_position))
        snap = svc.stats()
    assert snap["grouped_batches"] >= 1
    assert snap["batches"] < len(tickets)
    assert snap["completed"] == len(tickets) and snap["failed"] == 0
    wcs = snap["width_classes"]
    assert len(wcs) == 1 and next(iter(wcs.values()))["n_patterns"] == 4
    for fp, _ in pats:
        assert snap["patterns"][fp]["width_class"] in wcs


@pytest.mark.parametrize("backend", BACKENDS)
def test_width_class_batching_with_interleaved_updates(backend):
    m0 = shifted_coupling_lower(N, 0, seed=60)
    m1 = shifted_coupling_lower(N, 1, seed=61)
    rng = np.random.default_rng(3)
    with _serving(backend, max_batch=8, max_wait_us=400_000,
                  width_class_batching=True) as svc:
        fp0, fp1 = svc.register(m0), svc.register(m1)
        admitted = []
        b = rng.standard_normal(N).astype(np.float32)
        admitted.append((svc.submit(fp0, b), b))
        svc.numeric_update(fp0, m0.data * 2.0)  # queued request stays v0
        b2 = rng.standard_normal(N).astype(np.float32)
        admitted.append((svc.submit(fp0, b2), b2))  # pinned v1
        b3 = rng.standard_normal(N).astype(np.float32)
        admitted.append((svc.submit(fp1, b3), b3))
        results = [(t, b, t.result(timeout=60)) for t, b in admitted]
    assert [t.version for t, _, _ in results] == [0, 1, 0]
    for t, b, x in results:
        assert np.array_equal(
            x, direct_reference(t.served_by, b, t.batch_width, t.batch_position)
        ), f"version {t.version} served with wrong values"
    widths = {t.batch_width for t, _, _ in results}
    positions = [t.batch_position for t, _, _ in results]
    assert widths == {4} and sorted(positions) == [0, 1, 2]


@pytest.mark.parametrize("backend", BACKENDS)
def test_homogeneous_groups_keep_the_plain_path(backend):
    m = shifted_coupling_lower(N, 2, seed=62)
    with _serving(backend, max_batch=8, max_wait_us=200_000,
                  width_class_batching=True) as svc:
        fp = svc.register(m)
        tickets = [svc.submit(fp, np.ones(N, np.float32)) for _ in range(3)]
        for t in tickets:
            t.result(timeout=60)
        solver = svc.pattern(fp).solver_for(0)
        for t in tickets:
            assert t.served_by is solver  # plain path, not a GroupReplay
        assert svc.stats()["grouped_batches"] == 0


# --------------------------------------------------- multi-worker serving
def test_multi_worker_multi_route_bitwise_with_updates():
    mats = [
        erdos_renyi_lower(120, 0.03, seed=81),
        erdos_renyi_lower(160, 0.02, seed=82),
        erdos_renyi_lower(200, 0.02, seed=83),
    ]
    with _closing(SolveService(max_batch=4, max_wait_us=2000, n_workers=3, strategy="growlocal",
                      device="cpu")) as svc:
        assert svc.n_workers == 3
        fps = [svc.register(m) for m in mats]
        ns = {fp: m.n_rows for fp, m in zip(fps, mats)}
        data = {fp: m.data for fp, m in zip(fps, mats)}
        n_clients, per_client = 6, 8
        out = [[] for _ in range(n_clients)]
        stop = threading.Event()

        def client(ci):
            rng = np.random.default_rng(300 + ci)
            for j in range(per_client):
                fp = fps[(ci + j) % len(fps)]
                b = rng.standard_normal(ns[fp]).astype(np.float32)
                t = svc.submit(fp, b)
                out[ci].append((t, b, t.result(timeout=60)))

        def updater():
            k = 0
            while not stop.is_set():
                fp = fps[k % len(fps)]
                svc.numeric_update(fp, data[fp] * (1.0 + 0.1 * (k + 1)))
                k += 1
                stop.wait(0.002)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        up = threading.Thread(target=updater, daemon=True)
        for t in threads:
            t.start()
        up.start()
        for t in threads:
            t.join(120)
        stop.set()
        up.join(5)
        served = [s for c in out for s in c]
        assert len(served) == n_clients * per_client
        for ticket, b, x in served:
            assert np.array_equal(
                x, direct_reference(ticket.served_by, b, ticket.batch_width,
                                    ticket.batch_position)
            ), (ticket.fingerprint[:8], ticket.version)
        snap = svc.stats()
    assert snap["serving"]["n_workers"] == 3
    assert snap["completed"] == len(served) and snap["failed"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_worker_width_class_loadgen(backend):
    with _serving(backend, max_batch=8, max_wait_us=2000, n_workers=2,
                  width_class_batching=True) as svc:
        pats = width_class_patterns(svc, 4, n=N, seed=70)
        sampler = make_sampler(pats, "uniform", seed=7)
        report = run_closed_loop(svc, sampler, n_clients=6, requests_per_client=5,
                                 validate=True, timeout=60)
    assert report["errors"] == 0
    assert report["bitwise_mismatches"] == 0
    assert report["requests"] == 30


# ------------------------------------------------------- lifecycle hardening
def test_close_timeout_retains_pins_until_workers_exit():
    m = erdos_renyi_lower(100, 0.03, seed=90)
    cache = PlanCache(maxsize=1)
    svc = SolveService(max_batch=2, max_wait_us=1000, cache=cache, strategy="growlocal",
                       device="cpu")
    fp = svc.register(m)
    vp = svc.pattern(fp)
    release = threading.Event()
    picked = threading.Event()
    real = vp.solver_for(0)

    class _Stall:
        def solve(self, B):
            picked.set()
            release.wait(30)
            return real.solve(B)

    vp._versions[0] = _Stall()
    t = svc.submit(fp, np.ones(100, np.float32))
    assert picked.wait(10)
    report = svc.close(timeout=0.2)
    assert report["workers_alive"], "worker should still be stalled"
    assert report["pins_released"] == 0 and report["pins_retained"] == 1
    assert len(cache.pinned) == 1
    release.set()
    t.result(timeout=60)
    report2 = svc.close(timeout=30)
    assert report2["workers_alive"] == []
    assert report2["pins_released"] == 1 and report2["pins_retained"] == 0
    assert len(cache.pinned) == 0


def test_close_clean_reports_released_pins():
    svc = SolveService(strategy="growlocal", device="cpu")
    svc.register(erdos_renyi_lower(80, 0.03, seed=91))
    report = svc.close(timeout=30)
    assert report == {"workers_alive": [], "pins_released": 1, "pins_retained": 0}
    assert svc.close(timeout=30)["pins_released"] == 0  # idempotent


# ----------------------------------------------------- metrics window
def test_throughput_window_anchors_on_first_completion():
    ms = ServeMetrics()
    ms.record_submit("fp")
    ms.record_batch("fp", 2, queue_waits=[0.0], e2e=[0.0], solve_seconds=0.0)
    ms.reset()
    ms.record_batch("fp", 4, queue_waits=[0.0], e2e=[0.0], solve_seconds=0.0)
    time.sleep(0.01)
    ms.record_batch("fp", 4, queue_waits=[0.0], e2e=[0.0], solve_seconds=0.0)
    snap = ms.snapshot()
    assert snap["completed"] == 8
    assert snap["elapsed_seconds"] > 0
    assert snap["solves_per_sec"] > 0


def test_failures_also_anchor_the_window():
    ms = ServeMetrics()
    ms.record_failure("fp", 1)
    time.sleep(0.01)
    ms.record_batch("fp", 2, queue_waits=[0.0], e2e=[0.0], solve_seconds=0.0)
    snap = ms.snapshot()
    assert snap["elapsed_seconds"] > 0 and snap["solves_per_sec"] > 0


def test_grouped_batch_metrics_attribution():
    ms = ServeMetrics()
    for fp in ("a", "a", "b"):
        ms.record_submit(fp)
    ms.record_grouped_batch(["a", "a", "b"], queue_waits=[0.001] * 3, e2e=[0.002] * 3,
                            solve_seconds=0.001)
    snap = ms.snapshot()
    assert snap["grouped_batches"] == 1 and snap["batches"] == 1
    assert snap["completed"] == 3 and snap["mean_batch_size"] == 3.0
    assert snap["per_pattern"]["a"]["completed"] == 2
    assert snap["per_pattern"]["b"]["completed"] == 1
    assert snap["per_pattern"]["a"]["batches"] == 0
    assert snap["grouped_batch_size_hist"] == {3: 1}


# ------------------------------------------------- pow2 width quantization
def test_normalize_max_batch():
    assert [normalize_max_batch(x) for x in (1, 2, 3, 15, 16, 24, 33)] == [
        1, 2, 2, 8, 16, 16, 32,
    ]
    with pytest.raises(ValueError, match="max_batch"):
        normalize_max_batch(0)


def test_pad_width_never_dispatches_non_pow2():
    for mb in (1, 2, 3, 8, 12, 24, 64):
        for m in range(1, mb + 1):
            w = pad_width(m, mb)
            assert w & (w - 1) == 0, (m, mb, w)
            assert w <= normalize_max_batch(mb)


def test_service_normalizes_max_batch():
    with _closing(SolveService(max_batch=24, strategy="growlocal", device="cpu")) as svc:
        assert svc.max_batch == 16
        assert svc._batcher.max_batch == 16
        assert svc.stats()["serving"]["max_batch"] == 16
