"""``repro_torch.serve.slots`` — the continuous-batching engine of the port,
on the CPU, held against the JAX package (``tests/test_serve_slots.py`` is
the reference; its cases are here on both port backends where the backend
matters):

  * ``SlotState`` keeps its invariants under admit/release/evict
    sequences (unit cases and deterministic fuzz walks), and every
    admitted token terminates exactly once;
  * the resident ops move bits unchanged: ``insert_lane`` /
    ``extract_lane`` round-trip, ``insert_lane`` leaves its input alone,
    ``solve_resident`` is bitwise ``solve_bank`` on the same lanes, and a
    neighbour's insert never moves an occupied lane's bits;
  * ``mode="continuous"`` serves bitwise end to end — across
    ``numeric_update``s, slot overflow, shutdown and back-pressure — and
    each served result is bitwise JAX's ``direct_reference`` (its
    ``GroupReplay``) at the same (width, lane) on the same values, f32
    and f64;
  * non-groupable (elastic) patterns fall back to the microbatch path.

Every threaded wait carries a timeout.
"""
import contextlib
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsparse
from repro.pipeline import TriangularSolver as JSolver
from repro.serve import GroupReplay as JGroupReplay
from repro.serve import direct_reference as jdirect_reference
from repro_torch.backends import Backend, register_backend, unregister_backend
from repro_torch.pipeline import GroupBank, TriangularSolver
from repro_torch.serve import (
    AdmissionQueue,
    QueueFullError,
    SlotDispatcher,
    SlotEngine,
    SlotState,
    SlotsFull,
    SolveService,
    direct_reference,
)
from repro_torch.serve.service import SolveTicket
from repro_torch.sparse import shifted_coupling_lower
from repro_torch.sparse.generators import erdos_renyi_lower

STRATEGY = "wavefront"  # level scheduler: shift-invariant plan shapes
N = 96
BACKENDS = ("kernel", "scan")
CPU = torch.device("cpu")


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


@contextlib.contextmanager
def _closing(svc):
    try:
        yield svc
    finally:
        assert svc.close(timeout=60)["workers_alive"] == []


@pytest.fixture(scope="module")
def family():
    return [shifted_coupling_lower(N, j, seed=70 + j) for j in range(3)]


@functools.lru_cache(maxsize=None)
def _family_solvers(backend):
    return tuple(
        TriangularSolver.plan(shifted_coupling_lower(N, j, seed=70 + j), strategy=STRATEGY,
                              device="cpu", backend=backend)
        for j in range(3)
    )


def rhs(n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------- SlotState: units
def test_slotstate_allocates_lowest_lane_first():
    s = SlotState(4)
    assert [s.admit(f"t{i}") for i in range(4)] == [0, 1, 2, 3]
    s.check()
    assert s.release(1) == "t1"
    assert s.release(2) == "t2"
    assert s.admit("t4") == 2
    assert s.admit("t5") == 1
    s.check()


def test_slotstate_books_and_lookup():
    s = SlotState(2)
    s.admit("a")
    s.admit("b")
    assert s.occupancy == 2 and s.free_count == 0
    assert s.lane_of("b") == 1 and s.lane_of("nope") is None
    assert s.occupants() == {0: "a", 1: "b"}
    s.release(0)
    s.evict(1)
    assert (s.admitted, s.completed, s.evicted) == (2, 1, 1)
    s.check()


def test_slotstate_rejects_double_occupancy():
    s = SlotState(2)
    s.admit("a")
    with pytest.raises(ValueError):
        s.admit("a")
    s.admit("b")
    with pytest.raises(SlotsFull):
        s.admit("c")
    s.check()


def test_slotstate_rejects_freeing_a_free_lane():
    s = SlotState(2)
    s.admit("a")
    with pytest.raises(ValueError):
        s.release(1)
    with pytest.raises(ValueError):
        s.evict(5)
    s.release(0)
    with pytest.raises(ValueError):
        s.release(0)
    s.check()


def test_slotstate_rejects_bad_sizes():
    with pytest.raises(ValueError):
        SlotState(0)


def _walk(state, ops):
    """Drive ``state`` through (op, token) steps against a model dict,
    auditing every invariant after every step."""
    live = {}
    done = []
    for op, token in ops:
        if op == "admit":
            if token in live:
                with pytest.raises(ValueError):
                    state.admit(token)
            elif len(live) == state.n_slots:
                with pytest.raises(SlotsFull):
                    state.admit(token)
            else:
                live[token] = state.admit(token)
        elif live:
            lane = live[sorted(live)[int(token[1:]) % len(live)]]
            got = state.release(lane) if op == "release" else state.evict(lane)
            assert live.pop(got) == lane
            done.append(got)
        state.check()
        assert state.occupancy == len(live)
        assert state.occupants() == {v: k for k, v in live.items()}
    assert len(done) == state.completed + state.evicted
    assert state.admitted == state.completed + state.evicted + len(live)


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("n_slots", [1, 2, 4, 8])
def test_slotstate_fuzz_walk_deterministic(n_slots, seed):
    rng = np.random.default_rng(seed)
    ops = [
        (("admit", "release", "evict")[rng.integers(3)], f"t{rng.integers(n_slots * 2)}")
        for _ in range(600)
    ]
    _walk(SlotState(n_slots), ops)


# --------------------------------------------------------- AdmissionQueue
def test_admission_queue_fifo_close_and_drain():
    q = AdmissionQueue()
    for i in range(5):
        q.put(i)
    assert q.depth() == 5
    assert q.take(2) == [0, 1]
    assert q.drain() == [2, 3, 4]
    q.put(5)
    q.mark_pending(3)
    assert q.depth() == 4
    q.mark_pending(0)
    q.close()
    with pytest.raises(RuntimeError):
        q.put(6)
    assert q.take(10) == [5]
    assert q.take(10) == []


def test_admission_queue_take_blocks_until_put():
    q = AdmissionQueue()
    got = []
    ready = threading.Event()

    def consumer():
        ready.set()
        got.extend(q.take(4))

    t = threading.Thread(target=consumer)
    t.start()
    ready.wait(5)
    q.put("x")
    t.join(5)
    assert got == ["x"]


# -------------------------------------- resident ops: bitwise + lane purity
@pytest.mark.parametrize("backend", BACKENDS)
def test_resident_ops_roundtrip_and_purity(backend):
    s = _family_solvers(backend)[0]
    cls = type(s._bound)
    B0 = cls.blank_rhs(s.n, 4, torch.float32, CPU)
    b0, b1 = rhs(s.n, 1), rhs(s.n, 2)
    B1 = cls.insert_lane(B0, 0, b0)
    B2 = cls.insert_lane(B1, 2, b1)
    assert cls.extract_lane(B2, 0).numpy().tobytes() == b0.tobytes()
    assert cls.extract_lane(B2, 2).numpy().tobytes() == b1.tobytes()
    # insert is pure: the input bank kept its bits
    zeros = np.zeros(s.n, np.float32).tobytes()
    assert cls.extract_lane(B0, 0).numpy().tobytes() == zeros
    assert cls.extract_lane(B1, 2).numpy().tobytes() == zeros


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_resident_matches_solve_bank_bitwise(backend):
    solvers = _family_solvers(backend)
    bank = GroupBank()
    for i, s in enumerate(solvers):
        bank.add(i, s)
    cls = type(solvers[0]._bound)
    n = solvers[0].n
    cols = [rhs(n, 10 + j) for j in range(4)]
    lane_keys = [0, 1, 2, 0]
    B = cls.blank_rhs(n, 4, torch.float32, CPU)
    for j, c in enumerate(cols):
        B = cls.insert_lane(B, j, c)
    X_res = bank.solve_resident(lane_keys, B).numpy()
    X_bank = bank.solve(lane_keys, np.stack(cols, axis=1)).numpy()
    assert X_res.tobytes() == X_bank.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_neighbor_insert_never_perturbs_occupied_lane(backend):
    solvers = _family_solvers(backend)
    bank = GroupBank()
    for i, s in enumerate(solvers):
        bank.add(i, s)
    cls = type(solvers[0]._bound)
    n = solvers[0].n
    B = cls.insert_lane(cls.blank_rhs(n, 4, torch.float32, CPU), 0, rhs(n, 42))
    lane_keys = [0, 1, 2, 1]
    want = cls.extract_lane(bank.solve_resident(lane_keys, B), 0).numpy().tobytes()
    for round_ in range(3):
        for j in (1, 2, 3):
            B = cls.insert_lane(B, j, rhs(n, 100 + 10 * round_ + j))
        got = cls.extract_lane(bank.solve_resident(lane_keys, B), 0).numpy().tobytes()
        assert got == want


# ----------------------------------------------------- engine-level units
def test_engine_normalizes_slots_to_pow2():
    assert SlotEngine(n_slots=5).n_slots == 8
    assert SlotEngine(n_slots=8).n_slots == 8
    assert SlotEngine(n_slots=1).n_slots == 1
    with pytest.raises(ValueError):
        SlotEngine(n_slots=0)


def test_ticket_double_fulfill_guard():
    t = SolveTicket("ab" * 32, 0)
    t._fulfill(np.zeros(3))
    with pytest.raises(RuntimeError):
        t._fulfill(np.ones(3))


# ------------------------------------------------ continuous service path
@pytest.fixture(params=BACKENDS)
def cont_service(request):
    svc = _service(request.param, mode="continuous", max_batch=4)
    yield svc
    svc.close(timeout=60)


class _NoSlotsBackend(Backend):
    """A registry entry without the ``"slots"`` capability."""

    name = "test-no-slots"

    def bind(self, exec_plan, *, dtype=torch.float32, device=None, slack=0):
        raise NotImplementedError

    def capabilities(self):
        return ("elastic",)


def test_continuous_requires_slots_capability():
    register_backend(_NoSlotsBackend)
    try:
        with pytest.raises(ValueError, match="slots"):
            SolveService(mode="continuous", backend="test-no-slots", device="cpu")
    finally:
        unregister_backend("test-no-slots")


def test_continuous_defaults_to_the_port_backend():
    """Without ``backend=`` the service reads the port's own default
    (``kernel``), so continuous mode banks the kernel bound."""
    with _closing(SolveService(mode="continuous", strategy=STRATEGY, device="cpu")) as svc:
        fp = svc.register(shifted_coupling_lower(N, 0, seed=70))
        assert svc.pattern(fp).current_solver().backend == "kernel"
        svc.solve(fp, rhs(N, 1), timeout=60)
        eng = next(iter(svc._engines.values()))
        assert eng._cls.__name__ == "KernelBoundSolve"


def test_continuous_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        SolveService(mode="batch", device="cpu")


def test_continuous_served_equals_direct_bitwise(cont_service, family):
    svc = cont_service
    fps = [svc.register(m) for m in family]
    tickets = []
    for i in range(24):
        fp = fps[i % len(fps)]
        b = rhs(N, 300 + i)
        tickets.append((svc.submit(fp, b), b))
    for ticket, b in tickets:
        x = ticket.result(timeout=60)
        want = direct_reference(ticket.served_by, b, ticket.batch_width, ticket.batch_position)
        assert x.tobytes() == want.tobytes()
    st_ = svc.stats()
    assert st_["serving"]["mode"] == "continuous"
    assert st_["slots"]["passes"] >= 1
    assert sum(occ * cnt for occ, cnt in st_["slots"]["occupancy_hist"].items()) == len(tickets)


def test_continuous_numeric_update_serves_admitted_version(cont_service, family):
    svc = cont_service
    m = family[0]
    fp = svc.register(m)
    b = rhs(N, 50)
    x_v0 = svc.submit(fp, b).result(timeout=60)
    assert svc.numeric_update(fp, m.data * 3.0) == 1
    t1 = svc.submit(fp, b)
    x_v1 = t1.result(timeout=60)
    want = direct_reference(t1.served_by, b, t1.batch_width, t1.batch_position)
    assert x_v1.tobytes() == want.tobytes()
    assert not np.array_equal(x_v0, x_v1)
    assert svc.pattern(fp).wait_retired(0, timeout=30)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_continuous_served_bitwise_jax_across_update(backend, dtype):
    """Every continuous-mode result is bitwise JAX's ``direct_reference``
    through its ``GroupReplay`` at the same (pass width, lane), on the
    same values, before and after a ``numeric_update``."""
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    jdt = {"float32": jnp.float32, "float64": jnp.float64}[dtype]
    ndt = {"float32": np.float32, "float64": np.float64}[dtype]
    mats = [shifted_coupling_lower(N, j, seed=70 + j) for j in range(3)]
    new = mats[0].data * 3.0
    with jax.enable_x64(dtype == "float64"):
        js = [JSolver.plan(jsparse.shifted_coupling_lower(N, j, seed=70 + j), strategy=STRATEGY,
                           dtype=jdt) for j in range(3)]
        jref = {(j, 0): js[j] for j in range(3)}
        jref[(0, 1)] = js[0].clone_with_values(new)
    served = []
    with _serving(backend, mode="continuous", max_batch=8, dtype=tdt) as svc:
        fps = [svc.register(m) for m in mats]
        which = {fp: j for j, fp in enumerate(fps)}
        for burst in range(2):
            tickets = []
            for i in range(9):
                b = rhs(N, 700 + 10 * burst + i, ndt)
                tickets.append((svc.submit(fps[i % 3], b), b))
            served += [(t, b, t.result(timeout=60)) for t, b in tickets]
            if burst == 0:
                svc.numeric_update(fps[0], new)
    assert {(which[t.fingerprint], t.version) for t, _, _ in served} == set(jref)
    with jax.enable_x64(dtype == "float64"):
        for t, b, x in served:
            js_ = jref[(which[t.fingerprint], t.version)]
            want = np.asarray(jdirect_reference(JGroupReplay(js_), b, t.batch_width,
                                                t.batch_position))
            assert _same_bits(x, want), (which[t.fingerprint], t.version, t.batch_position)


def test_continuous_overflow_resolves_by_extra_passes(family):
    svc = _service(mode="continuous", n_slots=2)
    try:
        fp = svc.register(family[0])
        svc.prewarm()
        bs = [rhs(N, 400 + i) for i in range(9)]
        tickets = [svc.submit(fp, b) for b in bs]
        for ticket, b in zip(tickets, bs):
            x = ticket.result(timeout=60)
            want = direct_reference(ticket.served_by, b, ticket.batch_width,
                                    ticket.batch_position)
            assert x.tobytes() == want.tobytes()
            assert ticket.batch_position < 2
        d = next(iter(svc._engines.values())).describe()
        assert d["n_slots"] == 2
        assert d["admitted"] == d["completed"] == len(bs)
        assert d["passes"] >= (len(bs) + 1) // 2
    finally:
        svc.close(timeout=60)


def test_continuous_backpressure_rejects_beyond_max_queue(family, monkeypatch):
    release = threading.Event()
    orig = SlotEngine._run_pass

    def stalled(self, reqs):
        release.wait(30)
        orig(self, reqs)

    monkeypatch.setattr(SlotEngine, "_run_pass", stalled)
    svc = _service(mode="continuous", max_queue=3)
    try:
        fp = svc.register(family[0])
        tickets = [svc.submit(fp, rhs(N, 500 + i)) for i in range(8)]
        release.set()
        outcomes = []
        for t in tickets:
            try:
                t.result(timeout=60)
                outcomes.append("ok")
            except QueueFullError:
                outcomes.append("rejected")
        assert "rejected" in outcomes
        assert "ok" in outcomes
        assert svc.stats()["rejected"] == outcomes.count("rejected")
    finally:
        release.set()
        svc.close(timeout=60)


def test_continuous_close_drains_without_stranding(family):
    svc = _service(mode="continuous")
    fp = svc.register(family[0])
    svc.prewarm()
    bs = [rhs(N, 600 + i) for i in range(12)]
    tickets = [svc.submit(fp, b) for b in bs]
    report = svc.close(timeout=60)
    assert report["workers_alive"] == []
    assert report["pins_retained"] == 0
    for ticket, b in zip(tickets, bs):
        x = ticket.result(timeout=1)
        want = direct_reference(ticket.served_by, b, ticket.batch_width, ticket.batch_position)
        assert x.tobytes() == want.tobytes()
    with pytest.raises(RuntimeError):
        svc.submit(fp, bs[0])


def test_continuous_concurrent_clients_bitwise(cont_service, family):
    svc = cont_service
    fps = [svc.register(m) for m in family]
    svc.prewarm()
    failures = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for i in range(6):
            fp = fps[int(rng.integers(len(fps)))]
            b = rng.standard_normal(N).astype(np.float32)
            t = svc.submit(fp, b)
            x = t.result(timeout=60)
            want = direct_reference(t.served_by, b, t.batch_width, t.batch_position)
            if x.tobytes() != want.tobytes():
                failures.append((seed, i))

    threads = [threading.Thread(target=client, args=(900 + k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert failures == []


# ------------------------------------------------- fallback + degradation
@pytest.mark.parametrize("backend", BACKENDS)
def test_continuous_elastic_pattern_falls_back_to_microbatch(backend):
    svc = _service(backend, mode="continuous")
    try:
        m = erdos_renyi_lower(140, 0.03, seed=77)
        fp = svc.register(m, strategy="growlocal", mode="elastic")
        assert not svc.pattern(fp).groupable
        b = rhs(140, 7)
        t = svc.submit(fp, b)
        x = t.result(timeout=60)
        want = direct_reference(t.served_by, b, t.batch_width, t.batch_position)
        assert x.tobytes() == want.tobytes()
        assert svc._engines == {}  # served by the worker path, no lanes
        assert svc.stats()["batches"] == 1 and svc.stats()["slots"]["passes"] == 0
    finally:
        svc.close(timeout=60)


def test_width_class_batching_elastic_pattern_falls_back_plain(family):
    svc = _service(width_class_batching=True)
    try:
        fp_grp = svc.register(family[0])
        m = erdos_renyi_lower(140, 0.03, seed=78)
        fp_el = svc.register(m, strategy="growlocal", mode="elastic")
        assert svc.pattern(fp_grp).groupable
        assert not svc.pattern(fp_el).groupable
        pairs = []
        for i in range(6):
            fp, n = (fp_grp, N) if i % 2 else (fp_el, 140)
            b = rhs(n, 800 + i)
            pairs.append((svc.submit(fp, b), b))
        for t, b in pairs:
            x = t.result(timeout=60)
            want = direct_reference(t.served_by, b, t.batch_width, t.batch_position)
            assert x.tobytes() == want.tobytes()
    finally:
        svc.close(timeout=60)


def test_continuous_mode_pins_auto_selection_to_bsp():
    svc = SolveService(mode="continuous", device="cpu")
    try:
        fp = svc.register(erdos_renyi_lower(150, 0.02, seed=79))
        assert svc.pattern(fp).groupable
    finally:
        svc.close(timeout=60)


# ----------------------------------------------------- dispatcher details
def test_dispatcher_close_is_idempotent_and_rejects_submits():
    d = SlotDispatcher(name="t")
    eng = SlotEngine(n_slots=2)
    assert d.alive()
    assert d.close(timeout=10)
    assert not d.alive()
    assert d.close(timeout=10)
    with pytest.raises(RuntimeError):
        d.submit(eng, SolveTicket("cd" * 32, 0), ("k", 0), _family_solvers("kernel")[0],
                 np.zeros(N, np.float32))


def test_slot_metrics_snapshot_shape(cont_service, family):
    svc = cont_service
    fp = svc.register(family[0])
    svc.submit(fp, rhs(N, 1)).result(timeout=60)
    snap = svc.stats()
    slots = snap["slots"]
    assert set(slots) >= {
        "passes", "n_slots", "occupancy_hist", "mean_occupancy", "time_in_slot_us",
    }
    for pct in ("p50", "p95", "p99", "p99.9"):
        assert pct in slots["time_in_slot_us"]
        assert pct in snap["latency_us"]
    assert snap["serving"]["n_slots"] == svc.n_slots
