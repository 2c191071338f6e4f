"""The port's ``distributed/fault_tolerance.py`` against the JAX
package's: the scenarios of ``tests/test_distributed_extras.py`` driven
through both with the same ``now=`` and the same injected events, the
sweeps, meshes and recovery plans equal."""
import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed import fault_tolerance as tft


def _both(fn):
    return fn(jft), fn(tft)


def _two_strikes(ft):
    mon = ft.FleetMonitor(n_nodes=8, heartbeat_timeout_s=5.0)
    sim = ft.FailureSimulator(mon)
    now = 100.0
    for i in range(8):
        mon.heartbeat(i, 1.0, now=now)
    sim.kill(3, at=now)
    first = mon.sweep(now=now)
    second = mon.sweep(now=now + 1)
    return first, second


def _straggler(ft):
    mon = ft.FleetMonitor(n_nodes=4, straggler_factor=2.0)
    sim = ft.FailureSimulator(mon)
    now = 50.0
    for i in range(4):
        for _ in range(10):
            mon.heartbeat(i, 1.0, now=now)
    sim.slow_down(2, factor=3.0)
    return mon.sweep(now=now)


def _recovery(ft, pod=None):
    mon = ft.FleetMonitor(n_nodes=32, heartbeat_timeout_s=5.0)
    sim = ft.FailureSimulator(mon)
    now = 10.0
    for i in range(32):
        for _ in range(5):
            mon.heartbeat(i, 1.0, now=now)
    sim.kill(5, at=now)
    swept = mon.sweep(now=now)  # suspect
    sim.slow_down(9, factor=4.0)
    # recovery_plan sweeps on the monotonic clock, which lies far past the
    # injected times in both packages alike
    return swept, ft.recovery_plan(mon, chips_per_node=8, model=16, pod=pod)


def test_failure_detection_two_strikes_equals_jax():
    (jf, js), (tf, ts) = _both(_two_strikes)
    assert (tf, ts) == (jf, js)
    assert ts["failed"] == [3] and ts["healthy"] == 7 and tf["failed"] == []


def test_straggler_detection_equals_jax():
    j, t = _both(_straggler)
    assert t == j and t["stragglers"] == [2]


@pytest.mark.parametrize("pod", [None, 2])
def test_recovery_plan_equals_jax(pod):
    j, t = _both(lambda ft: _recovery(ft, pod))
    assert t == j
    plan = t[1]
    assert plan["action"] == "restart_from_checkpoint"
    assert 5 in plan["lost_nodes"] and 9 in plan["quarantine"]


@pytest.mark.parametrize("chips,model,pod", [
    (256, 16, None), (232, 16, None), (480, 16, 2), (8, 16, None), (512, 8, 2), (31, 4, None),
])
def test_elastic_mesh_shape_equals_jax(chips, model, pod):
    assert tft.elastic_mesh_shape(chips, model=model, pod=pod) == \
        jft.elastic_mesh_shape(chips, model=model, pod=pod)


def test_rebalance_without_failures_equals_jax():
    def run(ft):
        mon = ft.FleetMonitor(n_nodes=6, straggler_factor=1.5, window=4)
        sim = ft.FailureSimulator(mon)
        for i in range(6):
            for t in range(6):
                mon.heartbeat(i, 1.0 + 0.01 * t, now=1e12)
        sim.slow_down(4, factor=2.0)
        return ft.recovery_plan(mon, chips_per_node=4, model=4)

    j, t = _both(run)
    assert t == j and t["action"] == "rebalance" and t["quarantine"] == [4]
