"""Fault-tolerance runtime: failure detection, elastic re-meshing,
straggler mitigation. One process sees no fleet, so hardware events are
injected through ``FailureSimulator`` — the decision logic (what the
coordinator does) is the real, tested artifact; the signals are simulated.
A copy of the JAX package's ``distributed/fault_tolerance.py``: pure
Python and NumPy, and every function that reads a clock takes ``now=``.

Runbook encoded here (1000-node posture):
  * heartbeat miss / step-time blowup  -> mark node suspect
  * suspect node persists              -> declare failed, trigger elastic
    restart: shrink the data axis to the largest full multiple available,
    rebuild the mesh, restore the latest checkpoint WITH resharding
    (checkpoint.restore_checkpoint(template=...)), resume from the
    deterministic data pipeline at the saved step
  * stragglers (p99 >> median)         -> quarantine list; schedule around
    (data-parallel ranks are interchangeable — quarantined ranks get no
    shard on the next re-mesh)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class NodeState:
    node_id: int
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    suspect: bool = False
    failed: bool = False


@dataclasses.dataclass
class FleetMonitor:
    """Tracks heartbeats + step-time telemetry; decides failures and
    stragglers."""

    n_nodes: int
    heartbeat_timeout_s: float = 10.0
    straggler_factor: float = 2.0
    window: int = 20

    def __post_init__(self):
        now = time.monotonic()
        self.nodes: Dict[int, NodeState] = {
            i: NodeState(i, now) for i in range(self.n_nodes)
        }

    def heartbeat(self, node_id: int, step_time_s: Optional[float] = None,
                  now: Optional[float] = None):
        n = self.nodes[node_id]
        n.last_heartbeat = now if now is not None else time.monotonic()
        if step_time_s is not None:
            n.step_times.append(step_time_s)
            n.step_times = n.step_times[-self.window:]

    def sweep(self, now: Optional[float] = None) -> dict:
        """-> {"failed": [...], "stragglers": [...]}; idempotent."""
        now = now if now is not None else time.monotonic()
        failed, stragglers = [], []
        medians = [
            float(np.median(n.step_times))
            for n in self.nodes.values()
            if n.step_times and not n.failed
        ]
        fleet_median = float(np.median(medians)) if medians else None
        for n in self.nodes.values():
            if n.failed:
                failed.append(n.node_id)
                continue
            if now - n.last_heartbeat > self.heartbeat_timeout_s:
                if n.suspect:
                    n.failed = True
                    failed.append(n.node_id)
                else:
                    n.suspect = True
            else:
                n.suspect = False
            if (
                fleet_median
                and n.step_times
                and float(np.median(n.step_times))
                > self.straggler_factor * fleet_median
            ):
                stragglers.append(n.node_id)
        return {"failed": failed, "stragglers": stragglers,
                "healthy": self.healthy_count()}

    def healthy_count(self) -> int:
        return sum(1 for n in self.nodes.values() if not n.failed)


def elastic_mesh_shape(
    healthy_chips: int, *, model: int = 16, pod: Optional[int] = None
) -> Tuple[dict, int]:
    """Largest (data, model[, pod]) mesh that fits the surviving chips.
    The model axis is sacred (TP degree is baked into layouts); the data
    axis shrinks; pods drop whole when a pod loses its last full data row.
    Returns (mesh shape dict, chips used)."""
    per_pod = healthy_chips if pod is None else healthy_chips // pod
    data = max(per_pod // model, 1)
    if pod is None:
        shape = {"data": data, "model": model}
        return shape, data * model
    shape = {"pod": pod, "data": data, "model": model}
    return shape, pod * data * model


@dataclasses.dataclass
class FailureSimulator:
    """Drives FleetMonitor with injected events (the CPU-container stand-in
    for real hardware signals)."""

    monitor: FleetMonitor
    rng_seed: int = 0

    def kill(self, node_id: int, at: float):
        # stop heartbeats by backdating the last one
        self.monitor.nodes[node_id].last_heartbeat = (
            at - 2 * self.monitor.heartbeat_timeout_s
        )

    def slow_down(self, node_id: int, factor: float, base_step: float = 1.0):
        n = self.monitor.nodes[node_id]
        n.step_times = [base_step * factor] * self.monitor.window


def recovery_plan(
    monitor: FleetMonitor,
    chips_per_node: int,
    *,
    model: int = 16,
    pod: Optional[int] = None,
) -> dict:
    """The coordinator's decision: new mesh + what to do with stragglers."""
    sweep = monitor.sweep()
    healthy_chips = sweep["healthy"] * chips_per_node
    mesh_shape, used = elastic_mesh_shape(healthy_chips, model=model, pod=pod)
    return {
        "mesh_shape": mesh_shape,
        "chips_used": used,
        "quarantine": sweep["stragglers"],
        "lost_nodes": sweep["failed"],
        "action": "restart_from_checkpoint" if sweep["failed"] else (
            "rebalance" if sweep["stragglers"] else "none"
        ),
    }
