"""The traced segment of a ``--trace 1`` run: calls under ``torch.profiler``,
reduced to what the per-layer readers and the result's ``breakdown`` need.

The profiler's Chrome trace is read, not its averages: each device operation
is tied to the call whose ``record_function`` range it runs in (each call
ends in a synchronisation), so no kernel is picked by name. The device is
busy over the union of its operations' intervals inside the segment; the
segment runs from the first call's start to the last call's end. Each idle stretch is named by the innermost host
operation running at its middle.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from portbench.reference import intervals

CALL = "portbench.call"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Segment:
    calls: int
    window_s: float  # first call's start to last call's end, trace clock
    busy_s: float  # union of the device operations' intervals inside it
    ops_per_call: list  # device operations tied to each call
    device_ops: list  # [[name, seconds]], the most time first
    idle_gaps: list  # [[host operation, seconds]], the most time first
    device_events: int


def run_traced(call, n_calls: int, device: torch.device) -> Segment:
    """``call()`` ``n_calls`` times under the profiler, each in its own
    ``record_function`` range and followed by a device synchronisation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n_calls):
            with record_function(CALL):
                call()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events)


def reduce(events: list) -> Segment:
    """The segment's numbers from Chrome trace events (times in µs)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in xs if e.get("cat") == "user_annotation" and e["name"] == CALL)
    if not calls:
        raise RuntimeError("the trace holds no call ranges")
    lo, hi = calls[0][0], calls[-1][1]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    # each call ends in a device synchronisation inside its range, so its
    # device operations run inside that range
    starts = np.array([c[0] for c in calls])
    per_call = [0] * len(calls)
    for a, b in spans:
        k = int(np.searchsorted(starts, (a + b) / 2, side="right")) - 1
        if k >= 0 and (a + b) / 2 <= calls[k][1]:
            per_call[k] += 1
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"][:120]] += float(e["dur"]) / 1e6
    idle = intervals.gaps(spans, lo, hi)
    return Segment(
        calls=len(calls), window_s=(hi - lo) / 1e6, busy_s=intervals.busy(spans) / 1e6,
        ops_per_call=per_call,
        device_ops=[[k, v] for k, v in by_name.most_common(TOP)],
        idle_gaps=_name_gaps(idle, [e for e in xs if e.get("cat") in HOST_CATS]),
        device_events=len(dev))


def _name_gaps(gaps: list, host: list) -> list:
    """Idle seconds summed by the innermost host operation running at each
    gap's middle ("between calls" where none is)."""
    if not gaps:
        return []
    mids = np.array([(a + b) / 2 for a, b in gaps])
    order = np.argsort(mids)
    mids = mids[order]
    owner = np.full(len(mids), -1)
    host = sorted(host, key=lambda e: -float(e["dur"]))  # the innermost is written last
    for i, e in enumerate(host):
        a = float(e["ts"])
        j0, j1 = np.searchsorted(mids, [a, a + float(e["dur"])])
        owner[j0:j1] = i
    total = collections.Counter()
    lengths = np.array([b - a for a, b in gaps])[order]
    for k, who in enumerate(owner):
        name = host[who]["name"][:120] if who >= 0 else "between calls"
        total[name] += lengths[k] / 1e6
    return [[k, v] for k, v in total.most_common(TOP)]
