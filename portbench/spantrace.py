"""Device idle charged to the program's spans: a second traced segment, run
with the program's tracing on, in which each span of ``repro_torch.obs`` is
a profiler range (a ``user_annotation``) on the clock of the device
operations it launched.

    PYTHONPATH=src python3 -m portbench.spantrace --workload <cell> --seed <n> [--seconds <s>]

from the root of a checkout, on a CUDA card: set-up as ``run.py``'s, the
closed loop for ``--seconds``, then two segments of the cell's
``trace_calls`` calls under the profiler. The first, with the program's
tracing off, is ``devtrace.run_traced``: the segment the benchmark's
per-layer metrics read. The second has the program's tracing on. One JSON
line follows: both segments' idle shares and their difference (what the
instrumentation costs under the profiler), the second's idle by layer and
by span, each span's host self time and the device time under it, and the
idle of each layer a call (a CG iteration in a CG cell) under the names of
the metrics that would read it.

``reduce`` cuts the segment at every span boundary and charges each piece
of each idle stretch to the innermost program span open over it (a
``user_annotation`` other than ``portbench.call``), so that the parts add
up to the idle; a piece under no span is "outside the program" (the
loop, ``pool[i]``, the synchronisation). A device operation counts under
every span open at its runtime launch, found by the launch's
``correlation`` id.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import devtrace, harness, inputs, peaks
from portbench.reference import intervals
from portbench.systems.tracing import tracing

OUTSIDE = "outside the program"
LAYERS = {"executor": "front door", "kernel": "kernel", "cg": "consumer"}
METRICS = {"front door": "frontdoor_idle_us", "kernel": "launch_idle_us",
           "consumer": "cg_idle_us"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}


def layer(name: str) -> str:
    """The layer of a span, by the text before its first ``.``."""
    head = name.split(".", 1)[0]
    return LAYERS.get(head, head)


def trace_events(call, n_calls: int, device: torch.device) -> list:
    """``devtrace.run_traced``'s segment, its Chrome trace events
    returned unreduced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n_calls):
            with record_function(devtrace.CALL):
                call()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _pieces(spans: list, lo: float, hi: float) -> list:
    """``[lo, hi]`` cut at every boundary of ``spans`` ((start, end)):
    (start, end, indices of the spans open over it, innermost last)."""
    marks = []
    for i, (a, b) in enumerate(spans):
        marks.append((a, 1, a - b, i))  # at one instant the longer opens first
        marks.append((b, 0, 0, i))
    marks.sort()
    out, stack, t = [], [], lo
    for when, opens, _, i in marks:
        when = min(max(when, lo), hi)
        if when > t:
            out.append((t, when, tuple(stack)))
            t = when
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    if hi > t:
        out.append((t, hi, tuple(stack)))
    return out


def _unnamed(idle: list, host: list) -> np.ndarray:
    """Which idle stretches the benchmark's own segment would name after
    ``portbench.call`` (``devtrace``: the innermost host operation at a
    stretch's middle, the program's spans aside): those during which no
    torch operation ran."""
    mids = np.array([(a + b) / 2 for a, b in idle])
    order = np.argsort(mids)
    ranked = mids[order]
    owner = np.full(len(mids), "", dtype=object)
    for e in sorted(host, key=lambda e: -float(e["dur"])):  # the innermost last
        a = float(e["ts"])
        j0, j1 = np.searchsorted(ranked, [a, a + float(e["dur"])])
        owner[order[j0:j1]] = e["name"]
    return owner == devtrace.CALL


def reduce(events: list) -> dict:
    """The segment's idle charged to the program's spans (times in µs in,
    seconds out): ``idle_by_layer`` (the layers and ``OUTSIDE``, summing to
    ``idle_s``); by span name, ``count``, ``idle_s``, ``self_s`` (the span
    less its child spans) and ``device_s`` (device operations launched
    inside it, its children's included); and ``unnamed_s``, the idle that
    the benchmark's own segment names ``portbench.call``, by span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]

    def ival(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    notes = [e for e in xs if e.get("cat") == "user_annotation"]
    calls = sorted(ival(e) for e in notes if e["name"] == devtrace.CALL)
    if not calls:
        raise RuntimeError("the trace holds no call ranges")
    lo, hi = calls[0][0], calls[-1][1]

    def inside(e):
        a, b = ival(e)
        return lo <= a and b <= hi

    dev = [e for e in xs if e.get("cat") in devtrace.DEVICE_CATS and inside(e)]
    spans = [e for e in notes if e["name"] != devtrace.CALL and inside(e)]
    names = [e["name"] for e in spans]
    pieces = _pieces([ival(e) for e in spans], lo, hi)
    idle = intervals.gaps([ival(e) for e in dev], lo, hi)

    per = {n: {"count": c, "idle_s": 0.0, "self_s": 0.0, "device_s": 0.0}
           for n, c in collections.Counter(names).items()}
    outside = 0.0
    for a, b, stack in pieces:
        if stack:
            per[names[stack[-1]]]["self_s"] += (b - a) / 1e6
    host = [e for e in xs if e.get("cat") in devtrace.HOST_CATS and inside(e)
            and (e.get("cat") != "user_annotation" or e["name"] == devtrace.CALL)]
    unnamed = _unnamed(idle, host) if idle else []
    unnamed_s = collections.Counter()
    j = 0
    for (a, b), untold in zip(idle, unnamed):  # both sorted; the pieces cover [lo, hi]
        while pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            p0, p1, stack = pieces[k]
            part = (min(b, p1) - max(a, p0)) / 1e6
            if stack:
                per[names[stack[-1]]]["idle_s"] += part
            else:
                outside += part
            if untold:
                unnamed_s[names[stack[-1]] if stack else OUTSIDE] += part
            k += 1

    launched_at = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                   if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    starts = [p[0] for p in pieces]
    for e in dev:
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if t is None or not lo <= t <= hi:
            continue
        stack = pieces[max(bisect.bisect_right(starts, t) - 1, 0)][2]
        for n in {names[i] for i in stack}:
            per[n]["device_s"] += float(e["dur"]) / 1e6

    by_layer = collections.Counter()
    for n, v in per.items():
        by_layer[layer(n)] += v["idle_s"]
    by_layer[OUTSIDE] += outside
    idle_s = sum(b - a for a, b in idle) / 1e6
    return {"calls": len(calls), "window_s": (hi - lo) / 1e6, "idle_s": idle_s,
            "idle_share": idle_s / ((hi - lo) / 1e6), "device_events": len(dev),
            "parts_over_idle": sum(by_layer.values()) / idle_s if idle_s else None,
            "idle_by_layer": dict(by_layer), "spans": per, "unnamed_s": dict(unnamed_s)}


def idle_us(spans: dict, units: int, kind: str) -> dict:
    """Each layer's idle µs a unit (a call, or a CG iteration), under the
    name of the metric that reads it (``<metric>.<kind>``); none where the
    trace holds no program span, as of a program whose spans do not reach
    the profiler."""
    if not spans["spans"] or units <= 0:
        return {}
    return {f"{metric}.{kind}": spans["idle_by_layer"].get(lay, 0.0) * 1e6 / units
            for lay, metric in METRICS.items() if kind == "pcg" or lay != "consumer"}


def measure(spec: harness.Spec, seed: int, seconds: float, device: torch.device) -> dict:
    """Set-up, ``seconds`` of the closed loop, the segment with the
    program's tracing off and the one with it on (see the module
    docstring)."""
    config, cell, traffic = spec.config, spec.cell, spec.traffic
    system_mod = harness.load_module("systems", config["system"])
    driver = harness.load_module("traffic", traffic["driver"])
    matrix = inputs.make_matrix(config, seed)
    pool = driver.make_pool(traffic, matrix.n, seed, device,
                            getattr(torch, config["dtype"]))
    system = system_mod.System(matrix, config, device)
    system.warmup(driver.rhs(pool, 0))
    calls, _, _ = driver.drive(system.call, pool, seconds, device, lambda i, out: None)
    n = cell["trace_calls"]

    def segment(start):
        nxt = iter(range(start, start + n))
        return lambda: system.call(driver.rhs(pool, next(nxt)))

    def iters(counters):
        return sum(counters.get("iters", []))

    c0 = system.counters()
    t = time.perf_counter()
    first = devtrace.run_traced(segment(calls), n, device)
    first_s = time.perf_counter() - t
    c1 = system.counters()
    t = time.perf_counter()
    with tracing():
        events = trace_events(segment(calls + n), n, device)
    second = reduce(events)
    second_s = time.perf_counter() - t
    c2 = system.counters()
    system.close()

    kind = "pcg" if "iters" in c0 else "solve"
    units = (iters(c1) - iters(c0), iters(c2) - iters(c1)) if kind == "pcg" else (n, n)
    first_share = 1.0 - first.busy_s / first.window_s
    return {
        "workload": spec.workload["name"], "device": str(device), "calls": n,
        "units": {"per": "iteration" if kind == "pcg" else "call", "first": units[0],
                  "second": units[1]},
        "idle_share": {"first": first_share, "second": second["idle_share"],
                       "difference": second["idle_share"] - first_share},
        "on_cost_us": (second["window_s"] / units[1] - first.window_s / units[0]) * 1e6,
        "seconds": {"first": first_s, "second": second_s},
        "metrics": idle_us(second, units[1], kind),
        "second": second,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)
    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench.spantrace: needs {chips} CUDA card(s)", file=sys.stderr)
        return 5
    out = measure(spec, args.seed, args.seconds, torch.device("cuda", 0))
    out["card"] = peaks.power_limit() or torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
