"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result's line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, ``cells/<cell>.json`` (the checks with their limits,
how many calls are kept for them and how many are traced), the
configuration's file, ``traffic/<mix>.json`` and the driver it names
(``traffic/<driver>.py``), ``systems/<system>.py`` (the program's entry),
``checks/<check>.py`` and the metrics' readers (``metrics/<metric>.py``, or
for ``<stem>.<cell kind>`` one ``metrics/<stem>.py`` shared). A cell, mix,
configuration or metric is added as files and entries; no file here names
one.

A new configuration brings, as new files:
- ``configs/<config>.json``: the sizes, the ``generator`` and the keys of
  its arguments, the ``values`` rule, the ``dtype`` (one that
  ``roofline.VALUE_BYTES`` counts), the program's ``system`` and its
  options, and ``test_sizes`` (``small`` and ``tiny``: the keys that the
  CPU tests override);
- where no generator it can name exists, ``reference/generators/<name>.py``
  (a frozen plain-NumPy copy of the port's: ``generate``, ``PORT``,
  ``CASES``; ``inputs.generator``);
- where its values are neither ``seed`` nor ``fixed``,
  ``reference/values/<rule>.py`` (``draw(rng, m)``; ``inputs.make_matrix``);
- for each cell, ``cells/<cell>.json``, and the traffic mix, checks and
  metric readers that do not exist yet;
- entries in ``BENCHMARK.json``: the configuration, its cells, and each cell
  in the ``workloads`` lists of the metrics it reports.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import random
import sys
import time
import types
from pathlib import Path

import torch

from portbench import HERE, devtrace, inputs, load_module, peaks

ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # top-level module names


@dataclasses.dataclass
class Spec:
    workload: dict
    config: dict
    cell: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else
    ``metrics/<stem>.py`` for a name ``<stem>.<suffix>``."""
    stem = metric if (HERE / "metrics" / f"{metric}.py").exists() else metric.split(".")[0]
    return load_module("metrics", stem)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(name: str, root: Path = ROOT) -> Spec:
    bench = _json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(by_name)}")
    w = by_name[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Spec(w, _json(root / cfg["file"]), _json(HERE / "cells" / f"{name}.json"),
                _json(HERE / "traffic" / f"{w['traffic']}.json"), e2e, layer)


class Reservoir:
    """A uniform sample of ``k`` of the calls offered, drawn from the seed
    (Algorithm R); holds the outputs, not copies."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, i: int, out) -> None:
        if len(self.items) < self.k:
            self.items.append((i, out))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = (i, out)
        self.seen += 1


def run(spec: Spec, *, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, log=print):
    """One run; returns the result's dict (``checks`` last). ``t0`` is the
    host clock at process start. ``log`` takes the lines printed before
    the result."""
    config, cell, traffic = spec.config, spec.cell, spec.traffic
    system_mod = load_module("systems", config["system"])
    driver = load_module("traffic", traffic["driver"])
    checks = {name: load_module("checks", name) for name in cell["checks"]}
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t = time.perf_counter()
    matrix = inputs.make_matrix(config, seed)
    pool = driver.make_pool(traffic, matrix.n, seed, device,
                            getattr(torch, config["dtype"]))
    sync()
    phases = {"inputs_s": time.perf_counter() - t}
    t = time.perf_counter()
    system = system_mod.System(matrix, config, device)
    phases["system_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system.warmup(driver.rhs(pool, 0))
    sync()
    phases["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    kept = Reservoir(cell["sample"], seed)
    calls, window_s, call_ms = driver.drive(system.call, pool, seconds, device, kept.offer)
    counters = system.counters()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    segment, traced = None, {}
    if trace:
        nxt = iter(range(calls, calls + cell["trace_calls"]))
        segment = devtrace.run_traced(lambda: system.call(driver.rhs(pool, next(nxt))),
                                      cell["trace_calls"], device)
        after = system.counters()
        traced = {k: v[len(counters[k]):] for k, v in after.items() if isinstance(v, list)}

    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(json.dumps({"setup": {**phases, "setup_s": setup_s},
                    "window": {"calls": calls, "seconds": window_s,
                               "call_ms_mean": sum(call_ms) / calls},
                    "counters": {k: v for k, v in counters.items() if not isinstance(v, list)}}))

    # the comparison, after the window, the peak read and the program freed
    t = time.perf_counter()
    judged = types.SimpleNamespace(
        matrix=matrix, config=config, device=device, counters=counters,
        kept=[(i, driver.rhs(pool, i), out) for i, out in kept.items])
    values = {name: check.compare(judged) for name, check in checks.items()}
    bad = {i for name, vs in values.items() for i, v in vs.items()
           if not v <= cell["checks"][name]}
    check_s = time.perf_counter() - t

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=calls, call_ms=call_ms, counters=counters,
        traced_counters=traced, segment=segment, matrix=matrix, rhs_cols=int(traffic["rhs"]),
        peak=peaks.peaks(kind), config=config, traffic=traffic)
    metrics, details = {}, {}
    for m in spec.per_layer if trace else spec.end_to_end:
        reader = load_reader(m["name"])
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            if hasattr(reader, "detail"):
                details[m["name"]] = reader.detail(ctx)
    if details:
        log(json.dumps({"details": details}))
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": not bad and all(values.values()), "attempted": calls,
              "failed": len(bad), "metrics": metrics, "device": dev}
    if segment is not None:
        dev["busy_s"], dev["window_s"] = segment.busy_s, segment.window_s
        result["breakdown"] = {"device_ops": segment.device_ops,
                               "idle_gaps": segment.idle_gaps}
        log(json.dumps({"trace": {"calls": segment.calls, "device_events": segment.device_events,
                                  "ops_per_call": sorted(set(segment.ops_per_call)),
                                  "card": peaks.power_limit() if cuda else ""}}))
    log(json.dumps({"check": {"seconds": check_s,
                              "values": {k: list(v.values()) for k, v in values.items()}}}))
    result["checks"] = {name: {"value": max(vs.values(), default=float("inf")),
                               "limit": cell["checks"][name], "compared": len(vs)}
                        for name, vs in values.items()}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro``), compared whole: ``repro_torch`` is not."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
