"""Exporter — Chrome/Perfetto ``trace_event`` JSON.

``export_chrome_trace(path)`` writes the active (or given) buffer as the
Chrome Trace Event Format consumed by ``chrome://tracing``, Perfetto
(https://ui.perfetto.dev) and ``speedscope``: a ``traceEvents`` list of
``B``/``E`` (duration begin/end) events with microsecond timestamps,
grouped by thread. Span nesting is lexical (context managers), so the
per-thread event stream is properly bracketed; ties at one timestamp are
ordered E-before-B (and inner-before-outer among E's) so a stack-based
consumer never underflows. A copy of the JAX package's ``obs/export.py``
over the port's own ``obs.trace``: the same event order.
"""
from __future__ import annotations

import json
from typing import List, Optional

from repro_torch.obs.trace import TraceBuffer, active_buffer, get_buffer, pid

TRACE_SCHEMA = "repro-obs-trace/v1"


def _resolve(buffer: Optional[TraceBuffer]) -> TraceBuffer:
    buf = buffer if buffer is not None else active_buffer()
    return buf if buf is not None else get_buffer("default")


def chrome_trace_events(buffer: Optional[TraceBuffer] = None) -> List[dict]:
    """The buffer's spans as Chrome ``trace_event`` B/E dicts, sorted by
    timestamp (microseconds, monotonic origin). Tie-break at equal ts:
    E events sort before B events, and among simultaneous E's the
    later-started (inner) span closes first — preserving proper nesting
    for stack-based consumers."""
    buf = _resolve(buffer)
    p = pid()
    events = []
    for s in buf.spans():
        common = {
            "name": s.name,
            "cat": s.cat or "obs",
            "pid": p,
            "tid": s.tid,
        }
        # sort keys: (ts_ns, phase_rank, nesting_rank). E=0 < B=1 puts a
        # closing span before the next one opens at the same instant;
        # within simultaneous B's the longer (outer) span opens first,
        # within simultaneous E's the shorter (inner) span closes first.
        dur = s.t1_ns - s.t0_ns
        b = dict(common, ph="B", ts=s.t0_ns / 1e3)
        e = dict(common, ph="E", ts=s.t1_ns / 1e3)
        if s.args:
            b["args"] = s.args
        events.append(((s.t0_ns, 1, -dur), b))
        events.append(((s.t1_ns, 0, dur), e))
    events.sort(key=lambda kv: kv[0])
    return [ev for _, ev in events]


def chrome_trace_payload(buffer: Optional[TraceBuffer] = None) -> dict:
    """The full JSON document ``export_chrome_trace`` writes: the event
    list plus thread-name metadata, the counters, and the buffer summary
    (Perfetto ignores the extra top-level keys)."""
    buf = _resolve(buffer)
    p = pid()
    tids = {}
    for s in buf.spans():
        tids.setdefault(s.tid, s.thread_name)
    meta = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": p,
            "tid": tid,
            "args": {"name": tname},
        }
        for tid, tname in sorted(tids.items())
    ]
    return {
        "schema": TRACE_SCHEMA,
        "displayTimeUnit": "ms",
        "traceEvents": meta + chrome_trace_events(buf),
        "counters": buf.counters(),
        "summary": buf.summary(),
    }


def export_chrome_trace(
    path: str, buffer: Optional[TraceBuffer] = None
) -> dict:
    """Write the buffer as Chrome/Perfetto trace JSON; returns the
    payload that was written (handy for asserting on it in tests)."""
    payload = chrome_trace_payload(buffer)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")
    return payload


def load_chrome_trace(path: str) -> dict:
    """Re-parse an exported trace (the smoke's round-trip check)."""
    with open(path) as fh:
        return json.load(fh)


def validate_chrome_trace(payload: dict) -> dict:
    """Structural validation of a (re-parsed) trace payload: timestamps
    monotonic, every B matched by an E on its own thread with proper
    nesting (per-tid stack never underflows and names match), no event
    left open. Returns {"n_events", "n_pairs", "cats"}; raises
    ``ValueError`` on any violation."""
    events = [
        ev for ev in payload["traceEvents"] if ev.get("ph") in ("B", "E")
    ]
    last_ts = None
    for ev in events:
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError(
                f"timestamps not monotonic: {ev['ts']} after {last_ts}"
            )
        last_ts = ev["ts"]
    stacks: dict = {}
    pairs = 0
    cats = set()
    for ev in events:
        stack = stacks.setdefault(ev["tid"], [])
        if ev["ph"] == "B":
            stack.append(ev)
            cats.add(ev.get("cat", ""))
        else:
            if not stack:
                raise ValueError(
                    f"E without matching B: {ev['name']} tid={ev['tid']}"
                )
            b = stack.pop()
            if b["name"] != ev["name"]:
                raise ValueError(
                    f"mismatched B/E pair: B={b['name']} E={ev['name']}"
                )
            pairs += 1
    open_spans = [b["name"] for st in stacks.values() for b in st]
    if open_spans:
        raise ValueError(f"unclosed spans at end of trace: {open_spans}")
    return {"n_events": len(events), "n_pairs": pairs, "cats": sorted(cats)}

