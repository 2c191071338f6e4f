"""``repro_torch.obs`` — tracing spans and counters.

The span/counter core of the JAX package's ``repro.obs``, copied so the
port imports nothing of that package. Tracing is OFF by default and costs
one flag check per instrumentation site when off (``span()`` returns a
process-wide singleton). Usage::

    from repro_torch import obs

    with obs.tracing() as buf:
        solver = TriangularSolver.plan(L)
        x = solver.solve(b)
    print(obs.summary(buf))     # per-span aggregate + counters

Spans are host-clock regions: a span around an asynchronous CUDA launch
measures the enqueue, not the device work (the timed solves' step spans
wait for the device). While a ``torch.profiler`` session runs, each span
is also a profiler range of its name, in the profiler's trace beside the
device operations it launched (``obs.trace``). ``export_chrome_trace(path)``
writes a buffer as Chrome/Perfetto trace JSON (``obs.export``).
"""
from repro_torch.obs.export import (
    TRACE_SCHEMA,
    chrome_trace_events,
    chrome_trace_payload,
    export_chrome_trace,
    load_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.obs.trace import (
    COUNTER_WRAP,
    DEFAULT_CAP,
    NULL_SPAN,
    Span,
    SpanRecord,
    TraceBuffer,
    active_buffer,
    counter_add,
    disable,
    enable,
    get_buffer,
    is_enabled,
    span,
    tracing,
)


def summary(buffer=None) -> dict:
    """JSON-ready aggregate of the active (or given) buffer."""
    buf = buffer if buffer is not None else active_buffer()
    if buf is None:
        return {"enabled": False}
    return {"enabled": is_enabled(), **buf.summary()}


__all__ = [
    "COUNTER_WRAP",
    "DEFAULT_CAP",
    "NULL_SPAN",
    "Span",
    "SpanRecord",
    "TRACE_SCHEMA",
    "TraceBuffer",
    "active_buffer",
    "chrome_trace_events",
    "chrome_trace_payload",
    "counter_add",
    "disable",
    "enable",
    "export_chrome_trace",
    "get_buffer",
    "is_enabled",
    "load_chrome_trace",
    "span",
    "summary",
    "tracing",
    "validate_chrome_trace",
]
