"""Tracing core — spans, counters, and the in-process ``TraceBuffer``.

A copy of the JAX package's ``repro/obs/trace.py``. Design constraints:

  * **zero overhead when off** — ``span(...)`` on the disabled path is a
    single module-flag check returning one process-wide ``_NullSpan``
    singleton: no allocation, no lock, no buffer growth. The flag is
    re-read per call, so enabling tracing mid-process takes effect
    immediately everywhere.
  * **thread-safe when on** — spans finish by appending one immutable
    record under the buffer lock (a leaf lock: nothing is called while
    holding it, so it can never participate in a lock cycle with the
    plan-cache lock the instrumented code holds).
  * **bounded** — the buffer keeps at most ``cap`` spans and counts
    drops instead of growing without bound under a long serving run.

Spans nest lexically (context managers), so per-thread begin/end pairs
are properly bracketed by construction.

Counters are monotonic ``int``s that wrap at ``COUNTER_WRAP`` (2**63 —
documented two's-complement semantics so exported values stay exact in
JSON/float64 consumers); ``reset_counters`` zeroes them.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

# counters wrap modulo 2**63: large enough to be unreachable in practice,
# small enough that every value survives a float64/JSON round-trip exactly
COUNTER_WRAP = 1 << 63

# spans kept per buffer before drops start (each record is ~200 bytes; the
# default bounds a runaway traced serving loop at ~200 MB)
DEFAULT_CAP = 1_000_000


class SpanRecord(NamedTuple):
    """One finished span. Times are ``time.perf_counter_ns`` (monotonic,
    process-relative — NOT wall-clock epoch)."""

    name: str
    cat: str
    tid: int
    thread_name: str
    t0_ns: int
    t1_ns: int
    args: dict


class TraceBuffer:
    """Thread-safe bounded span + counter sink (see module docstring)."""

    def __init__(self, name: str = "default", cap: int = DEFAULT_CAP):
        self.name = name
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._counters: Dict[str, int] = {}
        self.dropped = 0  # spans discarded once cap was reached

    # ------------------------------------------------------------ record
    def add_span(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) >= self.cap:
                self.dropped += 1
                return
            self._spans.append(rec)

    def counter_add(self, name: str, value: int = 1) -> int:
        """Add ``value`` (may be negative) to counter ``name``; returns
        the new value. Wraps modulo ``COUNTER_WRAP``."""
        with self._lock:
            v = (self._counters.get(name, 0) + int(value)) % COUNTER_WRAP
            self._counters[name] = v
            return v

    # ---------------------------------------------------------- snapshot
    def spans(self) -> List[SpanRecord]:
        """A consistent copy of the finished spans (insertion order =
        per-thread completion order)."""
        with self._lock:
            return list(self._spans)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        """Drop all spans and the drop count; counters survive (use
        ``reset_counters`` for those — benchmarks clear the span buffer
        between phases without losing lifetime counts)."""
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    def summary(self) -> dict:
        """JSON-ready aggregate: span counts + total/mean duration per
        span name, the counters, and buffer health."""
        with self._lock:
            spans = list(self._spans)
            counters = dict(self._counters)
            dropped = self.dropped
        agg: Dict[str, list] = {}
        for s in spans:
            a = agg.get(s.name)
            if a is None:
                agg[s.name] = [1, s.t1_ns - s.t0_ns, s.cat]
            else:
                a[0] += 1
                a[1] += s.t1_ns - s.t0_ns
        return {
            "buffer": self.name,
            "n_spans": len(spans),
            "dropped": dropped,
            "cap": self.cap,
            "spans": {
                name: {
                    "cat": cat,
                    "count": cnt,
                    "total_us": round(tot / 1e3, 1),
                    "mean_us": round(tot / cnt / 1e3, 2),
                }
                for name, (cnt, tot, cat) in sorted(agg.items())
            },
            "counters": dict(sorted(counters.items())),
        }


# ------------------------------------------------------------- registry
_REG_LOCK = threading.Lock()
_BUFFERS: Dict[str, TraceBuffer] = {}


def get_buffer(name: str = "default") -> TraceBuffer:
    """The process-global buffer registry: one ``TraceBuffer`` per name,
    created on first use. The ``"default"`` buffer is the one ``enable()``
    activates and every instrumentation site records into."""
    with _REG_LOCK:
        buf = _BUFFERS.get(name)
        if buf is None:
            buf = _BUFFERS[name] = TraceBuffer(name)
        return buf


# --------------------------------------------------------- on/off switch
# The fast path reads these two module globals and nothing else. They are
# only ever written under _REG_LOCK; readers tolerate the (benign) race of
# seeing the flag flip mid-call — a span started just before disable()
# still lands in its buffer, which is the useful behavior.
_ENABLED = False
_ACTIVE: Optional[TraceBuffer] = None


def enable(buffer: Optional[TraceBuffer] = None) -> TraceBuffer:
    """Turn tracing on, recording into ``buffer`` (default: the global
    ``"default"`` buffer). Returns the active buffer."""
    global _ENABLED, _ACTIVE
    buf = buffer if buffer is not None else get_buffer("default")
    with _REG_LOCK:
        _ACTIVE = buf
        _ENABLED = True
    return buf


def disable() -> None:
    global _ENABLED
    with _REG_LOCK:
        _ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


def active_buffer() -> Optional[TraceBuffer]:
    """The buffer currently receiving spans (None while disabled)."""
    return _ACTIVE if _ENABLED else None


@contextmanager
def tracing(buffer: Optional[TraceBuffer] = None):
    """Scoped enable: ``with obs.tracing() as buf: ...`` — restores the
    previous on/off state (and active buffer) on exit, so tests and
    benchmarks can trace one region without leaking global state."""
    global _ENABLED, _ACTIVE
    with _REG_LOCK:
        prev = (_ENABLED, _ACTIVE)
    buf = enable(buffer)
    try:
        yield buf
    finally:
        with _REG_LOCK:
            _ENABLED, _ACTIVE = prev


# ----------------------------------------------------------------- spans
class _NullSpan:
    """The disabled-path span: one process-wide singleton, every method a
    no-op. ``span()`` must return THIS object (identity-tested) whenever
    tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """A live span: created by ``span()`` on the enabled path, recorded
    into its buffer on ``__exit__``. ``set(key=value)`` attaches args
    discovered mid-span (e.g. a cache hit flag known only at the end)."""

    __slots__ = ("name", "cat", "args", "_buf", "_t0")

    def __init__(self, name: str, cat: str, args: dict, buf: TraceBuffer):
        self.name = name
        self.cat = cat
        self.args = args
        self._buf = buf
        self._t0 = 0

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        cur = threading.current_thread()
        self._buf.add_span(
            SpanRecord(
                name=self.name,
                cat=self.cat,
                tid=cur.ident or 0,
                thread_name=cur.name,
                t0_ns=self._t0,
                t1_ns=t1,
                args=self.args,
            )
        )
        return False


def span(name: str, cat: str = "", **args):
    """Open a traced region::

        with obs.span("inspector.compile_plan", cat="inspector", n=n):
            ...

    Disabled path: one flag check, returns the shared ``NULL_SPAN``
    singleton — no allocation, no lock (see module docstring). ``cat``
    groups spans into layers (inspector / autotune / cache / backend /
    executor / serve) for the exporters; it defaults to the text before
    the first ``.`` of ``name``."""
    if not _ENABLED:
        return NULL_SPAN
    buf = _ACTIVE
    if buf is None:  # disable() raced us; drop silently
        return NULL_SPAN
    return Span(name, cat or name.split(".", 1)[0], args, buf)


def counter_add(name: str, value: int = 1) -> None:
    """Bump monotonic counter ``name`` in the active buffer; a no-op
    (one flag check) while tracing is off."""
    if not _ENABLED:
        return
    buf = _ACTIVE
    if buf is not None:
        buf.counter_add(name, value)


def pid() -> int:
    return os.getpid()
