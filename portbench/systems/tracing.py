"""The program's own tracing (``repro_torch.obs``), switched on for a traced
segment. While it is on and a profiler runs, each of the program's spans
is a profiler range of its own name in the profiler's trace; a program
whose spans do not reach the profiler leaves the trace without them."""
from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def tracing():
    """The program's tracing on, into a buffer of its own, for the
    ``with`` block; the previous state is restored after it."""
    from repro_torch import obs

    with obs.tracing(obs.TraceBuffer("portbench")) as buf:
        yield buf
