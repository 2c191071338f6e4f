"""Interval arithmetic of a device trace, copied from ``chip_smoke.py``'s
``busy_union_ms``: the device is busy over the union of its operations'
intervals, so that work on streams that overlap counts once."""
from __future__ import annotations


def union(spans) -> list:
    """The union of ``(start, end)`` spans: disjoint spans, sorted."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def busy(spans) -> float:
    """The length of the union of ``spans``."""
    return sum(end - start for start, end in union(spans))


def gaps(spans, lo: float, hi: float) -> list:
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` outside the
    union of ``spans``."""
    out, t = [], lo
    for start, end in union(spans):
        if start > t:
            out.append((t, min(start, hi)))
        t = max(t, end)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]
