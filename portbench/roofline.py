"""The least work a call needs, counted by the benchmark from its own CSR,
whatever implements the call: each stored entry's value and column read
once, the row pointers once, each right-hand side read once and each
answer written once (4-byte values and indices); one multiply-add an
off-diagonal entry and one division a row for each right-hand side. The
bound is the larger of bytes over the card's bandwidth and operations over
its float32 rate."""
from __future__ import annotations

from portbench.reference.matrices import Csr, lower_triangle

WORD = 4  # bytes of a float32 value or an int32 index


def matrix_bytes(m: Csr) -> int:
    return m.nnz * 2 * WORD + (m.n + 1) * WORD


def solve_work(L: Csr, rhs: int) -> tuple:
    """(bytes, operations) of one triangular solve with ``rhs`` columns."""
    return (matrix_bytes(L) + 2 * L.n * rhs * WORD,
            (2 * (L.nnz - L.n) + L.n) * rhs)


def pcg_iteration_work(A: Csr) -> tuple:
    """(bytes, operations) of one IC(0)-preconditioned CG iteration: A once
    (the matvec), the factor twice (forward and backward solves; IC(0)
    keeps tril(A)'s pattern), and the four vectors x, r, z, p each read and
    written once."""
    L = lower_triangle(A)
    lb, lops = solve_work(L, 1)
    lb -= 2 * L.n * WORD  # the solves' vectors are among the four below
    return (matrix_bytes(A) + 2 * lb + 8 * A.n * WORD,
            2 * A.nnz + 2 * lops + 10 * A.n)


def bound_s(work: tuple, peak: dict) -> tuple:
    """(seconds, "bytes" | "operations") of ``work`` at ``peak``."""
    t_bytes = work[0] / peak["bytes_per_s"]
    t_ops = work[1] / peak["fp32_flops"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(ctx, work: tuple, units: int):
    """``units`` calls' (or iterations') least time at the card's peaks over
    the traced segment's busy time, in %; None without a trace or peaks."""
    seg = ctx.segment
    if not (seg and seg.busy_s and ctx.peak and units):
        return None
    return 100.0 * units * bound_s(work, ctx.peak)[0] / seg.busy_s


def detail(ctx, work: tuple, units: int) -> dict:
    t, by = bound_s(work, ctx.peak)
    return {"bound_by": by, "computed_bytes": work[0], "computed_operations": work[1],
            "bound_us": t * 1e6, "units": units,
            "busy_ms_per_unit": ctx.segment.busy_s / units * 1e3, "peak": ctx.peak}
