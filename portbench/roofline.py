"""The least work a call needs, counted by the benchmark from its own CSR,
whatever implements the call: each stored entry's value and column read
once, the row pointers once, each right-hand side read once and each
answer written once; one multiply-add an off-diagonal entry and one
division a row for each right-hand side. A value (the matrix's, b's, x's,
CG's vectors') takes the width of the configuration's ``dtype``; a column
index or a row pointer 4 bytes, as the port's plans hold int32. The bound
is the larger of bytes over the card's bandwidth and operations over its
rate in that ``dtype``."""
from __future__ import annotations

from portbench.reference.matrices import Csr, lower_triangle

INDEX_BYTES = 4  # an int32 column index or row pointer
VALUE_BYTES = {"float32": 4, "float64": 8}  # by the configuration's dtype
RATE = {"float32": "fp32_flops", "float64": "fp64_flops"}  # the peak that bounds operations


def matrix_bytes(m: Csr, dtype: str = "float32") -> int:
    return m.nnz * (VALUE_BYTES[dtype] + INDEX_BYTES) + (m.n + 1) * INDEX_BYTES


def solve_work(L: Csr, rhs: int, dtype: str = "float32") -> tuple:
    """(bytes, operations) of one triangular solve with ``rhs`` columns."""
    return (matrix_bytes(L, dtype) + 2 * L.n * rhs * VALUE_BYTES[dtype],
            (2 * (L.nnz - L.n) + L.n) * rhs)


def pcg_iteration_work(A: Csr, dtype: str = "float32") -> tuple:
    """(bytes, operations) of one IC(0)-preconditioned CG iteration: A once
    (the matvec), the factor twice (forward and backward solves; IC(0)
    keeps tril(A)'s pattern), and the four vectors x, r, z, p each read and
    written once."""
    L = lower_triangle(A)
    word = VALUE_BYTES[dtype]
    lb, lops = solve_work(L, 1, dtype)
    lb -= 2 * L.n * word  # the solves' vectors are among the four below
    return (matrix_bytes(A, dtype) + 2 * lb + 8 * A.n * word,
            2 * A.nnz + 2 * lops + 10 * A.n)


def bound_s(work: tuple, peak: dict, dtype: str = "float32") -> tuple:
    """(seconds, "bytes" | "operations") of ``work`` at ``peak``."""
    t_bytes = work[0] / peak["bytes_per_s"]
    t_ops = work[1] / peak[RATE[dtype]]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(ctx, work: tuple, units: int):
    """``units`` calls' (or iterations') least time at the card's peaks over
    the traced segment's busy time, in %; None without a trace or peaks."""
    seg = ctx.segment
    if not (seg and seg.busy_s and ctx.peak and units):
        return None
    return 100.0 * units * bound_s(work, ctx.peak, ctx.config["dtype"])[0] / seg.busy_s


def detail(ctx, work: tuple, units: int) -> dict:
    t, by = bound_s(work, ctx.peak, ctx.config["dtype"])
    return {"bound_by": by, "computed_bytes": work[0], "computed_operations": work[1],
            "bound_us": t * 1e6, "units": units,
            "busy_ms_per_unit": ctx.segment.busy_s / units * 1e3, "peak": ctx.peak}
