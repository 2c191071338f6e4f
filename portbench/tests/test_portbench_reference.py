"""The yardstick: the frozen generators give the port's matrices, the plain
solves agree with dense float64 algebra, the interval arithmetic and the
byte counts are right on cases sized by hand."""
import importlib
import json

import numpy as np
import pytest
import scipy.linalg
import torch

from portbench import HERE, inputs, load_module, roofline
from portbench.reference import intervals, matrices
from portbench.reference.solve import LevelSolve, Pcg, Spmv, levels

# every generator file: the benchmark's own, and the test configuration's
# (tests/room/), each with the argument sets it gives
GENERATOR_FILES = [(kind, p.stem) for kind in ("reference/generators",
                                               "tests/room/reference/generators")
                   for p in sorted((HERE / kind).glob("*.py"))]
GENERATOR_CASES = [pytest.param(kind, name, case, id=f"{name}-{i}")
                   for kind, name in GENERATOR_FILES
                   for i, case in enumerate(load_module(kind, name).CASES)]


def dense(m):
    d = np.zeros((m.n, m.n))
    d[m.row_of_entry(), m.indices] = m.data
    return d


@pytest.mark.parametrize("n,p,seed", [(500, 1e-2, 0), (2000, 2e-3, 3), (3000, 1e-3, 11)])
def test_er_generator_is_the_ports(n, p, seed):
    from repro_torch.sparse import erdos_renyi_lower

    want, got = erdos_renyi_lower(n, p, seed=seed), matrices.erdos_renyi_lower(n, p, seed=seed)
    for a in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(want, a), getattr(got, a))


@pytest.mark.parametrize("kind,name,case", GENERATOR_CASES)
def test_each_generator_file_is_the_ports(kind, name, case):
    mod = load_module(kind, name)
    module, _, func = mod.PORT.rpartition(".")
    assert not module.startswith("portbench")
    want, got = getattr(importlib.import_module(module), func)(**case), mod.generate(**case)
    assert isinstance(got, matrices.Csr)
    for a in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(want, a), getattr(got, a))


def _matrix_as_before(spec, seed):
    """``inputs.make_matrix`` as it read before generators and value rules
    were found by name."""
    m = getattr(matrices, spec["generator"])(
        **{param: spec[key] for param, key in spec["generator_args"].items()})
    if spec.get("values") == "seed":
        is_diag = m.indices == m.row_of_entry()
        off, diag = matrices.paper_values(inputs.rng(seed, 1), int((~is_diag).sum()), m.n)
        data = np.empty(m.nnz)
        data[~is_diag] = off
        data[is_diag] = diag
        m = matrices.Csr(m.n, m.indptr, m.indices, data)
    return m


@pytest.mark.parametrize("config,seed", [("er100k", 0), ("er100k", 2**31 + 12345),
                                         ("poisson512", 0)])
def test_the_benchmarks_matrices_and_work_are_unmoved(config, seed):
    spec = json.loads((HERE / "configs" / f"{config}.json").read_text())
    got, want = inputs.make_matrix(spec, seed), _matrix_as_before(spec, seed)
    for a in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, a), getattr(want, a))
    assert spec["dtype"] == "float32"
    # the tuples the benchmark counted before the count took the dtype
    if config == "er100k":
        assert roofline.solve_work(got, 1, "float32") == (5994924, 1098730)
        assert roofline.solve_work(got, 32, "float32") == (30794924, 35159360)
    else:
        assert roofline.pcg_iteration_work(got, "float32") == (34570252, 7856128)
        assert roofline.solve_work(matrices.lower_triangle(got), 1, "float32") == (9428996,
                                                                                   1308672)


@pytest.mark.parametrize("nx", [5, 16, 24])
def test_poisson_and_ichol0_are_the_ports(nx):
    from repro_torch.sparse import ichol0, poisson2d_matrix

    want, got = poisson2d_matrix(nx), matrices.poisson2d_matrix(nx)
    for a in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(want, a), getattr(got, a))
    lw, lg = ichol0(want), matrices.ichol0(got)
    for a in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(lw, a), getattr(lg, a))


def test_levels_by_their_definition():
    m = matrices.erdos_renyi_lower(400, 2e-2, seed=5)
    want = np.zeros(m.n, dtype=np.int64)
    for i in range(m.n):
        cols = m.indices[m.indptr[i]:m.indptr[i + 1]]
        cols = cols[cols < i]
        want[i] = want[cols].max() + 1 if len(cols) else 0
    assert np.array_equal(levels(m), want)


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("m_rhs", [None, 1, 5])
def test_level_solve_against_dense(upper, m_rhs):
    L = matrices.erdos_renyi_lower(300, 2e-2, seed=7)
    A = matrices.transpose(L) if upper else L
    rng = np.random.default_rng(1)
    b = rng.standard_normal(300 if m_rhs is None else (300, m_rhs))
    x = LevelSolve(A, upper=upper)(torch.from_numpy(b)).numpy()
    want = scipy.linalg.solve_triangular(dense(A), b, lower=not upper)
    np.testing.assert_allclose(x, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_level_solve_in_a_lower_precision_reads_worse():
    L = matrices.erdos_renyi_lower(2000, 2e-3, seed=2)
    b = torch.randn(2000, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x = LevelSolve(L)(b)
    gap = {dt: float(((LevelSolve(L, dtype=dt)(b.to(dt)).double() - x).abs().amax(0)
                      / x.abs().amax(0)).max())
           for dt in (torch.float32, torch.bfloat16)}
    assert gap[torch.float32] < 1e-5 < 1e-3 < gap[torch.bfloat16]


def test_spmv_and_pcg_against_dense():
    A = matrices.poisson2d_matrix(12)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.n)
    np.testing.assert_allclose(Spmv(A)(torch.from_numpy(x)).numpy(), dense(A) @ x, rtol=1e-12)
    b = rng.standard_normal(A.n)
    pcg = Pcg(A, matrices.ichol0(A), dtype=torch.float64, device="cpu")
    x, it = pcg(torch.from_numpy(b), tol=1e-10, maxiter=500)
    assert 0 < it < 60  # plain CG needs about nx * 2
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(dense(A), b), rtol=1e-7, atol=1e-8)


def test_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (8, 9)]
    assert intervals.union(spans) == [[0, 3], [5, 6], [8, 9]]
    assert intervals.busy(spans) == 5
    assert intervals.gaps(spans, -1, 10) == [(-1, 0), (3, 5), (6, 8), (9, 10)]
    assert intervals.gaps(spans, 1, 5.5) == [(3, 5)]


def test_byte_counts_by_hand():
    # 3 x 3 lower triangle with 5 entries: 3 diagonal, (1, 0), (2, 1)
    L = matrices.csr_from_coo(3, [0, 1, 1, 2, 2], [0, 0, 1, 1, 2], [1.0, 2, 3, 4, 5])
    # values and columns 5 * (4 + 4), row pointers 4 * 4, b and x 2 * 3 * 4 per column
    assert roofline.solve_work(L, 1) == (40 + 16 + 24, 2 * 2 + 3)
    assert roofline.solve_work(L, 32) == (40 + 16 + 24 * 32, (2 * 2 + 3) * 32)
    # A = L + L^T off the diagonal: 7 entries; the factor has tril(A)'s 5
    A = matrices.csr_from_coo(3, [0, 1, 1, 2, 2, 0, 1], [0, 0, 1, 1, 2, 1, 2],
                              [4.0, -1, 4, -1, 4, -1, -1])
    a_bytes = 7 * 8 + 4 * 4
    l_bytes = 5 * 8 + 4 * 4
    assert roofline.pcg_iteration_work(A) == (a_bytes + 2 * l_bytes + 8 * 3 * 4,
                                              2 * 7 + 2 * (2 * 2 + 3) + 10 * 3)
    peak = {"bytes_per_s": 1e3, "fp32_flops": 1e3}
    assert roofline.bound_s((100, 10), peak) == (0.1, "bytes")
    assert roofline.bound_s((10, 100), peak) == (0.1, "operations")
    # float64: values, b and x 8 bytes; columns and row pointers still 4
    assert roofline.solve_work(L, 1, "float64") == (5 * 12 + 16 + 2 * 3 * 8, 2 * 2 + 3)
    assert roofline.solve_work(L, 32, "float64") == (5 * 12 + 16 + 2 * 3 * 8 * 32,
                                                     (2 * 2 + 3) * 32)
    assert roofline.pcg_iteration_work(A, "float64") == (
        (7 * 12 + 16) + 2 * (5 * 12 + 16) + 8 * 3 * 8, 2 * 7 + 2 * (2 * 2 + 3) + 10 * 3)
    assert roofline.solve_work(L, 1, "float32") == roofline.solve_work(L, 1)
    # float64 operations against the float64 rate
    peak64 = {**peak, "fp64_flops": 5e2}
    assert roofline.bound_s((100, 10), peak64, "float64") == (0.1, "bytes")
    assert roofline.bound_s((10, 100), peak64, "float64") == (0.2, "operations")
    assert roofline.bound_s((10, 100), peak64, "float32") == (0.1, "operations")
    with pytest.raises(KeyError):
        roofline.solve_work(L, 1, "bfloat16")  # a width the count does not know


def test_trace_reduction_on_a_trace_made_by_hand():
    from portbench import devtrace

    def ev(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [
        ev("user_annotation", devtrace.CALL, 0, 100), ev("user_annotation", devtrace.CALL, 110, 50),
        ev("cpu_op", "aten::index", 0, 30), ev("cuda_runtime", "cudaDeviceSynchronize", 60, 40),
        ev("kernel", "gather", 10, 10), ev("kernel", "sptrsv", 25, 50),
        ev("gpu_memcpy", "copy", 70, 10),  # overlaps the kernel: counts once
        ev("kernel", "sptrsv", 120, 20),
        ev("kernel", "between", 104, 4),  # in the segment, in no call
        ev("kernel", "outside", 200, 5),  # after the last call: not in the segment
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50},
    ]
    seg = devtrace.reduce(events)
    assert seg.calls == 2 and seg.window_s == 160e-6 and seg.device_events == 5
    assert seg.busy_s == pytest.approx((10 + 55 + 4 + 20) * 1e-6)
    assert seg.ops_per_call == [3, 1]
    assert seg.device_ops[0] == ["sptrsv", pytest.approx(70e-6)]
    # idle 0-10 and 20-25 (aten::index at their middles), 80-104 (the
    # synchronisation), 108-120 and 140-160 (the second call, no inner op)
    idle = dict(seg.idle_gaps)
    assert idle == {"aten::index": pytest.approx(15e-6),
                    "cudaDeviceSynchronize": pytest.approx(24e-6),
                    devtrace.CALL: pytest.approx(32e-6)}
    assert devtrace._name_gaps([(300, 310)], events[:2]) == [["between calls", 10e-6]]
