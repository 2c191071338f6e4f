"""The port's inspector copies are faithful: generators, DAG, schedule, §5
reorder and every ExecPlan array equal the JAX package's, in value and
dtype, on the conftest matrices (ER 700, NB 700, IC(0) of a 24x24 Poisson
grid) for k in {4, 8, 16} and width in {None, 3, 2} (width 2 forces
virtual accumulate rows)."""
import dataclasses
import functools

import numpy as np
import pytest

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch.core as tcore
import repro_torch.sparse as tsparse
from repro_torch.core.plan import plans_bitwise_equal
from repro_torch.convert import exec_plan_from_numpy

MATS = ("er", "nb", "ichol")
KS = (4, 8, 16)
WIDTHS = (None, 3, 2)


@functools.lru_cache(maxsize=None)
def _mats(name):
    """(JAX matrix, port matrix) made by each package's own generator."""
    if name == "er":
        return (jsparse.erdos_renyi_lower(700, 2e-3, seed=11),
                tsparse.erdos_renyi_lower(700, 2e-3, seed=11))
    if name == "nb":
        return (jsparse.narrow_band_lower(700, 0.14, 10, seed=12),
                tsparse.narrow_band_lower(700, 0.14, 10, seed=12))
    if name == "ichol":
        return (jsparse.ichol0(jsparse.poisson2d_matrix(24)),
                tsparse.ichol0(tsparse.poisson2d_matrix(24)))
    if name == "poisson3d":
        return jsparse.poisson3d_matrix(7), tsparse.poisson3d_matrix(7)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _scheduled(name, k):
    jL, tL = _mats(name)
    js = jcore.grow_local(jsparse.dag_from_lower_csr(jL), k)
    ts = tcore.grow_local(tsparse.dag_from_lower_csr(tL), k)
    return (jL, js, jcore.apply_reordering(jL, js)), (tL, ts, tcore.apply_reordering(tL, ts))


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what}: values differ"


def _assert_same_csr(a, b):
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    for f in ("indptr", "indices", "data"):
        _assert_same_array(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("name", MATS + ("poisson3d",))
def test_generators_match(name):
    jL, tL = _mats(name)
    _assert_same_csr(jL, tL)
    assert tsparse.pattern_fingerprint(tL) == jsparse.pattern_fingerprint(jL)


@pytest.mark.parametrize("name", MATS)
def test_csr_helpers_match(name):
    jL, tL = _mats(name)
    _assert_same_csr(jsparse.transpose_csr(jL), tsparse.transpose_csr(tL))
    full_j = jsparse.csr_from_coo(
        jL.n_rows, jL.n_cols,
        np.concatenate([jL.row_of_entry(), jL.indices]),
        np.concatenate([jL.indices, jL.row_of_entry()]),
        np.concatenate([jL.data, jL.data]),
    )
    full_t = tsparse.csr_from_coo(
        tL.n_rows, tL.n_cols,
        np.concatenate([tL.row_of_entry(), tL.indices]),
        np.concatenate([tL.indices, tL.row_of_entry()]),
        np.concatenate([tL.data, tL.data]),
    )
    _assert_same_csr(full_j, full_t)
    _assert_same_csr(jsparse.lower_triangle_of(full_j), tsparse.lower_triangle_of(full_t))
    perm = np.random.default_rng(3).permutation(jL.n_rows)
    _assert_same_csr(jsparse.permute_symmetric(jL, perm), tsparse.permute_symmetric(tL, perm))


@pytest.mark.parametrize("name", MATS)
def test_dag_matches(name):
    jL, tL = _mats(name)
    jd, td = jsparse.dag_from_lower_csr(jL), tsparse.dag_from_lower_csr(tL)
    assert jd.n == td.n
    for f in ("parent_ptr", "parent_idx", "child_ptr", "child_idx", "weights"):
        _assert_same_array(getattr(jd, f), getattr(td, f), f)
    from repro.sparse.dag import topological_levels

    _assert_same_array(topological_levels(jd), tsparse.topological_levels(td), "levels")


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", MATS)
def test_schedule_matches(name, k):
    (jL, js, _), (tL, ts, _) = _scheduled(name, k)
    assert (js.n, js.k, js.n_supersteps) == (ts.n, ts.k, ts.n_supersteps)
    for f in ("pi", "sigma", "rank"):
        _assert_same_array(getattr(js, f), getattr(ts, f), f)
    td = tsparse.dag_from_lower_csr(tL)
    tcore.check_validity(td, ts)
    assert tcore.bsp_cost(td, ts) == jcore.bsp_cost(jsparse.dag_from_lower_csr(jL), js)


@pytest.mark.parametrize("name", MATS)
def test_serial_schedule_matches(name):
    jL, tL = _mats(name)
    js = jcore.serial_schedule(jsparse.dag_from_lower_csr(jL))
    ts = tcore.serial_schedule(tsparse.dag_from_lower_csr(tL))
    for f in ("pi", "sigma", "rank"):
        _assert_same_array(getattr(js, f), getattr(ts, f), f)
    assert js.n_supersteps == ts.n_supersteps


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", MATS)
def test_reorder_matches(name, k):
    (_, _, jr), (_, _, tr) = _scheduled(name, k)
    jL2, js2, _, jre = jr
    tL2, ts2, _, tre = tr
    _assert_same_array(jre.perm, tre.perm, "perm")
    _assert_same_array(jre.inv, tre.inv, "inv")
    _assert_same_csr(jL2, tL2)
    for f in ("pi", "sigma", "rank"):
        _assert_same_array(getattr(js2, f), getattr(ts2, f), f)


PLAN_ARRAYS = ("row_ids", "col_idx", "vals", "diag", "accum", "step_bounds",
               "val_src", "diag_src")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", MATS)
def test_plan_matches(name, k, width):
    (_, _, jr), (_, _, tr) = _scheduled(name, k)
    jp = jcore.compile_plan(jr[0], jr[1], width=width)
    tp = tcore.compile_plan(tr[0], tr[1], width=width)
    assert (jp.n, jp.k, jp.W) == (tp.n, tp.k, tp.W)
    if width == 2 and name != "ichol":
        assert tp.accum.any(), "width 2 should force virtual accumulate rows"
    for f in PLAN_ARRAYS:
        _assert_same_array(getattr(jp, f), getattr(tp, f), f)
    # the conversion path the executor tests use is lossless too
    fields = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    assert plans_bitwise_equal(exec_plan_from_numpy(fields), tp)
    assert tp.stats() == {k_: v for k_, v in jp.stats().items() if k_ != "elastic"}


def test_plans_bitwise_equal_detects_difference():
    (_, _, _), (_, _, tr) = _scheduled("er", 8)
    a = tcore.compile_plan(tr[0], tr[1])
    b = tcore.compile_plan(tr[0], tr[1])
    assert plans_bitwise_equal(a, b)
    b.vals = b.vals.astype(np.float64)
    assert not plans_bitwise_equal(a, b)


def test_exec_plan_from_numpy_rejects_missing_fields():
    with pytest.raises(ValueError, match="missing"):
        exec_plan_from_numpy({"n": 1, "k": 1})


@pytest.mark.parametrize("shift", [0, 3, 6])
def test_shifted_coupling_lower_matches(shift):
    _assert_same_csr(jsparse.shifted_coupling_lower(203, shift, seed=4),
                     tsparse.shifted_coupling_lower(203, shift, seed=4))
    with pytest.raises(ValueError, match="shift"):
        tsparse.shifted_coupling_lower(64, 7)


@pytest.mark.parametrize("n,bandwidth,density", [(150, 4, 0.5), (64, 1, 1.0), (9, 0, 0.3)])
def test_random_spd_band_matches(n, bandwidth, density):
    _assert_same_csr(jsparse.random_spd_band(n, bandwidth, density, seed=2),
                     tsparse.random_spd_band(n, bandwidth, density, seed=2))


@pytest.mark.parametrize("name", MATS)
def test_dense_helpers_match(name):
    jL, tL = _mats(name)
    dense = tsparse.csr_to_dense(tL)
    _assert_same_array(jsparse.csr_to_dense(jL), dense, "csr_to_dense")
    _assert_same_csr(jsparse.csr_from_dense(dense), tsparse.csr_from_dense(dense))
    _assert_same_csr(tsparse.csr_from_dense(dense), tL)  # a round trip
