"""The port's plain executor against the JAX package, on ONE JAX-compiled
plan carried across with ``convert.exec_plan_from_numpy``:

  * plain solve == JAX ``solve_with_plan``, bitwise (f32), single RHS and
    m in {1, 5, 16};
  * ``kernels.ref.sptrsv_ref`` (one right-hand side) and the plain
    version of ``kernels.level_sweep``'s column-group walk (three, packed C
    to a group) == JAX ``sptrsv_pallas(interpret=True)`` within
    rtol=atol=1e-4 (the reference's own kernel tolerance,
    tests/test_kernels.py: the Pallas body tree-sums over W);
  * ``update_values`` == a fresh bind, and == the JAX scan bound's
    ``update_values``, bitwise (for the kernel backend also its level-order
    tensors, and on data holding explicit and signed zeros);
  * the kernel wrapper's input checks (m right-hand sides).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sparse as jsparse
from repro.backends import get_backend as jget_backend
from repro.kernels.ops import kernel_plan_arrays as jkernel_plan_arrays
from repro.kernels.sptrsv import sptrsv_pallas
from repro.solver.executor import plan_arrays as jplan_arrays
from repro.solver.executor import solve_with_plan as jsolve_with_plan
from repro_torch.backends import get_backend
from repro_torch.convert import exec_plan_from_numpy
from repro_torch.kernels import level_sweep
from repro_torch.kernels.ops import check_plan_indices, level_plan_arrays
from repro_torch.kernels.ref import sptrsv_ref
from repro_torch.kernels.sptrsv import sptrsv_level_cuda
from repro_torch.solver.executor import pad_rhs, plan_arrays, solve_with_plan


def _matrix(name):
    return {
        "er": lambda: jsparse.erdos_renyi_lower(700, 2e-3, seed=11),
        "nb": lambda: jsparse.narrow_band_lower(700, 0.14, 10, seed=12),
        "ichol": lambda: jsparse.ichol0(jsparse.poisson2d_matrix(24)),
    }[name]()


@functools.lru_cache(maxsize=None)
def _jax_plan(name, k, width):
    """(reordered JAX matrix, its schedule, JAX ExecPlan)."""
    L = _matrix(name)
    s = jcore.grow_local(jsparse.dag_from_lower_csr(L), k)
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    return L2, s2, jcore.compile_plan(L2, s2, width=width)


def _port_plan(jp):
    return exec_plan_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    )


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    nd = int((_bits(a) != _bits(b)).sum())
    assert nd == 0, f"{nd} of {a.size} entries differ (max |d| {np.abs(a - b).max()})"


def _rhs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if m is None else (n, m)).astype(np.float32)


@pytest.mark.parametrize("m", [None, 1, 5, 16])
@pytest.mark.parametrize("k,width", [(8, None), (4, 2), (16, 3)])
@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_plain_solve_bitwise_vs_jax(name, k, width, m):
    _, _, jp = _jax_plan(name, k, width)
    b = _rhs(jp.n, m)
    x_jax = np.asarray(jsolve_with_plan(jplan_arrays(jp), jnp.asarray(b)))
    x_port = solve_with_plan(plan_arrays(_port_plan(jp), device="cpu"), torch.from_numpy(b)).numpy()
    _assert_bitwise(x_jax, x_port)


_PALLAS_CASES = [(64, 0.05, 2, None), (200, 0.02, 4, 3), (450, 0.01, 8, 16), (300, 0.08, 16, 2)]


# the shapes of tests/test_kernels.py::test_kernel_matches_oracle_sweep; cols:
# None is the step walk on one right-hand side, C the plain version of
# kernels.level_sweep's column-group walk on three, packed C to a group
@pytest.mark.parametrize(
    "n,density,k,width,cols",
    [pytest.param(*case, None, id="-".join(map(str, case))) for case in _PALLAS_CASES]
    + [pytest.param(*case, cols, id="-".join(map(str, case)) + f"-groups{cols}")
       for case, cols in zip(_PALLAS_CASES, (1, 2, 4, 8))],
)
def test_sptrsv_ref_matches_pallas_interpret(n, density, k, width, cols):
    L = jsparse.erdos_renyi_lower(n, density, seed=n + k)
    s = jcore.grow_local(jsparse.dag_from_lower_csr(L), k)
    L2, s2, _, _ = jcore.apply_reordering(L, s)
    jp = jcore.compile_plan(L2, s2, width=width)
    b = _rhs(n, None) if cols is None else np.random.default_rng(n).standard_normal(
        (n, 3)).astype(np.float32)
    arrays = jkernel_plan_arrays(jp, steps_per_tile=4)
    b_pad = jnp.concatenate([jnp.asarray(b), jnp.zeros((1, *b.shape[1:]), jnp.float32)])
    x_pallas = np.asarray(sptrsv_pallas(*arrays, b_pad, steps_per_tile=4, interpret=True))
    if cols is None:
        pa = plan_arrays(_port_plan(jp), device="cpu")
        x_ref = sptrsv_ref(
            pa.row_ids, pa.col_idx, pa.vals, pa.diag, pa.accum, pad_rhs(torch.from_numpy(b))
        ).numpy()
    else:
        la = level_plan_arrays(_port_plan(jp), device="cpu")
        packed = level_sweep.pack_groups(pad_rhs(torch.from_numpy(b)), cols)
        x_ref = level_sweep.unpack_groups(level_sweep.sptrsv_groups_ref(*la[:7], packed),
                                          3).numpy()
    np.testing.assert_allclose(x_ref[:n], x_pallas[:n], rtol=1e-4, atol=1e-4)
    assert (x_ref[n] == 0.0).all()  # the scratch slot stays zero


def _values(L, seed):
    """New entry values on L's pattern (paper distribution magnitudes)."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(-2.0, 2.0, L.nnz)
    diag = L.indices == L.row_of_entry()
    data[diag] = np.sign(data[diag]) * (1.0 + np.abs(data[diag]))
    return data


@pytest.mark.parametrize("backend", ["scan", "kernel"])
@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_update_values_bitwise(name, backend):
    L2, s2, jp = _jax_plan(name, 8, 2)
    data = _values(L2, 7)
    bound = get_backend(backend).bind(_port_plan(jp), device="cpu")
    refreshed = bound.update_values(data)
    # a fresh bind of the plan compiled from the new values
    jp_new = jcore.compile_plan(dataclasses.replace(L2, data=data), s2, width=2)
    fresh = get_backend(backend).bind(_port_plan(jp_new), device="cpu")
    # and the JAX scan bound's own device-side refresh
    jbound = jget_backend("scan").bind(jp).update_values(data)
    for m in (None, 5):
        b = torch.from_numpy(_rhs(jp.n, m, seed=3))
        x = refreshed.solve(b).numpy()
        _assert_bitwise(x, fresh.solve(b).numpy())
        _assert_bitwise(x, np.asarray(jbound.solve(jnp.asarray(b.numpy()))))
    # the old bound is untouched
    _assert_bitwise(
        bound.solve(torch.from_numpy(_rhs(jp.n, None))).numpy(),
        np.asarray(jget_backend("scan").bind(jp).solve(jnp.asarray(_rhs(jp.n, None)))),
    )
    if backend == "kernel":
        # the single-RHS kernel's tensors, refreshed through the source maps
        # in level order, and data holding explicit and signed zeros
        for a, b in zip(refreshed._la[:7], fresh._la[:7]):
            assert torch.equal(a, b) and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        zeros = data.copy()
        zeros[::3] = np.where(np.arange(zeros[::3].size) % 2, -0.0, 0.0)
        zeros[L2.indices == L2.row_of_entry()] = data[L2.indices == L2.row_of_entry()]
        fresh0 = get_backend(backend).bind(
            _port_plan(jcore.compile_plan(dataclasses.replace(L2, data=zeros), s2, width=2)),
            device="cpu",
        )
        refreshed0 = refreshed.update_values(zeros)
        b = torch.from_numpy(_rhs(jp.n, None, seed=4))
        _assert_bitwise(refreshed0.solve(b).numpy(), fresh0.solve(b).numpy())
        for a, b in zip(refreshed0._la[2:4], fresh0._la[2:4]):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_update_values_rejects_wrong_length():
    _, _, jp = _jax_plan("er", 8, None)
    bound = get_backend("kernel").bind(_port_plan(jp), device="cpu")
    with pytest.raises(ValueError, match="entry data"):
        bound.update_values(np.ones(bound.n_entries + 1))


def test_describe_reports_binding():
    _, _, jp = _jax_plan("nb", 4, 3)
    d = get_backend("kernel").bind(_port_plan(jp), device="cpu").describe()
    assert d["backend"] == "kernel" and "steps_per_tile" not in d
    assert (d["n"], d["n_steps"], d["k"], d["W"]) == (jp.n, jp.n_steps, 4, 3)
    assert d["dtype"] == "float32" and d["device"] == "cpu"
    assert d["n_levels"] > 0
    scan = get_backend("scan").bind(_port_plan(jp), device="cpu").describe()
    assert d["device_bytes"] > scan["device_bytes"]  # the level-order tensors


def test_check_plan_indices_rejects_bad_plans():
    _, _, jp = _jax_plan("er", 8, None)
    p = _port_plan(jp)
    check_plan_indices(p)
    bad = dataclasses.replace(p, col_idx=p.col_idx.copy())
    bad.col_idx[0, 0, 0] = p.n + 1
    with pytest.raises(ValueError, match="col_idx"):
        check_plan_indices(bad)
    bad = dataclasses.replace(p, step_bounds=p.step_bounds[:-1].copy())
    with pytest.raises(ValueError, match="step_bounds"):
        check_plan_indices(bad)


def test_sptrsv_cuda_input_checks():
    # the bulk wrapper with m right-hand sides, over the bulk level order
    _, _, jp = _jax_plan("er", 8, None)
    plan = _port_plan(jp)
    la = level_plan_arrays(plan, device="cpu")
    b_pad = pad_rhs(torch.from_numpy(_rhs(jp.n, 5)))
    args = [*la[:7], b_pad]
    for i, bad, err in [
        (0, la.row_ids.long(), TypeError),  # int64 indices
        (4, la.accum.float(), TypeError),  # float mask
        (7, b_pad.double(), TypeError),  # dtype mismatch with vals
        (1, la.col_idx.t(), ValueError),  # not contiguous
        (3, la.diag[:-1], ValueError),  # wrong shape
    ]:
        a = list(args)
        a[i] = bad
        with pytest.raises(err):
            sptrsv_level_cuda(*a)
    x = sptrsv_level_cuda(*args)
    pa = plan_arrays(plan, device="cpu")
    _assert_bitwise(x.numpy(), sptrsv_ref(*pa[:5], b_pad).numpy())


def test_one_shot_solvers_agree_on_cpu():
    from repro_torch.kernels.ops import sptrsv_kernel_solve
    from repro_torch.solver.executor import make_solver

    _, _, jp = _jax_plan("nb", 8, None)
    p = _port_plan(jp)
    B = _rhs(jp.n, 3, seed=8)
    x = make_solver(p, device="cpu")(B).numpy()
    _assert_bitwise(x, sptrsv_kernel_solve(p, B, device="cpu").numpy())
    _assert_bitwise(x, np.asarray(jsolve_with_plan(jplan_arrays(jp), jnp.asarray(B))))


def test_custom_backend_registers_and_unregisters():
    from repro_torch.backends import (
        ScanBackend,
        available_backends,
        bind,
        register_backend,
        unregister_backend,
    )

    class Mirror(ScanBackend):
        name = "mirror"

    register_backend(Mirror)
    try:
        with pytest.raises(ValueError, match="already registered"):
            register_backend(Mirror)
        _, _, jp = _jax_plan("er", 4, None)
        b = torch.from_numpy(_rhs(jp.n, None))
        x = bind("mirror", _port_plan(jp), device="cpu").solve(b)
        _assert_bitwise(x.numpy(), bind("scan", _port_plan(jp), device="cpu").solve(b).numpy())
    finally:
        unregister_backend("mirror")
    assert "mirror" not in available_backends()
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("mirror")
