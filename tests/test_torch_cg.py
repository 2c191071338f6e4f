"""The port's conjugate gradient and IC(0)-preconditioned CG against the
JAX package (CPU; JAX is the oracle), and its copies of the serial
reference solvers.

  * CG's matvec (``_csr_matvec_fn``, the bound SpMV operator) within
    rtol 1e-5 (float32) / 1e-12 (float64) of the JAX ``segment_sum``;
  * one preconditioner application ``bwd(fwd(r))`` bitwise the JAX
    ``factor_pair(..., strategy="growlocal")`` pair's, on both port
    backends;
  * ``cg_solve`` and ``pcg_ichol`` on ``poisson2d_matrix(24)``: the CG inner
    products are reductions outside the bitwise contract (torch's order
    here, ``jnp.vdot``'s there), so iteration counts are held equal in
    float64 and within ±1 in float32, ``relres < tol``, and x allclose at
    rtol = atol = 5e-3 (tests/test_solvers.py::test_pcg_end_to_end's
    bound); PCG takes fewer iterations than CG;
  * plan-cache counts (the selection memo's included), the ``info`` keys
    and supersteps;
  * ``pcg_ichol``'s default strategy, ``"auto"`` as in the JAX package: on
    a 16 × 16 grid in float64 the same ``fwd_strategy``, ``bwd_strategy``
    and iteration count as the JAX function with its defaults;
  * ``forward_substitution`` array-equal, ``solve_lower_scipy`` equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsparse
from repro.pipeline import PlanCache as JPlanCache
from repro.pipeline import factor_pair as jfactor_pair
from repro.solver import cg_solve as jcg_solve
from repro.solver import forward_substitution as jforward
from repro.solver import pcg_ichol as jpcg_ichol
from repro.solver import solve_lower_scipy as jsolve_lower_scipy
from repro.solver.cg import _csr_matvec_fn as j_matvec_fn
from repro_torch import PlanCache, factor_pair
from repro_torch.kernels import spmv, sptrsv
from repro_torch.solver import cg_solve, forward_substitution, pcg_ichol, solve_lower_scipy
from repro_torch.solver.cg import _csr_matvec_fn
import repro_torch.sparse as tsparse

N_GRID = 24
TOL = 1e-5
_JDT = {"float32": jnp.float32, "float64": jnp.float64}
_TDT = {"float32": torch.float32, "float64": torch.float64}


def _port(m):
    return tsparse.CSRMatrix(m.n_rows, m.n_cols, m.indptr, m.indices, m.data)


def _rhs(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n)


@functools.lru_cache(maxsize=None)
def _jax_runs(dtype):
    """JAX PCG (growlocal, as the port) and plain CG on the grid."""
    A = jsparse.poisson2d_matrix(N_GRID)
    b = _rhs(A.n_rows)
    with jax.enable_x64(dtype == "float64"):
        pcg = jpcg_ichol(A, b, k=4, strategy="growlocal", tol=TOL, maxiter=600,
                         dtype=_JDT[dtype], cache=JPlanCache())
        cg = jcg_solve(A, b, tol=TOL, maxiter=5000, dtype=_JDT[dtype])
    return pcg, cg


@functools.lru_cache(maxsize=None)
def _port_runs(dtype, backend="kernel"):
    A = tsparse.poisson2d_matrix(N_GRID)
    b = _rhs(A.n_rows)
    pcg = pcg_ichol(A, b, k=4, strategy="growlocal", tol=TOL, maxiter=600,
                    dtype=_TDT[dtype], cache=PlanCache(), device="cpu", backend=backend)
    cg = cg_solve(A, b, tol=TOL, maxiter=5000, dtype=_TDT[dtype], device="cpu")
    return pcg, cg


def _iters_agree(ours, theirs, dtype):
    # float64: the same count; float32: the dots' order may move it by one
    assert abs(ours - theirs) <= (0 if dtype == "float64" else 1), (ours, theirs)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("name", ["poisson", "er", "spd_band"])
def test_matvec_matches_jax(name, dtype, rtol):
    A = {"poisson": lambda: jsparse.poisson2d_matrix(13),
         "er": lambda: jsparse.erdos_renyi_lower(300, 0.03, seed=2),
         "spd_band": lambda: jsparse.random_spd_band(200, 6, 0.5, seed=1)}[name]()
    p = _rhs(A.n_cols, seed=5)
    with jax.enable_x64(dtype == "float64"):
        y_jax = np.asarray(j_matvec_fn(A, _JDT[dtype])(jnp.asarray(p, _JDT[dtype])))
    y = _csr_matvec_fn(_port(A), _TDT[dtype], "cpu")(p)
    assert y.dtype == _TDT[dtype] and y.shape == (A.n_rows,)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_preconditioner_bitwise_vs_jax(dtype, backend):
    jA = jsparse.poisson2d_matrix(N_GRID)
    jL = jsparse.ichol0(jA)
    r = _rhs(jA.n_rows, seed=9)
    with jax.enable_x64(dtype == "float64"):
        jfwd, jbwd = jfactor_pair(jL, strategy="growlocal", k=4, dtype=_JDT[dtype])
        z_jax = np.asarray(jbwd(jfwd(jnp.asarray(r, _JDT[dtype]))))
    fwd, bwd = factor_pair(tsparse.ichol0(tsparse.poisson2d_matrix(N_GRID)), k=4,
                           dtype=_TDT[dtype], device="cpu", backend=backend)
    z = bwd(fwd(r)).numpy()
    assert z.dtype == z_jax.dtype
    assert np.array_equal(z.view(np.uint8), z_jax.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_solve_matches_jax(dtype):
    x_j, it_j, _ = _jax_runs(dtype)[1]
    x, it, relres = _port_runs(dtype)[1]
    assert x.dtype == _TDT[dtype] and x.device.type == "cpu"
    assert relres < TOL
    _iters_agree(it, it_j, dtype)
    np.testing.assert_allclose(x.numpy(), x_j, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pcg_ichol_matches_jax(dtype):
    (x_j, it_j, _, info_j), _ = _jax_runs(dtype)
    (x, it, relres, info), (x_cg, it_cg, _) = _port_runs(dtype)
    assert x.dtype == _TDT[dtype] and x.device.type == "cpu"
    assert relres < TOL
    _iters_agree(it, it_j, dtype)
    assert it < it_cg, "the preconditioner must accelerate CG"
    np.testing.assert_allclose(x.numpy(), x_j, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(x.numpy(), x_cg.numpy(), rtol=5e-3, atol=5e-3)
    # the true residual, in float64 on the host
    A = tsparse.poisson2d_matrix(N_GRID).to_scipy()
    b = _rhs(A.shape[0])
    assert np.linalg.norm(b - A @ x.double().numpy()) / np.linalg.norm(b) < 10 * TOL


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pcg_info_matches_jax(dtype):
    (_, _, _, info_j), _ = _jax_runs(dtype)
    (_, _, _, info), _ = _port_runs(dtype)
    assert set(info) == set(info_j)
    for key in ("fwd_supersteps", "bwd_supersteps", "fwd_strategy", "bwd_strategy"):
        assert info[key] == info_j[key], key
    for side in ("fwd_plan", "bwd_plan"):
        assert info[side] == {k: v for k, v in info_j[side].items() if k != "elastic"}
    assert info["cache"] == info_j["cache"] == {
        "hits": 0, "misses": 2, "numeric_updates": 0, "evictions": 0,
        "selections": 0, "selection_hits": 0}


def test_pcg_backends_agree_bitwise():
    # on the CPU both backends run plain versions with the same bits, so
    # the whole PCG run is the same
    (x_k, it_k, rr_k, _), _ = _port_runs("float32")
    (x_s, it_s, rr_s, _), _ = _port_runs("float32", "scan")
    assert (it_k, rr_k) == (it_s, rr_s) and torch.equal(x_k, x_s)


def test_pcg_cache_amortizes_and_counts_no_launches_on_cpu():
    A = tsparse.poisson2d_matrix(12)
    cache = PlanCache()
    sptrsv.reset_launches()
    spmv.reset_launches()
    out = [pcg_ichol(A, _rhs(A.n_rows, seed=s), k=4, tol=TOL, cache=cache, device="cpu")
           for s in range(3)]
    info = out[-1][3]
    assert info["cache"]["misses"] == 2 and info["cache"]["hits"] == 4
    assert all(relres < TOL for _, _, relres, _ in out)
    # plain versions on the CPU: no kernel launch is counted
    assert not any(sptrsv.launches.values()) and spmv.launches == {"spmv": 0}


def test_pcg_strategy_auto_raises():
    # "auto" no longer raises now that the autotuner is ported: any
    # spelling resolves through it; an unknown name still raises
    A = tsparse.poisson2d_matrix(6)
    cache = PlanCache()
    runs = [pcg_ichol(A, np.ones(A.n_rows), strategy=s, device="cpu", cache=cache)
            for s in ("auto", "Auto")]
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    assert runs[1][3]["cache"]["selections"] == 2
    assert runs[1][3]["cache"]["selection_hits"] == 2
    with pytest.raises(KeyError, match="unknown strategy"):
        pcg_ichol(A, np.ones(A.n_rows), strategy="autox", device="cpu")


def test_pcg_default_strategy_matches_jax():
    assert pcg_ichol.__kwdefaults__["strategy"] == "auto"
    A_j = jsparse.poisson2d_matrix(16)
    A = tsparse.poisson2d_matrix(16)
    b = _rhs(A.n_rows, seed=6)
    with jax.enable_x64(True):
        _, it_j, _, info_j = jpcg_ichol(A_j, b, dtype=jnp.float64)
    _, it, relres, info = pcg_ichol(A, b, dtype=torch.float64, device="cpu")
    for key in ("fwd_strategy", "bwd_strategy", "fwd_supersteps", "bwd_supersteps"):
        assert info[key] == info_j[key], key
    assert it == it_j and relres < 1e-6


def test_cg_stops_at_maxiter_and_on_zero_rhs():
    A = tsparse.poisson2d_matrix(10)
    x, it, relres = cg_solve(A, _rhs(A.n_rows), tol=1e-12, maxiter=3, device="cpu")
    assert it == 3 and relres > 1e-12
    x, it, relres = cg_solve(A, np.zeros(A.n_rows), device="cpu")
    assert it == 0 and relres == 0.0 and not x.any()


@pytest.mark.parametrize("name", ["er", "nb", "ichol"])
def test_reference_solvers_match_jax(name, er_matrix, nb_matrix, ichol_matrix):
    jL = {"er": er_matrix, "nb": nb_matrix, "ichol": ichol_matrix}[name]
    b = _rhs(jL.n_rows, seed=4)
    x = forward_substitution(_port(jL), b)
    x_j = jforward(jL, b)
    assert x.dtype == x_j.dtype and np.array_equal(x, x_j)
    np.testing.assert_array_equal(solve_lower_scipy(_port(jL), b), jsolve_lower_scipy(jL, b))
    np.testing.assert_allclose(x, solve_lower_scipy(_port(jL), b), rtol=1e-9, atol=1e-9)
