"""The front door's ordered solve on the CPU: what the bind hands the kernel.

On the card a ``kernel`` solve is one cooperative launch
(``kernels.sptrsv.sptrsv_ordered_cuda``) that takes b and returns x in the
caller's row order. What it is handed is fixed at bind, and these tests
hold it here:

  * ``kernels.ops.ordered_walk`` binds the solver's row permutation as
    int32, the bound level tensors and their chunk table as they are, for
    ER, NB and both IC(0) factors of a Poisson grid, bulk and elastic; a
    permutation that is not one raises;
  * the plain version of the ordered solve (``kernels.ref.sptrsv_ordered_ref``)
    is bitwise the CPU front door's gather -> level solve -> gather, one
    and m right-hand sides, f32 and f64;
  * ``bind_ordered_walk`` raises on the faults ``_check_level`` caught at
    every launch (wrong dtype, wrong device, not contiguous, wrong shape),
    and a solve checks b alone (dtype, device, shape, layout) before any
    launch;
  * the kernel bound declines the row order on the CPU
    (``describe()["front_door"] == "gather"``), takes it on the card (here
    its device test stood in for), keeps it through a value refresh,
    rebound over the new values, and gathers around ``solve`` for more
    right-hand sides than one launch takes.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.backends.kernel import KernelBoundSolve, _KernelBound
from repro_torch.kernels import ops, sptrsv
from repro_torch.kernels.ref import sptrsv_level_ref, sptrsv_ordered_ref
from repro_torch.solver.executor import pad_rhs
from repro_torch.sparse import erdos_renyi_lower, ichol0, narrow_band_lower, poisson2d_matrix

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
SLACK = 3


def _solver(name, mode="bsp", dtype=torch.float32):
    kw = dict(device="cpu", mode=mode, slack=SLACK if mode == "elastic" else 0, dtype=dtype)
    if name.startswith("poisson"):
        fwd, bwd = repro_torch.factor_pair(ichol0(poisson2d_matrix(24)), **kw)
        return fwd if name == "poisson_fwd" else bwd
    L = {"er": lambda: erdos_renyi_lower(1500, 2e-3, seed=3),
         "nb": lambda: narrow_band_lower(1500, 0.14, 10, seed=4)}[name]()
    return repro_torch.TriangularSolver.plan(L, **kw)


_CASES = [(name, mode) for name in ("er", "nb", "poisson_fwd", "poisson_bwd")
          for mode in ("bsp", "elastic")]


@pytest.mark.parametrize("name,mode", _CASES)
def test_ordered_walk_binds_the_row_permutation(name, mode):
    s = _solver(name, mode)
    la = s.bound._la
    walk = ops.ordered_walk(la, s._perm, elastic=mode == "elastic")
    perm = walk.tensors[7]
    assert perm.dtype == torch.int32 and perm.is_contiguous()
    assert torch.equal(perm.long(), s._perm) and walk.perm == perm.data_ptr()
    # the level tensors and the chunk table as bound, unchanged
    assert all(a is b for a, b in zip(walk.tensors[:7], la[:7]))
    ch = la.chunks
    assert walk.tensors[8:] == (ch.chunk_ptr, ch.level_chunk)
    assert walk.args == (*[t.data_ptr() for t in la[:6]], ch.chunk_ptr.data_ptr(),
                         ch.level_chunk.data_ptr(), la.level_ptr.numel() - 1,
                         la.col_idx.shape[1], ch.stage_bytes, ch.n_stages)
    prefix = "elastic_" if mode == "elastic" else ""
    assert (walk.single, walk.mrhs, walk.n) == (
        f"{prefix}ordered_single", f"{prefix}ordered_mrhs", s.n)


def test_a_row_order_that_is_not_a_permutation_raises():
    s = _solver("er")
    la = s.bound._la
    for perm in (torch.zeros(s.n, dtype=torch.int64),  # every row on caller row 0
                 torch.arange(s.n - 1),  # one row short
                 torch.arange(s.n) + 1):  # past the last row
        with pytest.raises(ValueError):
            ops.ordered_walk(la, perm)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [None, 4])
@pytest.mark.parametrize("name,mode", _CASES)
def test_ordered_plain_version_is_the_gather_path(name, mode, m, dtype):
    s = _solver(name, mode, _DTYPES[dtype])
    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.standard_normal(s.n if m is None else (s.n, m)),
                        dtype=_DTYPES[dtype])
    la = s.bound._la
    x = sptrsv_ordered_ref(*la[:7], s._perm.int(), b)
    gathered = sptrsv_level_ref(*la[:7], pad_rhs(b[s._perm]))[: s.n][s._inv]
    iv = torch.int32 if dtype == "float32" else torch.int64
    assert torch.equal(x.view(iv), gathered.view(iv))
    assert torch.equal(x.view(iv), s.solve(b).view(iv))  # the CPU front door


# ------------------------------------------------------- the bind's checks
def _walk_args(dtype=torch.float32):
    s = _solver("nb", dtype=dtype)
    ola = s.bound._la
    return s, ola, [*ola[:7], s._perm.int(), s.n]


def test_bind_ordered_walk_checks_once():
    s, ola, args = _walk_args()
    walk = sptrsv.bind_ordered_walk(*args, chunks=ola.chunks)
    assert (walk.single, walk.mrhs, walk.n) == ("ordered_single", "ordered_mrhs", s.n)
    assert walk.perm == args[7].data_ptr() and len(walk.args) == 12
    el = sptrsv.bind_ordered_walk(*args, chunks=ola.chunks, elastic=True)
    assert (el.single, el.mrhs) == ("elastic_ordered_single", "elastic_ordered_mrhs")
    meta = torch.device("meta")
    for i, bad, err in [
        (0, ola.row_ids.long(), TypeError),  # int64 indices
        (6, ola.level_ptr.long(), TypeError),  # int64 level bounds
        (4, ola.accum.float(), TypeError),  # float mask
        (3, ola.diag.double(), TypeError),  # diag against vals
        (2, ola.vals.half(), TypeError),  # no kernel for the type
        (7, s._perm, ValueError),  # perm int32 only
        (1, ola.col_idx.t(), ValueError),  # not contiguous
        (7, s._perm.int().flip(0)[::2], ValueError),  # not contiguous, short
        (3, ola.diag[:-1], ValueError),  # wrong shape
        (7, s._perm.int()[:-1], ValueError),  # perm one short
        (8, s.n + 1, ValueError),  # n not perm's
        (7, s._perm.int().to(meta), ValueError),  # wrong device
        (5, ola.vert_ptr.to(meta), ValueError),
        (7, s._perm.int().numpy(), TypeError),  # not a tensor
    ]:
        a = list(args)
        a[i] = bad
        with pytest.raises(err):
            sptrsv.bind_ordered_walk(*a, chunks=ola.chunks)
    ch = ola.chunks
    for bad in (ch._replace(chunk_ptr=ch.chunk_ptr.long()),
                ch._replace(level_chunk=ch.level_chunk[:-1]),
                ch._replace(chunk_ptr=ch.chunk_ptr.to(meta)),
                (ch.chunk_ptr, ch.level_chunk)):
        with pytest.raises((TypeError, ValueError)):
            sptrsv.bind_ordered_walk(*args, chunks=bad)


def test_ordered_solve_checks_b_before_any_launch():
    s, ola, args = _walk_args()
    walk = sptrsv.bind_ordered_walk(*args, chunks=ola.chunks)
    n = s.n
    sptrsv.reset_launches()
    for bad, err in [
        (torch.zeros(n, dtype=torch.float64), ValueError),  # dtype
        (torch.zeros(n + 1), ValueError),  # the scratch row is the walk's
        (torch.zeros(n, 3).t().contiguous().t(), ValueError),  # not contiguous
        (torch.zeros(n, 2, 2), ValueError),  # f[n] or f[n, m] only
        (torch.zeros(n, device="meta"), ValueError),  # another device
        (np.zeros(n, np.float32), TypeError),  # not a tensor
    ]:
        with pytest.raises(err):
            sptrsv.sptrsv_ordered_cuda(walk, bad)
    assert not any(sptrsv.launches.values())
    empty = sptrsv.sptrsv_ordered_cuda(walk, torch.zeros(n, 0))
    assert empty.shape == (n, 0) and not any(sptrsv.launches.values())


# ------------------------------------------------------------ the bound
def _as_on_the_card(monkeypatch):
    """The bound takes the row order as on the card: its device test
    passed over."""
    monkeypatch.setattr(_KernelBound, "take_row_order", _KernelBound._bind_row_order)


@pytest.mark.parametrize("mode", ["bsp", "elastic"])
def test_the_bound_takes_the_row_order_where_allowed(monkeypatch, mode):
    s = _solver("er", mode)
    d = s.bound.describe()
    assert d["front_door"] == "gather" and s.bound.front_door == "gather"
    s.bound.take_row_order(s._perm)
    assert s.bound.front_door == "gather" and s.bound._walk is None  # the CPU keeps the gathers
    _as_on_the_card(monkeypatch)
    s = _solver("er", mode)
    bound = s.bound
    assert bound.front_door == "ordered" and bound.describe()["front_door"] == "ordered"
    assert bound.describe()["device_bytes"] == d["device_bytes"] + 4 * s.n  # the int32 perm
    elastic = mode == "elastic"
    assert bound._walk.single == ("elastic_" if elastic else "") + "ordered_single"
    assert isinstance(bound, KernelBoundSolve) != elastic
    # a value refresh keeps the row order over the new values
    refreshed = bound.update_values(s.source_values * 2.0)
    assert refreshed.front_door == "ordered" and refreshed._perm is bound._perm
    assert refreshed._walk.tensors[2] is refreshed._la.vals is not bound._la.vals
    assert refreshed._walk.args[2] == refreshed._la.vals.data_ptr()
    assert torch.equal(refreshed._la.vals, bound._la.vals * 2.0)
    assert bound._walk.args[2] == bound._la.vals.data_ptr()
    # a solver's refresh and a cache clone keep it too
    s.numeric_update(s.source_values * 3.0)
    assert s.bound.front_door == "ordered" and s.bound is not bound
    assert s.clone_with_values(s.source_values).bound.front_door == "ordered"


def test_more_columns_than_one_launch_takes_gather(monkeypatch):
    """Past the blocks the card holds at once, the ordered bound solves in
    plan row order and scatters x back: the gather path's bits."""
    _as_on_the_card(monkeypatch)
    monkeypatch.setattr(repro_torch.backends.kernel, "ordered_columns", lambda walk: 3)
    s = _solver("nb")
    B = torch.as_tensor(np.random.default_rng(8).standard_normal((s.n, 4)), dtype=torch.float32)
    sptrsv.reset_launches()
    x = s.solve(B)
    gathered = s.bound.solve(B[s._perm])[s._inv]
    assert torch.equal(x.view(torch.int32), gathered.view(torch.int32))
    assert not any(sptrsv.launches.values())  # the CPU's plain version: no launch
