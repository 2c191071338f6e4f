"""Layer 3 of the autotuner: the named scenario corpus.

One shared, named set of lower-triangular test matrices spanning every
scheduling regime the paper's data sets exercise (§6.2) plus the
pathological DAG shapes the selector must not mispick on:

  * Erdős–Rényi sparse / dense        (§6.2.4 — shallow-wide vs mixed)
  * narrow-band, two (p, B) points    (§6.2.5 — deep, locality-friendly)
  * IC(0) factors of Poisson 2D / 3D  (§6.2.1/§6.2.3 FEM stand-ins)
  * chain / star / independent DAGs   (worst cases: zero parallelism,
                                       two-level fan-out, fully parallel)

Each entry carries *expected-regime metadata* — the selector's
``classify`` label and the fixed strategies expected to be near-optimal —
so the selector's calibration, the conformance suite and
``benchmarks/table7x_auto.py`` all reason about the same ground truth.
Matrices are sized for a CPU test run (n ≈ 400–800); the generators
scale the same way the benchmark data sets do (benchmarks/common.py).
A copy of the JAX package's ``autotune/corpus.py``, built on the port's
own generators and ``ichol0``: equal seeds give equal CSR arrays
(``tests/test_torch_autotune.py``).

A second, N >= 1e5 *scale tier* (``scale_corpus_names`` /
``scale_corpus_entry``) holds the same families scaled to 100k rows —
ER keeps the expected row degree, the band keeps its (p, B). It
deliberately does NOT join ``corpus_names()``: the default corpus feeds
the conformance grid and the serve load generator, which would take the
100k inspector+compile hit in every cell. The scale tier is consumed by
the selector's scale-stability test (the ROADMAP N>=1e5 recalibration)
and ``benchmarks/inspector_bench.py``.

Pathological generators keep |off-diagonal| / |diagonal| ≤ 0.45 so
forward substitution is well conditioned even on an n-long chain
(error growth ~ 0.45^distance instead of the paper value distribution's
up-to-4x per step, which would swamp an f32 conformance check).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo, lower_triangle_of
from repro_torch.sparse.generators import (
    erdos_renyi_lower,
    narrow_band_lower,
    poisson2d_matrix,
    poisson3d_matrix,
)
from repro_torch.sparse.ichol import ichol0


def _stable_values(
    rng: np.random.Generator, n_off: int, n_diag: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Off-diagonal ~ U[-0.45, 0.45], diagonal sign·U[1, 2] — contraction
    along every dependency path (see module docstring)."""
    off = rng.uniform(-0.45, 0.45, size=n_off)
    diag = rng.uniform(1.0, 2.0, size=n_diag) * rng.choice(
        [-1.0, 1.0], size=n_diag
    )
    return off, diag


def chain_lower(n: int, *, seed: int = 0) -> CSRMatrix:
    """Pure dependency chain: row i needs row i-1. Depth n, width 1 —
    the zero-parallelism worst case where 'serial' must win."""
    rng = np.random.default_rng(seed)
    rows = np.arange(1, n, dtype=np.int64)
    cols = rows - 1
    off, diag = _stable_values(rng, len(rows), n)
    ar = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    ac = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    av = np.concatenate([off, diag])
    return csr_from_coo(n, n, ar, ac, av)


def star_lower(n: int, *, seed: int = 0) -> CSRMatrix:
    """Star: every row depends only on row 0. Depth 2, one huge second
    wavefront — a fan-out stress test for load balancing."""
    rng = np.random.default_rng(seed)
    rows = np.arange(1, n, dtype=np.int64)
    cols = np.zeros(n - 1, dtype=np.int64)
    off, diag = _stable_values(rng, len(rows), n)
    ar = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    ac = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    av = np.concatenate([off, diag])
    return csr_from_coo(n, n, ar, ac, av)


def independent_lower(n: int, *, seed: int = 0) -> CSRMatrix:
    """Diagonal-only: n independent rows, depth 1 — the fully parallel
    wide-DAG extreme (any one-superstep schedule is optimal)."""
    rng = np.random.default_rng(seed)
    _, diag = _stable_values(rng, 0, n)
    idx = np.arange(n, dtype=np.int64)
    return csr_from_coo(n, n, idx, idx, diag)


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    """A named scenario: matrix factory + expected-regime metadata."""

    name: str
    make: Callable[[], CSRMatrix]
    regime: str  # selector.classify() label this matrix should get
    expected_best: Tuple[str, ...]  # fixed strategies expected near-optimal
    description: str

    def matrix(self) -> CSRMatrix:
        return _corpus_matrix(self.name)


_ENTRIES: Dict[str, CorpusEntry] = {}


def _entry(name, make, regime, expected_best, description):
    _ENTRIES[name] = CorpusEntry(
        name=name, make=make, regime=regime,
        expected_best=tuple(expected_best), description=description,
    )


# ``regime`` is the ``selector.classify`` label the matrix must get;
# ``expected_best`` lists the fixed strategies whose default-options BSP
# cost is within ~10% of the best fixed strategy at k=8 (measured at
# these CPU sizes — the JAX package's tests/test_autotune.py re-derives
# and checks).
# -- §6.2.4 Erdős–Rényi -----------------------------------------------------
_entry(
    "er_sparse", lambda: erdos_renyi_lower(800, 0.002, seed=101),
    regime="wide",
    expected_best=("hdagg",),
    description="ER n=800 p=0.002 — shallow, wide, nearly independent rows",
)
_entry(
    "er_dense", lambda: erdos_renyi_lower(500, 0.03, seed=102),
    regime="mixed",
    expected_best=("growlocal", "funnel-gl", "serial"),
    description="ER n=500 p=0.03 — deeper DAG, heavy rows near the bottom",
)
# -- §6.2.5 narrow band -----------------------------------------------------
_entry(
    "band_narrow", lambda: narrow_band_lower(800, 0.14, 10, seed=103),
    regime="banded",
    expected_best=("serial", "growlocal"),
    description="band n=800 p=0.14 B=10 — deep chain-of-blocks, good locality",
)
_entry(
    "band_wide", lambda: narrow_band_lower(800, 0.03, 42, seed=104),
    regime="banded",
    expected_best=("serial",),
    description="band n=800 p=0.03 B=42 — wider band, moderate depth",
)
# -- §6.2.1/§6.2.3 FEM stand-ins -------------------------------------------
_entry(
    "poisson2d_ichol", lambda: ichol0(poisson2d_matrix(26)),
    regime="banded",
    expected_best=("growlocal", "funnel-gl", "serial"),
    description="IC(0) of 26x26 Poisson — the PCG workload's own factor",
)
_entry(
    "poisson3d_ichol", lambda: ichol0(poisson3d_matrix(9)),
    regime="banded",
    expected_best=("growlocal", "funnel-gl", "serial"),
    description="IC(0) of 9^3 Poisson — 3D connectivity, wider wavefronts",
)
# -- pathological DAG shapes ------------------------------------------------
_entry(
    "chain", lambda: chain_lower(400, seed=105),
    regime="serial",
    expected_best=("serial", "growlocal", "funnel-gl"),
    description="pure chain n=400 — zero parallelism; barriers only hurt",
)
_entry(
    "star", lambda: star_lower(600, seed=106),
    regime="wide",
    expected_best=("hdagg", "spmp", "wavefront"),
    description="star n=600 — depth 2, one huge fan-out wavefront",
)
_entry(
    "independent", lambda: independent_lower(600, seed=107),
    regime="wide",
    expected_best=("hdagg", "spmp", "wavefront"),
    description="diagonal n=600 — depth 1, embarrassingly parallel",
)


# -- N >= 1e5 scale tier (see module docstring) -----------------------------
# ``expected_best`` here is indicative (the regime's shortlist leaders),
# not re-derived at scale by the CPU tests — scheduling 100k-row
# matrices across all 7 strategies is benchmark territory, not tier-1.
_SCALE_N = 100_000
_SCALE_ENTRIES: Dict[str, CorpusEntry] = {}


def _scale_entry(name, make, regime, expected_best, description):
    _SCALE_ENTRIES[name] = CorpusEntry(
        name=name, make=make, regime=regime,
        expected_best=tuple(expected_best), description=description,
    )


_scale_entry(
    "er_sparse_100k",
    lambda: erdos_renyi_lower(_SCALE_N, 0.002 * 800 / _SCALE_N, seed=201),
    regime="wide",
    expected_best=("hdagg",),
    description="ER n=100k, row degree matched to er_sparse — shallow, wide",
)
_scale_entry(
    "er_dense_100k",
    lambda: erdos_renyi_lower(_SCALE_N, 0.03 * 500 / _SCALE_N, seed=202),
    regime="wide",
    expected_best=("hdagg", "growlocal"),
    description="ER n=100k, row degree matched to er_dense — deep but every "
    "level is thousands wide, so barriers amortize at this scale",
)
_scale_entry(
    "band_narrow_100k",
    lambda: narrow_band_lower(_SCALE_N, 0.14, 10, seed=203),
    regime="banded",
    expected_best=("growlocal", "serial"),
    description="band n=100k p=0.14 B=10 — same (p, B) as band_narrow; "
    "thousands of wavefronts, locality-bound",
)
_scale_entry(
    "poisson2d_100k",
    lambda: lower_triangle_of(poisson2d_matrix(317)),
    regime="banded",
    expected_best=("growlocal", "funnel-gl", "serial"),
    description="lower triangle of 317x317 Poisson (n=100489) — FEM-style "
    "banded structure at paper scale",
)
_scale_entry(
    "chain_100k",
    lambda: chain_lower(_SCALE_N, seed=205),
    regime="serial",
    expected_best=("serial", "growlocal"),
    description="pure chain n=100k — zero parallelism at any scale",
)
_scale_entry(
    "independent_100k",
    lambda: independent_lower(_SCALE_N, seed=207),
    regime="wide",
    expected_best=("hdagg", "spmp", "wavefront"),
    description="diagonal n=100k — depth 1, embarrassingly parallel",
)


@lru_cache(maxsize=None)
def _corpus_matrix(name: str) -> CSRMatrix:
    entry = _ENTRIES.get(name) or _SCALE_ENTRIES[name]
    return entry.make()


def corpus_names() -> Tuple[str, ...]:
    return tuple(_ENTRIES)


def corpus_entries() -> Tuple[CorpusEntry, ...]:
    return tuple(_ENTRIES.values())


def corpus_entry(name: str) -> CorpusEntry:
    try:
        return _ENTRIES[name]
    except KeyError:
        raise KeyError(
            f"unknown corpus matrix {name!r}; available: {corpus_names()}"
        ) from None


def scale_corpus_names() -> Tuple[str, ...]:
    return tuple(_SCALE_ENTRIES)


def scale_corpus_entries() -> Tuple[CorpusEntry, ...]:
    return tuple(_SCALE_ENTRIES.values())


def scale_corpus_entry(name: str) -> CorpusEntry:
    try:
        return _SCALE_ENTRIES[name]
    except KeyError:
        raise KeyError(
            f"unknown scale-corpus matrix {name!r}; available: "
            f"{scale_corpus_names()}"
        ) from None
