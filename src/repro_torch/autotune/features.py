"""Layer 1 of the autotuner: cheap DAG/matrix feature extraction.

The strategy selector (``autotune.selector``) never looks at the matrix
itself — it reasons over a handful of scalar features of the solve DAG
that together pin down the scheduling regime (paper §6.2's data-set axes):

  * size            — ``n``, ``nnz``, ``n_edges``
  * depth           — level-set depth (= #wavefronts = longest path), the
                      hard lower bound on barrier-synchronized supersteps
  * wavefront shape — average / maximum wavefront width: how much
                      parallelism each level actually exposes
  * row-length skew — max/mean row nnz: load-balance hazard for
                      wavefront-style schedulers
  * bandwidth       — max / mean distance |i - j| of off-diagonal entries:
                      the locality axis (§6.2.5 narrow-band family)

Everything is one ``topological_levels`` sweep plus O(nnz) reductions —
orders of magnitude cheaper than any scheduler — and is computed once per
sparsity fingerprint (``matrix_features`` memoizes; schedulers and the
plan cache already key on the same fingerprint).

All features except the bandwidth pair are invariants of the DAG up to
relabeling, so they are preserved by any topological reorder — in
particular the §5 locality reorder (``features.invariant()`` returns
exactly that subset; the JAX package's ``tests/test_autotune.py``
asserts it, and ``tests/test_torch_autotune.py`` holds this copy equal to
it). Bandwidth is a property of the current row numbering and is
deliberately *not* invariant: it is what the §5 reorder improves.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, pattern_fingerprint
from repro_torch.sparse.dag import SolveDAG, dag_from_lower_csr, topological_levels


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Scalar summary of a solve DAG. See the module docstring for the
    meaning of each axis; ``invariant()`` is the relabeling-invariant
    subset the permutation-invariance property is stated over."""

    n: int
    nnz: int  # total stored entries incl. the diagonal
    n_edges: int  # strictly-lower entries = DAG edges
    depth: int  # level-set depth (#wavefronts)
    avg_wavefront: float  # n / depth — paper §6.2's parallelizability proxy
    max_wavefront: int
    row_nnz_mean: float
    row_nnz_max: int
    row_skew: float  # row_nnz_max / row_nnz_mean (>= 1)
    bandwidth: int  # max (i - j) over strictly-lower entries; 0 if none
    mean_band: float  # mean (i - j) over strictly-lower entries; 0 if none

    @property
    def density(self) -> float:
        """Fraction of the strictly-lower triangle that is populated."""
        slots = self.n * (self.n - 1) / 2
        return self.n_edges / slots if slots else 0.0

    def invariant(self) -> dict:
        """The features preserved by any symmetric topological reorder
        (DAG isomorphism invariants) — everything except the bandwidth
        pair, which depends on the row numbering itself."""
        d = dataclasses.asdict(self)
        d.pop("bandwidth")
        d.pop("mean_band")
        return d

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def dag_features(dag: SolveDAG) -> MatrixFeatures:
    """Extract features from a solve DAG (one Kahn sweep + O(|E|) math)."""
    n = dag.n
    if n == 0:
        return MatrixFeatures(
            n=0, nnz=0, n_edges=0, depth=0, avg_wavefront=0.0,
            max_wavefront=0, row_nnz_mean=0.0, row_nnz_max=0, row_skew=1.0,
            bandwidth=0, mean_band=0.0,
        )
    levels = topological_levels(dag)
    widths = np.bincount(levels)
    depth = len(widths)
    # DAG weights are row nnz (incl. diagonal) by construction (§2.2)
    w = dag.weights
    row_mean = float(w.mean())
    # edge list (v = row, u = column of a strictly-lower entry)
    v_of_edge = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(dag.parent_ptr)
    )
    dist = v_of_edge - dag.parent_idx
    return MatrixFeatures(
        n=n,
        nnz=int(w.sum()),
        n_edges=dag.n_edges,
        depth=depth,
        avg_wavefront=n / depth,
        max_wavefront=int(widths.max()),
        row_nnz_mean=row_mean,
        row_nnz_max=int(w.max()),
        row_skew=float(w.max() / row_mean),
        bandwidth=int(dist.max()) if len(dist) else 0,
        mean_band=float(dist.mean()) if len(dist) else 0.0,
    )


# process-global, so FIFO-capped: a long-lived server streaming distinct
# sparsity patterns must not accumulate features forever (each entry is a
# dozen scalars; the cap is generous)
_CACHE_LOCK = threading.Lock()
_CACHE_MAX = 8192
_FEATURE_CACHE: Dict[str, MatrixFeatures] = {}


def matrix_features(
    a: CSRMatrix, *, dag: Optional[SolveDAG] = None
) -> MatrixFeatures:
    """Features of lower-triangular ``a``, memoized per sparsity
    fingerprint (values never matter — features are pure pattern
    properties). Pass ``dag`` if the caller already built it."""
    fp = pattern_fingerprint(a)
    with _CACHE_LOCK:
        cached = _FEATURE_CACHE.get(fp)
    if cached is not None:
        return cached
    f = dag_features(dag if dag is not None else dag_from_lower_csr(a))
    with _CACHE_LOCK:
        while len(_FEATURE_CACHE) >= _CACHE_MAX:
            _FEATURE_CACHE.pop(next(iter(_FEATURE_CACHE)))
        _FEATURE_CACHE[fp] = f
    return f


def clear_feature_cache() -> None:
    with _CACHE_LOCK:
        _FEATURE_CACHE.clear()
