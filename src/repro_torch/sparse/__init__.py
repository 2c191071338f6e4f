"""Sparse-matrix substrate: CSR structures, generators, IC(0), DAG utilities.

All of this is "inspector side": pure numpy, runs on the host, amortized over
many solves (cf. paper §7.7); ``io`` reads and writes Matrix Market. It is a copy of the JAX package's
``repro.sparse``, so the port imports nothing of that package; the copies
are held bitwise-equal to the originals by ``tests/test_torch_inspector.py``.
"""
from repro_torch.sparse.csr import (
    CSRMatrix,
    csr_from_coo,
    csr_from_dense,
    csr_to_dense,
    lower_triangle_of,
    pattern_fingerprint,
    permute_symmetric,
    transpose_csr,
)
from repro_torch.sparse.dag import (
    SolveDAG,
    dag_from_edges,
    dag_from_lower_csr,
    gather_ranges,
    topological_levels,
)
from repro_torch.sparse.generators import (
    erdos_renyi_lower,
    narrow_band_lower,
    poisson2d_matrix,
    poisson3d_matrix,
    random_spd_band,
    shifted_coupling_lower,
)
from repro_torch.sparse.ichol import ichol0
from repro_torch.sparse.io import read_matrix_market, write_matrix_market

__all__ = [
    "CSRMatrix",
    "csr_from_coo",
    "csr_from_dense",
    "csr_to_dense",
    "lower_triangle_of",
    "pattern_fingerprint",
    "permute_symmetric",
    "transpose_csr",
    "SolveDAG",
    "dag_from_edges",
    "dag_from_lower_csr",
    "gather_ranges",
    "topological_levels",
    "erdos_renyi_lower",
    "narrow_band_lower",
    "poisson2d_matrix",
    "poisson3d_matrix",
    "random_spd_band",
    "shifted_coupling_lower",
    "ichol0",
    "read_matrix_market",
    "write_matrix_market",
]
