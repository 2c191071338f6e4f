"""A frozen copy of the port's ``shifted_coupling_lower`` in plain NumPy,
draw for draw: a full diagonal and one entry a ``stride``-th row ``i``, at
column ``i - 1 - shift``; the paper's value distributions. It stands for a
generator that a new configuration brings as a file of its own."""
from __future__ import annotations

import numpy as np

from portbench.reference.matrices import Csr, csr_from_coo, paper_values

PORT = "repro_torch.sparse.generators.shifted_coupling_lower"
CASES = [{"n": 64, "shift": 0}, {"n": 1000, "shift": 3, "seed": 5},
         {"n": 777, "shift": 2, "stride": 4, "seed": 1}]


def generate(n: int, shift: int, *, stride: int = 8, seed: int = 0) -> Csr:
    if not 0 <= shift <= stride - 2:
        raise ValueError(f"shift must be in [0, {stride - 2}]")
    rng = np.random.default_rng(seed)
    rr = np.arange(stride, n, stride, dtype=np.int64)
    diag = np.arange(n, dtype=np.int64)
    off, dvals = paper_values(rng, len(rr), n)
    return csr_from_coo(n, np.concatenate([rr, diag]), np.concatenate([rr - 1 - shift, diag]),
                        np.concatenate([off, dvals]))
