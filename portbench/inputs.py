"""The matrix of a run, made from ``--seed`` as its configuration says (the
right-hand sides are the traffic driver's: ``traffic/<driver>.py``).

A configuration says which frozen generator makes the pattern
(``reference/matrices.py``) and whether the values are drawn from the run's
seed. The pattern, and with it the plan and the work of a solve, is the
same on every seed; the numbers differ.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import matrices
from portbench.reference.matrices import Csr

SEED_MOD = 2**63  # --seed may exceed 32 bits; torch and numpy take 63


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator of its own for each use of one seed."""
    return np.random.default_rng([seed % SEED_MOD, stream])


def make_matrix(spec: dict, seed: int) -> Csr:
    """The configuration's matrix: ``spec["generator"]`` called with the
    keys ``spec["generator_args"]`` maps its parameters to, and, where
    ``spec["values"] == "seed"``, the paper's value distributions drawn
    anew from ``seed`` on that pattern."""
    m = getattr(matrices, spec["generator"])(
        **{param: spec[key] for param, key in spec["generator_args"].items()})
    if spec.get("values") == "seed":
        is_diag = m.indices == m.row_of_entry()
        off, diag = matrices.paper_values(rng(seed, 1), int((~is_diag).sum()), m.n)
        data = np.empty(m.nnz)
        data[~is_diag] = off
        data[is_diag] = diag
        m = Csr(m.n, m.indptr, m.indices, data)
    elif spec.get("values", "fixed") != "fixed":
        raise ValueError(f"unknown values rule {spec['values']!r}")
    return m

