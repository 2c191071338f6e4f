"""The matrix of a run, made from ``--seed`` as its configuration says (the
right-hand sides are the traffic driver's: ``traffic/<driver>.py``).

A configuration names the frozen generator that makes the pattern (one of
``reference/matrices.py``'s ``GENERATORS``, or ``reference/generators/
<name>.py``) and the rule for its values: ``fixed`` (the generator's own),
``seed`` (the paper's distributions drawn from the run's seed), or
``reference/values/<rule>.py``. The pattern, and with it the plan and the
work of a solve, is the same on every seed; the numbers differ.
"""
from __future__ import annotations

import numpy as np

from portbench import HERE, load_module
from portbench.reference import matrices
from portbench.reference.matrices import Csr

SEED_MOD = 2**63  # --seed may exceed 32 bits; torch and numpy take 63


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator of its own for each use of one seed."""
    return np.random.default_rng([seed % SEED_MOD, stream])


def generator(name: str):
    """The generator a configuration names: ``matrices.<name>`` for one of
    ``matrices.GENERATORS``, else ``reference/generators/<name>.py``'s
    ``generate``. A name found in both places, or in neither, is an
    error."""
    in_matrices = name in matrices.GENERATORS
    if in_matrices == (HERE / "reference" / "generators" / f"{name}.py").is_file():
        raise ValueError(f"generator {name!r} must be found once: in reference/matrices.py's "
                         "GENERATORS or as reference/generators/<name>.py")
    if in_matrices:
        return getattr(matrices, name)
    return load_module("reference/generators", name).generate


def value_rule(name: str):
    """``reference/values/<name>.py``: ``draw(rng, m)`` gives m's data in its
    entry order. ``seed`` and ``fixed`` are built in and take no file."""
    if not (HERE / "reference" / "values" / f"{name}.py").is_file():
        raise ValueError(f"values rule {name!r}: neither seed, fixed nor "
                         "reference/values/<rule>.py")
    return load_module("reference/values", name)


def make_matrix(spec: dict, seed: int) -> Csr:
    """The configuration's matrix: ``generator(spec["generator"])`` called
    with the keys ``spec["generator_args"]`` maps its parameters to, and its
    values as ``spec["values"]`` says: the generator's own (``fixed``, the
    default), the paper's distributions drawn anew from ``seed`` on that
    pattern (``seed``), or the named rule's ``draw`` from the same stream."""
    m = generator(spec["generator"])(
        **{param: spec[key] for param, key in spec["generator_args"].items()})
    rule = spec.get("values", "fixed")
    if rule == "seed":
        is_diag = m.indices == m.row_of_entry()
        off, diag = matrices.paper_values(rng(seed, 1), int((~is_diag).sum()), m.n)
        data = np.empty(m.nnz)
        data[~is_diag] = off
        data[is_diag] = diag
        m = Csr(m.n, m.indptr, m.indices, data)
    elif rule != "fixed":
        data = np.asarray(value_rule(rule).draw(rng(seed, 1), m), dtype=np.float64)
        if data.shape != (m.nnz,):
            raise ValueError(f"values rule {rule!r} gave {data.shape}, not ({m.nnz},)")
        m = Csr(m.n, m.indptr, m.indices, data)
    return m
