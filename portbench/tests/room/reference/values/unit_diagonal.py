"""Off-diagonal values U[-1, 1] and a diagonal of ones, drawn from the
run's seed: a value rule that a new configuration brings as a file of its
own."""
import numpy as np

from portbench.reference.matrices import Csr


def draw(rng: np.random.Generator, m: Csr) -> np.ndarray:
    data = rng.uniform(-1.0, 1.0, size=m.nnz)
    data[m.indices == m.row_of_entry()] = 1.0
    return data
