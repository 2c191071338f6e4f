"""A frozen copy of the port's ``narrow_band_lower`` in plain NumPy, draw
for draw (arXiv:2503.05408 §6.2.5): entry (i, j), i > j, present with
probability ``p * exp((1 + j - i) / band)``, the band cut where that has
decayed by e^-12 (``max_width_sigma * band``), a full diagonal, the
paper's value distributions."""
from __future__ import annotations

import numpy as np

from portbench.reference.matrices import Csr, csr_from_coo, paper_values

PORT = "repro_torch.sparse.generators.narrow_band_lower"
CASES = [{"n": 30, "p": 0.9, "band": 5.0},  # the cut past n - 1
         {"n": 10000, "p": 0.14, "band": 10.0},  # nb100k's small size
         {"n": 2000, "p": 0.5, "band": 2.5, "seed": 7, "max_width_sigma": 4.0}]


def generate(n: int, p: float, band: float, *, seed: int = 0,
             max_width_sigma: float = 12.0) -> Csr:
    rng = np.random.default_rng(seed)
    width = int(min(n - 1, np.ceil(band * max_width_sigma)))
    offsets = np.arange(1, width + 1)  # i - j
    probs = np.clip(p * np.exp((1 - offsets) / band), 0.0, 1.0)
    rows_list, cols_list = [], []
    for off_k, pk in zip(offsets, probs):
        if pk <= 0:
            continue
        i = np.arange(off_k, n, dtype=np.int64)
        ii = i[rng.random(len(i)) < pk]
        rows_list.append(ii)
        cols_list.append(ii - off_k)
    rows = np.concatenate(rows_list) if rows_list else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols_list) if cols_list else np.empty(0, dtype=np.int64)
    off, diag = paper_values(rng, len(rows), n)
    diag_idx = np.arange(n, dtype=np.int64)
    return csr_from_coo(n, np.concatenate([rows, diag_idx]), np.concatenate([cols, diag_idx]),
                        np.concatenate([off, diag]))
