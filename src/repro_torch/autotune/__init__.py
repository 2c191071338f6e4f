"""Autotuner: let the pipeline pick the scheduling strategy.

The paper's experiments show no single schedule dominates — the best
strategy (and its knobs) depends on the matrix's DAG shape. This package
makes ``TriangularSolver.plan(L, strategy="auto")`` choose it:

  * ``features``  — cheap DAG/matrix feature extraction, memoized per
                    sparsity fingerprint (depth, wavefront widths, skew,
                    bandwidth, ...)
  * ``selector``  — transparent rule table features -> candidate configs,
                    scored with the §2.2 BSP cost model; optional
                    ``tune=True`` measured trials on the real backend
  * ``corpus``    — the named scenario corpus (ER, narrow-band, Poisson
                    IC(0), chain/star/independent) with expected-regime
                    metadata, shared by calibration, conformance tests and
                    ``benchmarks/table7x_auto.py``

A copy of the JAX package's ``repro.autotune``; measured trials
(``tune=True``) time the port's own backends, on the card by default.
"""
from repro_torch.autotune.corpus import (
    CorpusEntry,
    chain_lower,
    corpus_entries,
    corpus_entry,
    corpus_names,
    independent_lower,
    scale_corpus_entries,
    scale_corpus_entry,
    scale_corpus_names,
    star_lower,
)
from repro_torch.autotune.features import (
    MatrixFeatures,
    clear_feature_cache,
    dag_features,
    matrix_features,
)
from repro_torch.autotune.selector import (
    REGIMES,
    Candidate,
    Selection,
    classify,
    clear_selection_memo,
    resolve_auto,
    resolve_auto_full,
    select_schedule,
    selection_key,
    shortlist,
)

__all__ = [
    "CorpusEntry",
    "chain_lower",
    "corpus_entries",
    "corpus_entry",
    "corpus_names",
    "independent_lower",
    "scale_corpus_entries",
    "scale_corpus_entry",
    "scale_corpus_names",
    "star_lower",
    "MatrixFeatures",
    "clear_feature_cache",
    "dag_features",
    "matrix_features",
    "REGIMES",
    "Candidate",
    "Selection",
    "classify",
    "clear_selection_memo",
    "resolve_auto",
    "resolve_auto_full",
    "select_schedule",
    "selection_key",
    "shortlist",
]
