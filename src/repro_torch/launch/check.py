"""Static-verification sweep: run ``repro_torch.analysis`` over the whole
scenario corpus and print a findings table.

The port's twin of ``python -m repro.launch.check``: the same grid, flags
and exit rule. One row per (matrix, strategy, orientation, mode, shards)
cell, verified host-side only (``partition_plan`` is pure NumPy, so the
4-shard cells need no devices). Each cell also checks the level orders
the ``kernel`` backend's bind would build — the bulk one, and in the
elastic cells the one over runs of the certificate's slack — which the
CUDA kernels walk. Exit is nonzero iff any cell yields an error finding,
which makes this the CI gate for the port's inspector pipeline.

``--mutate`` additionally runs the mutation harness
(``repro_torch.analysis.mutate``, the JAX package's four families plus
``levels``): every seeded corruption must be caught, every pristine
artifact set must stay clean — the verifier's false-negative test, in
the same sweep binary.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.check            # full sweep
  PYTHONPATH=src python -m repro_torch.launch.check --smoke    # CI-sized
  PYTHONPATH=src python -m repro_torch.launch.check --mutate
  PYTHONPATH=src python -m repro_torch.launch.check --json out.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from repro_torch import obs
from repro_torch.analysis import verify_artifacts
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.mutate import build_artifacts, run_harness
from repro_torch.autotune.corpus import corpus_entry, corpus_names
from repro_torch.pipeline.registry import available_strategies
from repro_torch.sparse.csr import transpose_csr

SMOKE_MATRICES = ("er_dense", "band_narrow", "chain")
SMOKE_STRATEGIES = ("growlocal", "wavefront")


def _upper_of(a):
    """The upper-triangular transpose — what ``plan(lower=False)`` sees
    before mirroring back to lower form."""
    return transpose_csr(a)


def sweep_cells(
    *,
    matrices,
    strategies,
    orientations=("lower", "upper"),
    modes=("bsp", "elastic"),
    shard_counts=(1, 4),
    slack: int = 4,
    level: str = "full",
) -> List[dict]:
    """Verify every grid cell; one record per cell with codes/timing."""
    rows: List[dict] = []
    for name in matrices:
        a = corpus_entry(name).matrix()
        for strategy in strategies:
            for orient in orientations:
                lower = orient == "lower"
                mat = a if lower else _upper_of(a)
                for mode in modes:
                    for ns in shard_counts:
                        t0 = time.perf_counter()
                        try:
                            art = build_artifacts(
                                mat, strategy=strategy, k=8, lower=lower,
                                slack=slack if mode == "elastic" else 0,
                                n_shards=ns,
                            )
                            rep = verify_artifacts(art, level=level)
                            ok, codes = rep.ok, list(rep.codes())
                            err = None
                        except Exception as e:  # a crash is a failure too
                            ok, codes, err = False, [], repr(e)
                        rows.append({
                            "matrix": name,
                            "strategy": strategy,
                            "orientation": orient,
                            "mode": mode,
                            "n_shards": ns,
                            "ok": ok,
                            "codes": codes,
                            "error": err,
                            "seconds": round(time.perf_counter() - t0, 4),
                        })
    return rows


def mutation_cells(*, smoke: bool = False) -> List[dict]:
    """The harness's artifact grid: families spread so every operator
    has at least one applicable site (wavefront/bsp for multi-round
    exchanges, narrow width for accum chains)."""
    grid = [
        ("er_dense/growlocal/el4", "er_dense", "growlocal",
         dict(slack=4, n_shards=4)),
        ("band_narrow/growlocal/el4w2", "band_narrow", "growlocal",
         dict(slack=4, n_shards=4, width=2)),
        ("er_dense/wavefront/bsp4", "er_dense", "wavefront",
         dict(slack=0, n_shards=4)),
        ("chain/growlocal/el2", "chain", "growlocal",
         dict(slack=2, n_shards=2)),
    ]
    if smoke:
        grid = grid[:2] + grid[2:3]
    sets = []
    for label, name, strategy, kw in grid:
        a = corpus_entry(name).matrix()
        sets.append((
            label, build_artifacts(a, strategy=strategy, k=8, **kw)
        ))
    return run_harness(sets)


def summarize_mutations(rows: List[dict]) -> dict:
    """Per-operator verdicts: every operator must be applicable
    somewhere and caught everywhere it applies."""
    ops = {}
    for r in rows:
        d = ops.setdefault(r["mutation"], {
            "family": r["family"], "applicable": 0, "caught": 0,
        })
        if r["caught"] is not None:
            d["applicable"] += 1
            d["caught"] += int(r["caught"])
    missed = sorted(
        m for m, d in ops.items()
        if d["applicable"] == 0 or d["caught"] != d["applicable"]
    )
    return {
        "operators": len(ops),
        "families": len({d["family"] for d in ops.values()}),
        "missed": missed,
        "per_operator": ops,
    }


def _print_table(rows: List[dict]) -> None:
    hdr = f"{'matrix':<18}{'strategy':<12}{'orient':<7}{'mode':<9}" \
          f"{'shards':>6}  {'verdict':<8}{'findings'}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        what = ", ".join(r["codes"]) if r["codes"] else (
            r["error"] or "-"
        )
        print(
            f"{r['matrix']:<18}{r['strategy']:<12}{r['orientation']:<7}"
            f"{r['mode']:<9}{r['n_shards']:>6}  "
            f"{'ok' if r['ok'] else 'FAIL':<8}{what}"
        )


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.check",
        description="static verification sweep over the scenario corpus",
    )
    p.add_argument(
        "--smoke", action="store_true",
        help="CI-sized subset (3 matrices x 2 strategies, fast level)",
    )
    p.add_argument(
        "--mutate", action="store_true",
        help="also run the mutation harness (verifier false-negative test)",
    )
    p.add_argument(
        "--no-lint", action="store_true",
        help="skip the determinism lint pass",
    )
    p.add_argument("--level", choices=("fast", "full"), default=None)
    p.add_argument("--json", metavar="PATH", default=None)
    args = p.parse_args(argv)

    matrices = SMOKE_MATRICES if args.smoke else corpus_names()
    strategies = (
        SMOKE_STRATEGIES if args.smoke
        else tuple(s for s in available_strategies() if s != "auto")
    )
    level = args.level or ("fast" if args.smoke else "full")

    t0 = time.perf_counter()
    rows = sweep_cells(
        matrices=matrices, strategies=strategies, level=level,
    )
    _print_table(rows)
    n_fail = sum(not r["ok"] for r in rows)
    print(
        f"\nsweep: {len(rows)} cells, {n_fail} failing, level={level}, "
        f"{time.perf_counter() - t0:.1f}s"
    )
    failed = n_fail > 0

    lint_found = []
    if not args.no_lint:
        lint_found = lint_paths()
        print(f"determinism lint: {len(lint_found)} finding(s)")
        for f in lint_found:
            print(f"  {f.code}  {f.message}")
        failed = failed or bool(lint_found)

    mut_summary = None
    if args.mutate:
        t1 = time.perf_counter()
        mrows = mutation_cells(smoke=args.smoke)
        mut_summary = summarize_mutations(mrows)
        print(
            f"mutation harness: {mut_summary['operators']} operators / "
            f"{mut_summary['families']} families, "
            f"missed={mut_summary['missed'] or 'none'}, "
            f"{time.perf_counter() - t1:.1f}s"
        )
        failed = failed or bool(mut_summary["missed"])

    if args.json:
        buf = obs.active_buffer()
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump({
                "cells": rows,
                "lint": [f.message for f in lint_found],
                "mutation": mut_summary,
                "counters": buf.counters() if buf is not None else {},
            }, fh, indent=2)
        print(f"wrote {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
