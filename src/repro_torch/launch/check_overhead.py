"""Verifier-overhead benchmark — ``repro_torch.analysis`` vs the inspector.

The port's twin of ``benchmarks/check_overhead.py``. A verifier that
doubles inspection time never gets turned on. This script times the
static passes against ``compile_plan`` (the dominant inspector stage the
verifier re-audits) on the same two families at N in {1e4, 1e5}, host
seconds, median of a few runs:

  * **fast** — the default ``validate="fast"`` invariant set (schedule
    race detect + reorder audit + plan sanitizer + lane layout), the
    thing meant to ride along on every build;
  * **full** — adds value provenance and load accounting; bounded but
    not gated (it is the slow/CI depth);
  * **levels** — the port's own pass: ``kernels.levels.level_order`` (the
    bulk order the ``kernel`` backend's bind builds) beside the level
    check of that order at both levels (``analysis.level_check``), which
    ``plan(validate=...)`` runs after the bind.

Acceptance: fast <= 15% of ``compile_plan`` time at N=1e5 (the smoke run
checks 30% at N=1e4, where fixed per-call costs dominate). Exits
non-zero on an overrun or when the verifier flags a pristine plan.

  PYTHONPATH=src python -m repro_torch.launch.check_overhead --json chk.json
  PYTHONPATH=src python -m repro_torch.launch.check_overhead --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch.analysis import Artifacts, verify_artifacts, verify_level_order
from repro_torch.autotune import scale_corpus_entry
from repro_torch.core.plan import compile_plan
from repro_torch.core.reorder import apply_reordering
from repro_torch.kernels.levels import level_order
from repro_torch.pipeline import schedule
from repro_torch.sparse import (
    dag_from_lower_csr,
    erdos_renyi_lower,
    narrow_band_lower,
)

K = 8
ACCEPT_RATIO = 0.15  # fast verify / compile_plan, at N=1e5 (the gate)
SMOKE_RATIO = 0.30  # N=1e4 sanity bound: fixed per-call overhead
#                     dominates at small N, so the 1e5 budget is not
#                     representative there

FAMILIES = {
    "er_sparse": {
        10_000: lambda: erdos_renyi_lower(10_000, 0.002 * 800 / 10_000,
                                          seed=201),
        100_000: scale_corpus_entry("er_sparse_100k").make,
    },
    "band_narrow": {
        10_000: lambda: narrow_band_lower(10_000, 0.14, 10, seed=203),
        100_000: scale_corpus_entry("band_narrow_100k").make,
    },
}


def _median_time(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _bench_point(name: str, L0, *, reps: int) -> dict:
    dag = dag_from_lower_csr(L0)
    s0 = schedule(dag, K, strategy="growlocal")
    L, s, _, r = apply_reordering(L0, s0)
    plan = compile_plan(L, s)
    art = Artifacts(L=L, sched=s, plan=plan, perm=r.perm, sched_pre=s0)
    order = level_order(plan)

    rep = verify_artifacts(
        dataclasses.replace(art, levels=order), level="full"
    )  # warm + correctness gate
    if not rep.ok:
        raise SystemExit(
            f"check_overhead FAILED: verifier flagged a pristine plan "
            f"({name}): {rep.codes()}"
        )

    t_compile = _median_time(lambda: compile_plan(L, s), reps)
    t_fast = _median_time(
        lambda: verify_artifacts(art, level="fast"), reps
    )
    t_full = _median_time(
        lambda: verify_artifacts(art, level="full"), max(reps - 1, 1)
    )
    t_order = _median_time(lambda: level_order(plan), max(reps - 2, 1))
    t_lfast = _median_time(
        lambda: verify_level_order(plan, order, level="fast", slack=1), reps
    )
    t_lfull = _median_time(
        lambda: verify_level_order(plan, order, level="full", slack=1), reps
    )
    return {
        "name": name,
        "n": L.n_rows,
        "nnz": L.nnz,
        "T": plan.n_steps,
        "levels": order.n_levels,
        "compile_seconds": t_compile,
        "verify_fast_seconds": t_fast,
        "verify_full_seconds": t_full,
        "level_order_seconds": t_order,
        "level_check_fast_seconds": t_lfast,
        "level_check_full_seconds": t_lfull,
        "fast_ratio": t_fast / t_compile,
        "full_ratio": t_full / t_compile,
    }


def run(*, smoke: bool = False) -> dict:
    sizes = (10_000,) if smoke else (10_000, 100_000)
    print(
        f"# check_overhead — static verifier vs compile_plan, k={K}, "
        f"growlocal ({'smoke: N=1e4 only' if smoke else 'full'})"
    )
    print(
        f"{'matrix':16s} {'nnz':>9s} {'compile ms':>11s} {'fast ms':>9s} "
        f"{'full ms':>9s} {'fast/comp':>10s} {'full/comp':>10s} "
        f"{'order ms':>9s} {'lvl fast':>9s} {'lvl full':>9s}"
    )
    rows = []
    gate_ratios = []
    for fam, points in FAMILIES.items():
        for n in sizes:
            L = points[n]()
            tag = f"{fam}.{n // 1000}k"
            r = _bench_point(tag, L, reps=5)
            rows.append(r)
            if n == max(sizes):
                gate_ratios.append(r["fast_ratio"])
            print(
                f"{tag:16s} {r['nnz']:9d} "
                f"{r['compile_seconds']*1e3:11.1f} "
                f"{r['verify_fast_seconds']*1e3:9.1f} "
                f"{r['verify_full_seconds']*1e3:9.1f} "
                f"{r['fast_ratio']:9.1%} {r['full_ratio']:9.1%} "
                f"{r['level_order_seconds']*1e3:9.1f} "
                f"{r['level_check_fast_seconds']*1e3:9.1f} "
                f"{r['level_check_full_seconds']*1e3:9.1f}"
            )
    worst = max(gate_ratios)
    budget = SMOKE_RATIO if smoke else ACCEPT_RATIO
    ok = worst <= budget
    size_tag = f"{max(sizes) // 1000}k"
    print(
        f"acceptance at N={size_tag} (fast <= {budget:.0%} of "
        f"compile_plan): {'PASS' if ok else 'MISS'} (worst {worst:.1%})"
    )
    return {
        "rows": rows,
        "gate_size": max(sizes),
        "budget": budget,
        "worst_fast_ratio": worst,
        "accept_fast_ratio": bool(ok),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", metavar="PATH", default=None)
    ap.add_argument(
        "--smoke", action="store_true",
        help="short run: N=1e4 rows only; still gates on the fast "
        "ratio (exits non-zero on overrun)",
    )
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(out, fh, indent=2)
        print(f"wrote {args.json}")
    if not out["accept_fast_ratio"]:
        print(
            f"check_overhead FAILED: fast verify is "
            f"{out['worst_fast_ratio']:.1%} of compile_plan at "
            f"N={out['gate_size']} (budget {out['budget']:.0%})",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
