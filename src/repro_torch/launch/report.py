"""Aggregate experiments/dryrun_torch/*.json (the port's dry run,
``launch/dryrun.py``) into the JAX package's report table, with "-" where
a term is ``None``.

    PYTHONPATH=src python -m repro_torch.launch.report [--mp]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def fmt_s(x):
    return f"{x:.3e}" if x is not None else "-"


def load(mp: bool, out_dir: Path = OUT_DIR):
    rows = []
    for f in sorted(out_dir.glob("*.json")):
        is_mp = f.stem.endswith(".mp")
        if is_mp != mp:
            continue
        rows.append(json.loads(f.read_text()))
    return rows


def table(rows) -> list:
    """The table's lines for the records ``rows``."""
    hdr = (
        "| cell | status | t_comp (s) | t_mem (s) | t_mem_lb (s) | "
        "t_coll (s) | dominant | useful-FLOP ratio | bytes/chip (temp) | "
        "roofline frac |"
    )
    out = [hdr, "|" + "---|" * 10]
    for r in rows:
        if r["status"] == "SKIP":
            out.append(f"| {r['cell']} | SKIP ({r['reason'][:40]}…) |" + " - |" * 8)
            continue
        if r["status"] != "OK":
            out.append(f"| {r['cell']} | ERROR ({r.get('where', '')}) |" + " - |" * 8)
            continue
        t = r["roofline"]
        dom = t["dominant"]
        dom_t = t[f"t_{dom}_s"]
        # roofline fraction: compute term / dominant term — how close the
        # cell is to being compute-bound at peak
        frac = t["t_compute_s"] / max(dom_t, 1e-30)
        temp = r.get("memory_analysis", {}).get("temp_size_in_bytes")
        ratio = r.get("useful_flops_ratio")
        out.append(
            f"| {r['cell']} | OK | {fmt_s(t['t_compute_s'])} | "
            f"{fmt_s(t['t_memory_s'])} | {fmt_s(t.get('t_memory_lb_s'))} | "
            f"{fmt_s(t['t_collective_s'])} | {dom} | "
            f"{'-' if ratio is None else f'{ratio:.2f}'} | "
            f"{'-' if temp is None else f'{temp / 1e9:.1f} GB'} | {frac:.3f} |"
        )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="The port's dry-run table.")
    ap.add_argument("--mp", action="store_true")
    args = ap.parse_args(argv)
    for line in table(load(args.mp)):
        print(line)


if __name__ == "__main__":
    main()
