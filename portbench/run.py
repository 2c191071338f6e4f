"""Run one cell of the benchmark once and print its result's line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced segment after
the window. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error repeat the checks. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits with 5; if JAX, Flax or the JAX package was loaded, with 6.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and the program's sources, in place of this folder
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def finite(obj):
    """``obj`` with every number that is not finite as None (JSON has no
    infinity)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    spec = harness.load_spec(args.workload)
    import repro_torch  # noqa: F401  the program under test: without it, no run
    import torch

    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 5
    result = harness.run(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device=torch.device("cuda", 0), t0=T0,
                         log=lambda line: print(line, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not use: {bad}", file=sys.stderr)
        return 6
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) over {c['compared']} calls",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
