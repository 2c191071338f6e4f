"""The readings that a cell's limit is set from, on the chip:

    python3 portbench/control.py --workload <cell> --control-seeds 1,2,3 \\
        [--control-calls K] [--program-seeds 4,5,...] [--seconds S]

For each control seed, the plain reference is put in the program's place
one precision below the configuration's (the ``control`` of the cell's
first check that has one) on the first K right-hand sides the run would
draw, and its answers are compared as a run compares the program's, by
every check that judges answers; a control has to come out as not
correct. For each program seed, one run of the cell (a
window of ``--seconds``, untraced) in this process gives the program's
reading. One JSON line a seed; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_reading(spec, seed: int, calls: int, device) -> dict:
    """The control's numbers on ``seed``, by check: one a compared call."""
    import types

    import torch

    from portbench import harness, inputs

    checks = {name: harness.load_module("checks", name) for name in spec.cell["checks"]}
    ctl = next(c.control for c in checks.values() if hasattr(c, "control"))
    driver = harness.load_module("traffic", spec.traffic["driver"])
    matrix = inputs.make_matrix(spec.config, seed)
    pool = driver.make_pool(spec.traffic, matrix.n, seed, device)
    rhs = [driver.rhs(pool, i) for i in range(calls)]
    t = time.perf_counter()
    outs = ctl(matrix, rhs, spec.config, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run = types.SimpleNamespace(matrix=matrix, config=spec.config, device=device, counters={},
                                kept=list(zip(range(calls), rhs, outs)))
    values = {}
    for name, check in checks.items():
        vs = list(check.compare(run).values())
        if vs:  # a check of the program's own reports has nothing to judge here
            values[name] = {"values": vs, "min": min(vs), "max": max(vs),
                            "limit": spec.cell["checks"][name]}
    return {"kind": "control", "seed": seed, "checks": values,
            "seconds": time.perf_counter() - t}


def program_reading(spec, seed: int, seconds: float, device) -> dict:
    from portbench import harness

    res = harness.run(spec, seed=seed, seconds=seconds, trace=False, device=device,
                      t0=time.perf_counter(), log=lambda line: None)
    return {"kind": "program", "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "checks": res["checks"], "metrics": res["metrics"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-calls", type=int, default=None)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 5
    device = torch.device("cuda", 0)
    spec = harness.load_spec(args.workload)
    calls = args.control_calls or spec.cell["sample"]
    for s in filter(None, args.control_seeds.split(",")):
        print(json.dumps(control_reading(spec, int(s), calls, device)), flush=True)
    for s in filter(None, args.program_seeds.split(",")):
        print(json.dumps(program_reading(spec, int(s), args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]  # in place of this folder
    sys.exit(main())
