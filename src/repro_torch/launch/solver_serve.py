"""CLI for the batching solve service — drive a load mix, print metrics.

Replays a request mix over the autotune scenario corpus (or a set of
adversarial all-distinct patterns, or one width-class family) through
``repro_torch.serve.SolveService`` and prints the telemetry snapshot;
optionally dumps the full report as JSON (same shape as
``repro_torch.serve.loadgen`` reports). It serves on the card unless
``--device cpu`` is given (then the kernels' plain versions run).

  PYTHONPATH=src python -m repro_torch.launch.solver_serve --mix hot
  PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
      --mix uniform --clients 16 --requests 50 --max-batch 32 --workers 2
  PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
      --mix width --width-class --strategy wavefront
  PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
      --mix hot --open-loop 400 --n-requests 800 --json report.json
  PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
      --mix width --strategy wavefront --mode continuous --slots 32
  PYTHONPATH=src python -m repro_torch.launch.solver_serve \\
      --backend distributed --mesh 2x4 --device cuda:0

``--backend distributed`` serves across a mesh of ``--mesh DATAxMODEL``
positions (``repro_torch.mesh``), with one schedule core per model
position. With ``--device`` every position sits on that device (one card,
or the CPU); without it, one position per visible card, and a mesh larger
than the visible cards is refused.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.mesh import make_mesh
from repro_torch.serve import (
    MIXES,
    SolveService,
    patterns_for_mix,
    pretty,
    run_closed_loop,
    run_open_loop,
)


def _make_mesh(spec: str, device):
    """``"DATAxMODEL"`` -> a mesh over ("data", "model"): every position on
    ``device`` where one is named, else one per visible CUDA device."""
    try:
        data_ax, model_ax = (int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects DATAxMODEL (e.g. 2x4); got {spec!r}")
    try:
        return make_mesh((data_ax, model_ax), devices=device)
    except RuntimeError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mix", choices=MIXES, default="hot")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument(
        "--requests", type=int, default=25, help="requests per client"
    )
    ap.add_argument(
        "--open-loop", type=float, metavar="RATE_HZ", default=None,
        help="open-loop mode at RATE_HZ (default: closed loop)",
    )
    ap.add_argument(
        "--n-requests", type=int, default=200,
        help="total requests in open-loop mode",
    )
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-us", type=int, default=2000)
    ap.add_argument(
        "--workers", type=int, default=1,
        help="worker threads executing microbatches concurrently",
    )
    ap.add_argument(
        "--width-class", action="store_true",
        help="coalesce structurally-identical patterns into grouped "
        "multi-RHS solves (cross-pattern batching)",
    )
    ap.add_argument(
        "--mode", choices=("microbatch", "continuous"),
        default="microbatch",
        help="continuous: persistent resident-slot serving, no batch "
        "formation deadline and no drain barrier (repro_torch.serve.slots)",
    )
    ap.add_argument(
        "--slots", type=int, default=None,
        help="resident device lanes per width class in continuous mode "
        "(default: max_batch, rounded up to a power of two)",
    )
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--backend", choices=("kernel", "scan", "distributed"), default="kernel")
    ap.add_argument(
        "--mesh", metavar="DATAxMODEL", default="2x4",
        help="mesh shape for --backend distributed (default 2x4)",
    )
    ap.add_argument(
        "--device", default=None,
        help="where to serve (default: the CUDA device; 'cpu' runs the "
        "kernels' plain versions)",
    )
    ap.add_argument(
        "--adversarial-patterns", type=int, default=16,
        help="distinct patterns for --mix adversarial",
    )
    ap.add_argument(
        "--prewarm", action="store_true",
        help="run every dispatch once before offering load (the first "
        "launch builds the kernels; banks are stacked)",
    )
    ap.add_argument(
        "--validate", action="store_true",
        help="bitwise-check every served result against the direct solver",
    )
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args(argv)

    plan_kw = {}
    if args.backend == "distributed":
        mesh = _make_mesh(args.mesh, args.device)
        plan_kw["mesh"] = mesh
        # one schedule core per model position: model mode refuses plans
        # with more cores, and the auto selector respects a fixed k
        plan_kw["k"] = int(mesh.shape["model"])
    svc = SolveService(
        max_batch=args.max_batch,
        max_wait_us=args.max_wait_us,
        n_workers=args.workers,
        width_class_batching=args.width_class,
        mode=args.mode,
        n_slots=args.slots,
        strategy=args.strategy,
        backend=args.backend,
        device=args.device,
        **plan_kw,
    )
    try:
        patterns, sampler = patterns_for_mix(
            svc, args.mix, n_adversarial=args.adversarial_patterns
        )
        print(
            f"registered {len(patterns)} patterns "
            f"(mix={args.mix}, backend={args.backend}, "
            f"device={args.device or 'cuda'}, "
            f"strategy={args.strategy}, mode={svc.mode}, "
            f"workers={svc.n_workers}, "
            f"width_class_batching={svc.width_class_batching})",
            flush=True,
        )
        if args.prewarm:
            svc.prewarm()
            svc.metrics.reset()  # steady-state telemetry only
        if args.open_loop is not None:
            report = run_open_loop(
                svc,
                sampler,
                rate_hz=args.open_loop,
                n_requests=args.n_requests,
                validate=args.validate,
            )
        else:
            report = run_closed_loop(
                svc,
                sampler,
                n_clients=args.clients,
                requests_per_client=args.requests,
                validate=args.validate,
            )
        print(
            f"\n{report['mode']} loop: {report['requests']} requests in "
            f"{report['elapsed_seconds']}s -> "
            f"{report['solves_per_sec']} solves/s, "
            f"errors={report['errors']}, "
            f"bitwise_mismatches={report['bitwise_mismatches']}"
        )
        print(pretty(report["metrics"]))
    finally:
        close_report = svc.close(timeout=60.0)
        if close_report["pins_retained"]:
            print(
                f"[close: {len(close_report['workers_alive'])} worker(s) "
                f"still alive after timeout, "
                f"{close_report['pins_retained']} plan pins retained]"
            )
    if args.validate and (report["bitwise_mismatches"] or report["errors"]):
        raise SystemExit("validation failed")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
        print(f"[json written to {args.json}]")


if __name__ == "__main__":
    main()
