"""Peak device memory and step time of a granite-3-2b train step whose
sequence spans several KV chunks of the chunked attention.

The port's ``models/attention.py`` runs each KV chunk of the online
softmax as one ``_ChunkStep``, whose backward recomputes the chunk's
probabilities instead of keeping them (the JAX package's remat of the
chunk step). With per-layer recompute, the backward of one layer then
holds no [B, H, S, kv_chunk] probabilities per chunk. This script shows
what that does where it can show: at S = 4096 (4 chunks of 1024) the
layer's backward holds 4 chunks' probabilities without it.

It takes whichever ``repro_torch`` is first on the path, so the same
script measures two trees of the package in one call on one card:

  PYTHONPATH=src python benchmarks/torch_chunk_attention_memory.py --label change
  PYTHONPATH=/path/to/other/src python benchmarks/torch_chunk_attention_memory.py --label parent

It prints one JSON line: the card's nvidia-smi name and power limit,
``max_memory_allocated`` over the steps, the bytes held before the first
step (parameters, moments, batch), and each step's time (CUDA events).
float32 parameters, no TF32, as ``chip_smoke.py``'s lm_train phase.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="a name for the tree measured")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the config's)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_chunk_attention_memory: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params, param_specs
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_loop import init_train_state

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite_3_2b")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    state = init_train_state(cfg, params)
    del params
    data = SyntheticLMData(vocab=cfg.vocab_size, batch=args.batch, seq=args.seq,
                           seed=args.seed, device=str(dev))
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=args.steps))
    batches = [data.batch_at(s) for s in range(args.steps)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({
        "label": args.label, "package": repro_torch.__file__, "arch": cfg.name,
        "n_layers": cfg.n_layers, "batch": args.batch, "seq": args.seq,
        "attn_kv_chunk": cfg.attn_kv_chunk, "chunks": -(-args.seq // cfg.attn_kv_chunk),
        "remat": cfg.remat, "dtype": "float32", "held_before_bytes": held,
        "max_memory_allocated": peak, "peak_over_held_bytes": peak - held,
        "step_ms": step_ms, "step_ms_median_2_on": statistics.median(step_ms[1:] or step_ms),
        "losses": losses, "nvidia_smi": smi[0].strip() if smi else None,
        "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
