"""Serving launcher for the LM stack: prefill a batch of prompts, then
decode N tokens greedily through the stacked decode cache (KV for
attention, the recurrent state for RWKV-6 and the RG-LRU hybrid, and the
encoder-decoder family's cross-attention k / v of the encoded frames).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
        [--reduced | --full] [--batch 4] [--prompt-len 64] [--new-tokens 32] \\
        [--device cpu] [--seed 0]

It serves on the card unless ``--device cpu`` is given, and raises where
CUDA is missing rather than falling back. ``--reduced`` (the default) is
the config's small twin; ``--full`` the published widths and depth.
Parameters are float32, drawn from ``--seed``; the prompts are the seed's
``make_train_batch`` tokens (with its frame or patch embeddings where the
config has a frontend), as in the JAX launcher.
"""
from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.device import resolve_device, timed_us
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import decode_step, init_params, param_specs, prefill
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import ModelConfig


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, new_tokens: int,
          device=None, seed: int = 0) -> dict:
    """One prefill over ``batch`` prompts of ``prompt_len`` tokens, then
    ``new_tokens - 1`` greedy decode steps (argmax over the real vocabulary,
    not the padding). Returns ``tokens`` int64 [batch, new_tokens] on the
    host, ``prefill_ms``, ``decode_ms`` (one a step) and their median
    ``decode_ms_per_token`` (CUDA events on the card, the host clock on
    the CPU), ``logits_finite`` (every logit of every step), and the
    parameter and cache bytes."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(param_specs(cfg), gen, dtype=torch.float32, device=dev)
    inputs = make_train_batch(cfg, batch=batch, seq_len=prompt_len, seed=seed, device=dev)
    max_len = prompt_len + new_tokens
    V = cfg.vocab_size

    (logits, cache, pos), prefill_us = timed_us(
        lambda: prefill(cfg, params, inputs, max_len=max_len), dev)
    finite = torch.isfinite(logits).all()
    token = torch.argmax(logits[:, :V], dim=-1)
    out = [token]
    step_us = []
    for i in range(new_tokens - 1):
        (logits, cache), us = timed_us(
            lambda: decode_step(cfg, params, cache, pos + i, token), dev)
        step_us.append(us)
        finite &= torch.isfinite(logits).all()
        token = torch.argmax(logits[:, :V], dim=-1)
        out.append(token)
    decode_ms = [us / 1e3 for us in step_us]
    return {
        "arch": cfg.name, "family": cfg.family, "device": str(dev),
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
        "tokens": torch.stack(out, dim=1).cpu(),
        "prefill_ms": prefill_us / 1e3,
        "decode_ms": decode_ms,
        "decode_ms_per_token": statistics.median(decode_ms) if decode_ms else None,
        "logits_finite": bool(finite),
        "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
        "cache_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(cache)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--greedy", action="store_true", default=True,
                    help="greedy argmax decoding (the only mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and prompts")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"[serve] arch={cfg.name} family={cfg.family} "
          f"batch={args.batch} prompt={args.prompt_len} device={dev}", flush=True)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, device=dev, seed=args.seed)
    print(f"[serve] prefill {res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms_per_token'] or 0.0:.1f} ms/token", flush=True)
    for b in range(min(args.batch, 2)):
        print(f"  request {b}: {res['tokens'][b][:12].tolist()}")
    return res


if __name__ == "__main__":
    main()
