"""Training launcher for the LM stack: the config registry, the synthetic
data pipeline, the microbatched train step, async checkpoints and resume,
as the JAX package's ``launch/train.py`` wires them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        [--steps 50] [--batch 4] [--seq 128] [--microbatches 1] [--lr 1e-3] \\
        [--reduced | --full] [--ckpt-dir DIR] [--ckpt-every 20] \\
        [--compress-grads] [--resume] [--device cpu]

It trains on the card unless ``--device cpu`` is given, and raises where
CUDA is missing rather than falling back. Parameters are float32 from the
port's ``init_params`` (seed 0); the data is ``SyntheticLMData(seed=0)``.
With ``--compress-grads`` the error-feedback buffer is carried from step to
step (the port's step is eager).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.distributed import compressed_grad_transform, init_error_buffers
from repro_torch.launch.inputs import token_split
from repro_torch.models import init_params, param_specs
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import init_train_state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} family={cfg.family} device={dev}", flush=True)

    params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    state = init_train_state(cfg, params)
    start_step = 0

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest():
        state, meta = restore_checkpoint(ckpt.latest(), template=state, device=dev)
        start_step = meta["step"]
        print(f"[train] resumed from {ckpt.latest()} at step {start_step}", flush=True)

    p_fe, _ = token_split(cfg, args.seq)
    data = SyntheticLMData(vocab=cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0,
                           frontend_positions=p_fe, d_model=cfg.d_model, device=str(dev))
    grad_transform = None
    if args.compress_grads:
        err = {"e": init_error_buffers(state.params)}
        grad_transform = compressed_grad_transform(err)

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              grad_transform=grad_transform)
    losses, grad_norms = [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, data.batch_at(step))
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} gnorm {grad_norms[-1]:.2f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, step=step + 1)
    if ckpt:
        ckpt.save(state, step=args.steps)
        ckpt.wait()
        print(f"[train] final checkpoint: {ckpt.latest()}", flush=True)
    return {"arch": cfg.name, "device": str(dev), "start_step": start_step,
            "steps": args.steps, "losses": losses, "grad_norms": grad_norms,
            "seconds": time.time() - t0, "state": state}


if __name__ == "__main__":
    main()
