"""Train a small LM end to end on the PyTorch port: config -> parameters ->
data pipeline -> train loop -> checkpoint -> resume, as the JAX example
(``examples/train_lm.py``) does.

By default it trains a ~12M-parameter granite-family model for 60 steps
and checks that the loss falls, then saves a checkpoint, restores it and
takes one more step.

    PYTHONPATH=src python examples/torch_train_lm.py              # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu [--steps 60]

It runs on the card unless ``--device cpu`` is given, and raises where CUDA
is missing. The checkpoint goes to ``--ckpt``, or to a temporary directory.
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import init_params, param_specs
from repro_torch.models.common import tree_leaves
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import init_train_state

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--steps", type=int, default=60)
p.add_argument("--d-model", type=int, default=256)
p.add_argument("--layers", type=int, default=4)
p.add_argument("--batch", type=int, default=8)
p.add_argument("--seq", type=int, default=128)
p.add_argument("--ckpt", default=None, help="checkpoint directory (default: a temporary one)")
p.add_argument("--device", default=None, help="torch device (default: the card)")
args = p.parse_args()
dev = resolve_device(args.device)

cfg = dataclasses.replace(
    get_reduced("granite_3_2b"),
    d_model=args.d_model,
    n_layers=args.layers,
    n_heads=max(4, args.d_model // 64),
    n_kv_heads=max(2, args.d_model // 128),
    d_ff=args.d_model * 4,
    vocab_size=2048,
    vocab_pad_to=256,
)
params = init_params(param_specs(cfg), torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.float32, device=dev)
n_params = sum(t.numel() for t in tree_leaves(params))
print(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
      f"params={n_params / 1e6:.1f}M device={dev}")

data = SyntheticLMData(vocab=cfg.vocab_size, batch=args.batch, seq=args.seq, seed=1,
                       device=str(dev))
state = init_train_state(cfg, params)
opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
step_fn = make_train_step(cfg, opt, microbatches=2)

losses = []
t0 = time.time()
for step in range(args.steps):
    state, metrics = step_fn(state, data.next_batch(step))
    losses.append(float(metrics["loss"]))
    if step % 10 == 0 or step == args.steps - 1:
        print(f"step {step:4d} loss {losses[-1]:.4f} "
              f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}")
print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")
first, last = np.mean(losses[:5]), np.mean(losses[-5:])
assert last < first, f"loss did not decrease: {first:.3f} -> {last:.3f}"
print(f"loss {first:.3f} -> {last:.3f}  (decreasing)")

# checkpoint / kill / resume
with tempfile.TemporaryDirectory() as tmp:
    path = args.ckpt or f"{tmp}/ckpt"
    save_checkpoint(path, state, step=args.steps)
    restored, meta = restore_checkpoint(path, template=state, device=dev)
state2, metrics2 = step_fn(restored, data.next_batch(meta["step"]))
assert np.isfinite(float(metrics2["loss"]))
print(f"resumed at step {meta['step']}: loss {float(metrics2['loss']):.4f}")
print("OK")
