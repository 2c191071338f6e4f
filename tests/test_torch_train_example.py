"""The training example (``examples/torch_train_lm.py``) on the CPU at a
small size (the loss falls over 30 steps, a checkpoint is saved, restored
and stepped), and training that lowers the loss through the int8
error-feedback compression, as ``tests/test_distributed_extras.py`` trains
the JAX package through it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import compressed_grad_transform, init_error_buffers
from repro_torch.models import init_params, param_specs
from repro_torch.models.common import tree_leaves
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import init_train_state

REPO = Path(__file__).resolve().parents[1]


def test_training_converges_with_compression():
    cfg = get_reduced("granite_3_2b")
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(cfg, params)
    err = {"e": init_error_buffers(state.params)}
    step_fn = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30),
                              grad_transform=compressed_grad_transform(err))
    data = SyntheticLMData(vocab=cfg.vocab_size, batch=4, seq=64, seed=5, device="cpu")
    losses = []
    for s in range(25):
        state, m = step_fn(state, data.batch_at(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    # the buffer is carried: it holds the last step's residual
    assert any(bool(e.any()) for e in tree_leaves(err["e"]))


def test_example_trains_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, str(REPO / "examples" / "torch_train_lm.py"),
                          "--device", "cpu", "--steps", "30", "--d-model", "64", "--layers", "2",
                          "--batch", "4", "--seq", "32", "--ckpt", str(tmp_path / "ck")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "(decreasing)" in out.stdout and "resumed at step 30" in out.stdout
    assert out.stdout.strip().endswith("OK")
    assert (tmp_path / "ck" / "manifest.json").exists()
