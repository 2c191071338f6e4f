"""The training launcher (``python -m repro_torch.launch.train``) runs
reduced on the CPU: one train step of every architecture (the port's
counterpart of the JAX package's ``test_smoke_train_step``: a finite loss
and grad norm, the parameters moved), and as a module.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.launch import train
from repro_torch.models import init_params, param_specs
from repro_torch.models.common import tree_leaves

REPO = Path(__file__).resolve().parents[1]


def _initial(arch):
    cfg = get_reduced(arch)
    return init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step_of_every_arch(arch):
    out = train.main(["--arch", arch, "--steps", "1", "--batch", "2", "--seq", "64",
                      "--microbatches", "2", "--device", "cpu"])
    assert out["device"] == "cpu" and len(out["losses"]) == 1
    assert np.isfinite(out["losses"][0]) and np.isfinite(out["grad_norms"][0])
    moved = [float((a - b).abs().max())
             for a, b in zip(tree_leaves(out["state"].params), tree_leaves(_initial(arch)))]
    assert max(moved) > 0
    assert int(out["state"].opt_state["step"]) == 1


def test_train_cli_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "rwkv6_7b", "--steps", "2", "--batch", "2", "--seq", "16",
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[train] arch=rwkv6-reduced family=rwkv6 device=cpu" in out.stdout
    assert "step     1 loss" in out.stdout
