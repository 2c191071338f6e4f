"""The training launcher's checkpoints and gradient compression on the CPU,
reduced granite: a checkpoint every few steps, a resume after a kill that
ends where an uninterrupted run ends, bit for bit (losses, parameters and
moments), and ``--compress-grads``, which changes the updates after the
first step.
"""
import shutil

import numpy as np
import torch

from repro_torch.launch import train
from repro_torch.models.common import tree_leaves


def _run(tmp_path, *extra):
    return train.main(["--arch", "granite_3_2b", "--steps", "8", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--device", "cpu",
                       *extra])


def test_checkpoints_and_resume_end_where_the_run_ends(tmp_path):
    full = _run(tmp_path / "a")
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_00000004", "step_00000008"]
    # kill after step 4: the resumed run takes steps 4-7 again
    cut = _run(tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_00000008")
    resumed = _run(tmp_path / "b", "--resume")
    assert resumed["start_step"] == 4 and len(resumed["losses"]) == 4
    assert resumed["losses"] == full["losses"][4:] == cut["losses"][4:]
    for a, b in zip(tree_leaves(resumed["state"].params) + tree_leaves(resumed["state"].opt_state),
                    tree_leaves(full["state"].params) + tree_leaves(full["state"].opt_state)):
        assert torch.equal(a, b)


def test_compressed_gradients_run():
    out = train.main(["--arch", "granite_3_2b", "--steps", "3", "--batch", "2", "--seq", "32",
                      "--compress-grads", "--device", "cpu"])
    plain = train.main(["--arch", "granite_3_2b", "--steps", "3", "--batch", "2", "--seq", "32",
                        "--device", "cpu"])
    assert all(np.isfinite(out["losses"])) and out["losses"][0] == plain["losses"][0]
    # the int8 round trip changes the update
    assert out["losses"][1:] != plain["losses"][1:]
