"""The training slice on the card against the same on the CPU: one
``make_train_step`` (2 microbatches) of every reduced config from the same
parameters and batch, its loss, ``grad_norm`` and every gradient leaf; a
resume from an ``AsyncCheckpointer`` checkpoint on the card; the train CLI
with ``--device cuda``.

Tolerance (float32, TF32 off): the gradient tests' (``tests/_lm_parity.py``),
rtol 1e-4 and atol 1e-4 x max|leaf|, plus twice the CPU's own spread under
two draws of one-ulp-nudged parameters (and, for the hybrid, under a float32 exp in the
RG-LRU's decay, whose last bit the card and the host round apart:
``tests/test_torch_lm_cuda.py``). The resume is bitwise where the card
repeats a step bit for bit, else within twice that repeat's spread.

Marked ``cuda``: every test here skips on a host without a CUDA device (it
adds no pass there). On the card run it with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

``chip_smoke.py``'s ``lm_train`` phase trains granite-3-2b at full width.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as train_cli
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import init_params, param_specs, rglru
from repro_torch.models.common import tree_leaves, tree_map, tree_paths
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import clone_state, init_train_state, microbatch_grads

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _nudged(params, seed=0):
    """Every parameter moved up by one ulp with probability 1/2."""
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: torch.where(torch.rand(t.shape, generator=gen) < 0.5,
                                          torch.nextafter(t, torch.tensor(float("inf"))), t),
                    params)


def _step(cfg, params, batch):
    """(loss, grad_norm, {path: gradient on the CPU}) of one train step on
    a copy of ``params``."""
    grads, _ = microbatch_grads(cfg, params, batch, 2)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1), microbatches=2)
    _, m = step(init_train_state(cfg, tree_map(torch.clone, params)), batch)
    return float(m["loss"]), float(m["grad_norm"]), {
        k: v.cpu() for k, v in tree_paths(grads).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, monkeypatch):
    cfg = get_reduced(arch)
    cpu_params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    gpu_params = lm_params_from_numpy(cfg, tree_map(lambda t: t.numpy(), cpu_params),
                                      device=cuda)
    cpu_batch = make_train_batch(cfg, batch=4, seq_len=64, seed=1, device="cpu")
    ref = _step(cfg, cpu_params, cpu_batch)
    got = _step(cfg, gpu_params, make_train_batch(cfg, batch=4, seq_len=64, seed=1,
                                                  device=cuda))
    others = [_step(cfg, _nudged(cpu_params, draw), cpu_batch) for draw in (0, 1)]
    if cfg.family == "hybrid":
        monkeypatch.setattr(rglru, "_decay", lambda log_a: torch.exp(log_a.float()))
        others.append(_step(cfg, cpu_params, cpu_batch))
    for i in (0, 1):  # the loss, grad_norm
        spread = max(abs(o[i] - ref[i]) for o in others)
        assert abs(got[i] - ref[i]) <= ATOL + RTOL * abs(ref[i]) + 2 * spread
    assert got[2].keys() == ref[2].keys()
    for k, r in ref[2].items():
        spread = max(float((o[2][k] - r).abs().max()) for o in others)
        np.testing.assert_allclose(got[2][k].numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL * float(r.abs().max()) + 2 * spread,
                                   err_msg="/".join(k))


def _leaves(state):
    return tree_leaves(state.params) + tree_leaves(state.opt_state)


def test_resume_on_the_card(cuda):
    cfg = get_reduced("granite_3_2b")
    params = init_params(param_specs(cfg), torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    state = init_train_state(cfg, params)
    data = SyntheticLMData(vocab=cfg.vocab_size, batch=4, seq=64, seed=0, device="cuda")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1), microbatches=2)
    twin, _ = step(clone_state(state), data.batch_at(0))
    state, _ = step(state, data.batch_at(0))
    repeat = max(float((a - b).abs().max()) for a, b in zip(_leaves(state), _leaves(twin)))
    for s in (1, 2):
        state, _ = step(state, data.batch_at(s))
    with tempfile.TemporaryDirectory() as tmp:
        ck = AsyncCheckpointer(tmp)
        ck.save(state, step=3)
        ck.wait()
        restored, meta = restore_checkpoint(ck.latest(), template=state, device=cuda)
    assert meta["step"] == 3 and restored.params["embed"].device.type == "cuda"
    straight, _ = step(clone_state(state), data.batch_at(3))
    resumed, _ = step(restored, data.batch_at(3))
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        if repeat == 0.0:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 2 * repeat


@pytest.mark.parametrize("extra", [[], ["--compress-grads"]])
def test_train_cli_on_the_card(cuda, extra):
    out = train_cli.main(["--arch", "granite_3_2b", "--steps", "6", "--device", "cuda", *extra])
    assert out["device"].startswith("cuda") and len(out["losses"]) == 6
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["grad_norms"]))
