"""The LM stack's serving path on the card against the same on the CPU: the
reduced configs of every ported family (dense, and a windowed granite;
MoE deepseek and mixtral; RWKV-6 with its chunked WKV; the RG-LRU hybrid)
through ``prefill``, eight teacher-forced ``decode_step``s and
``forward``, the parameters made on the CPU and carried to the card with
``convert.lm_params_from_numpy``; then ``launch.serve.serve`` on the card.

Tolerance (float32, TF32 off, torch's default for matmul): logits
``rtol = atol = 1e-4`` elementwise, cache leaves ``rtol = 1e-4``,
``atol = 1e-4 * max|leaf|`` (as ``tests/test_torch_lm_decode.py`` holds the
port to JAX); greedy tokens equal where the CPU's top-2 margin exceeds
1e-3. The hybrid adds twice the CPU's own spread between two float32
evaluations that differ only in the last bit of the RG-LRU's decay ``a``
(the port's, rounded from float64, and torch's float32 exp): its
``sqrt(1 - a^2)`` with ``a`` a few ulps below 1 moves by up to 2^-12 with
that bit (``models/rglru.py``, ``tests/_lm_parity.py``), and the card and
the CPU still round the gate matmuls feeding ``log_a`` differently.

Marked ``cuda``: every test here skips on a host without a CUDA device (it
adds no pass there). On the card run it with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py

``chip_smoke.py``'s ``lm_serve`` phase runs granite-3-2b at full width.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import decode_step, forward, init_params, param_specs, prefill
from repro_torch.models import rglru
from repro_torch.models.common import tree_map, tree_paths

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-4
MARGIN = 1e-3
STEPS = 8
CASES = {
    "granite": ("granite_3_2b", None, 64),
    "phi3": ("phi3_mini_3_8b", None, 64),
    "qwen3": ("qwen3_32b", None, 64),
    "mistral_large": ("mistral_large_123b", None, 64),
    "granite_window": ("granite_3_2b", 16, 24),
    "deepseek_moe": ("deepseek_moe_16b", None, 64),
    "mixtral": ("mixtral_8x7b", None, 64),
    "rwkv6": ("rwkv6_7b", None, 64),
    "rwkv6_chunked": ("rwkv6_7b", None, 32),
    "recurrentgemma": ("recurrentgemma_2b", None, 64),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _snapshot(logits, cache):
    # copies: decode_step writes the cache in place, and .cpu() of a CPU
    # tensor is the tensor itself; the hybrid's cache nests
    return logits.to("cpu", copy=True), {
        k: v.to("cpu", copy=True) for k, v in tree_paths(cache).items()}


def _float32_decay(log_a):
    return torch.exp(log_a.float())


def _run(cfg, params, batch, S, tokens, dev):
    logits, cache, pos = prefill(cfg, params, batch, max_len=S + STEPS)
    out = [_snapshot(logits, cache)]
    for i in range(STEPS):
        logits, cache = decode_step(cfg, params, cache, pos + i, tokens[i].to(dev))
        out.append(_snapshot(logits, cache))
    return out, forward(cfg, params, batch, train=False)[0].cpu()


@pytest.mark.parametrize("name", list(CASES))
def test_reduced_configs_on_the_card_match_the_cpu(cuda, name):
    arch, window, S = CASES[name]
    cfg = get_reduced(arch)
    if window:
        cfg = dataclasses.replace(cfg, window=window)
    if name == "rwkv6_chunked":
        cfg = dataclasses.replace(cfg, wkv_chunk=8)
    cpu_params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    gpu_params = lm_params_from_numpy(cfg, tree_map(lambda t: t.numpy(), cpu_params),
                                      device=cuda)
    cpu_batch = make_train_batch(cfg, batch=2, seq_len=S, seed=1, device="cpu")
    gpu_batch = make_train_batch(cfg, batch=2, seq_len=S, seed=1, device=cuda)
    # teacher forcing: the CPU run's greedy tokens feed both runs
    logits, cache, pos = prefill(cfg, cpu_params, cpu_batch, max_len=S + STEPS)
    tokens = []
    for i in range(STEPS):
        tokens.append(logits[:, :cfg.vocab_size].argmax(-1))
        logits, cache = decode_step(cfg, cpu_params, cache, pos + i, tokens[-1])
    ref, ref_fwd = _run(cfg, cpu_params, cpu_batch, S, tokens, torch.device("cpu"))
    got, got_fwd = _run(cfg, gpu_params, gpu_batch, S, tokens, cuda)
    spread = {"logits": 0.0, "forward": 0.0, **{k: 0.0 for k in ref[0][1]}}
    if cfg.family == "hybrid":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rglru, "_decay", _float32_decay)
            alt, alt_fwd = _run(cfg, cpu_params, cpu_batch, S, tokens, torch.device("cpu"))
        for (al, ac), (rl, rc) in zip(alt, ref):
            spread["logits"] = max(spread["logits"], float((al - rl).abs().max()))
            for k in rc:
                spread[k] = max(spread[k], float((ac[k] - rc[k]).abs().max()))
        spread["forward"] = float((alt_fwd - ref_fwd).abs().max())
    for (gl, gc), (rl, rc) in zip(got, ref):
        np.testing.assert_allclose(gl.numpy(), rl.numpy(), rtol=RTOL,
                                   atol=ATOL + 2 * spread["logits"])
        for k in rc:
            np.testing.assert_allclose(gc[k].numpy(), rc[k].numpy(), rtol=RTOL,
                                       atol=ATOL * float(rc[k].abs().max()) + 2 * spread[k])
        top2 = rl[:, :cfg.vocab_size].topk(2).values
        clear = (top2[:, 0] - top2[:, 1]) > max(MARGIN, 4 * (ATOL + 2 * spread["logits"]))
        assert torch.equal(gl[:, :cfg.vocab_size].argmax(-1)[clear],
                           rl[:, :cfg.vocab_size].argmax(-1)[clear])
    np.testing.assert_allclose(got_fwd.numpy(), ref_fwd.numpy(), rtol=RTOL,
                               atol=ATOL + 2 * spread["forward"])


def test_serve_on_the_card(cuda):
    cfg = get_reduced("granite_3_2b")
    res = serve_mod.serve(cfg, batch=4, prompt_len=64, new_tokens=8, device=cuda, seed=0)
    assert res["device"].startswith("cuda") and res["logits_finite"]
    assert res["tokens"].shape == (4, 8)
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)).all()
    assert res["prefill_ms"] > 0 and len(res["decode_ms"]) == 7
    # the same seed, the same weights and tokens on the card
    again = serve_mod.serve(cfg, batch=4, prompt_len=64, new_tokens=8, device=cuda, seed=0)
    assert torch.equal(again["tokens"], res["tokens"])


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x7b", "rwkv6_7b",
                                  "recurrentgemma_2b"])
def test_serve_each_family_on_the_card(cuda, arch):
    cfg = get_reduced(arch)
    res = serve_mod.serve(cfg, batch=4, prompt_len=64, new_tokens=8, device=cuda, seed=0)
    assert res["device"].startswith("cuda") and res["logits_finite"]
    assert res["family"] == cfg.family and res["tokens"].shape == (4, 8)
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)).all()
    cpu = serve_mod.serve(cfg, batch=4, prompt_len=64, new_tokens=8, device="cpu", seed=0)
    assert res["cache_bytes"] == cpu["cache_bytes"] and res["param_bytes"] == cpu["param_bytes"]


def test_serve_cli_on_the_card(cuda, capsys):
    res = serve_mod.main(["--arch", "qwen3_32b", "--new-tokens", "4"])
    assert res["device"].startswith("cuda")
    assert capsys.readouterr().out.splitlines()[1].startswith("[serve] prefill ")
