"""The dense serving path of the port against the JAX package's: ``prefill``,
twelve ``decode_step``s and ``forward(train=False)`` on the reduced
granite, phi3 (MHA) and qwen3 (qk-norm) configs and on a reduced granite
with a sliding window of 16 (prompts of 8 and 24 tokens, both decoding past
the ring's wrap-around). JAX's parameters are carried over with
``convert.lm_params_from_numpy``; both sides get the same
``make_train_batch`` tokens. Decoding is teacher-forced with the JAX run's
greedy tokens, so a near-tie cannot fork the two runs.

Tolerances (float32): logits ``rtol = atol = 1e-4`` elementwise. Cache
leaves ``rtol = 1e-4`` and ``atol = 1e-4 * max|leaf|``: a leaf's small
entries are differences of terms as large as its largest (up to ~25 here),
and the JAX float32 cache itself is up to 1.4 times the elementwise
``atol = 1e-4`` away from a float64 evaluation of the same model, so
elementwise ``atol = 1e-4`` sits below the reference's own rounding.
Greedy tokens are equal wherever JAX's top-2 margin exceeds 1e-3.

The serving entry points (``launch.serve``'s ``serve()`` and CLI) are
driven here for every family and both frontends; the MoE, RWKV-6 and
hybrid models are held to JAX in ``tests/test_torch_lm_moe.py`` and
``tests/test_torch_lm_recurrent.py``, the encoder-decoder seamless and
the vision-frontend llava in ``tests/test_torch_lm_encdec.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.launch.inputs import make_train_batch as jax_batch
from repro.models import decode_step as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro.models import param_specs as jax_specs
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import (
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    param_specs,
    prefill,
)
from repro_torch.models.common import tree_paths

B, STEPS = 2, 12
RTOL = ATOL = 1e-4
MARGIN = 1e-3
# name -> (arch, window, prompt length)
CASES = {
    "granite": ("granite_3_2b", None, 64),
    "phi3": ("phi3_mini_3_8b", None, 64),
    "qwen3": ("qwen3_32b", None, 64),
    "granite_window": ("granite_3_2b", 16, 8),
    "granite_window_wrapped": ("granite_3_2b", 16, 24),
}


def _cfgs(name):
    arch, window, _ = CASES[name]
    jc, tc = jax_reduced(arch), get_reduced(arch)
    if window is not None:
        jc, tc = dataclasses.replace(jc, window=window), dataclasses.replace(tc, window=window)
    return jc, tc


def assert_logits_close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def assert_cache_close(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        r = np.asarray(ref[k])
        assert port[k].shape == r.shape
        np.testing.assert_allclose(port[k].numpy(), r, rtol=RTOL,
                                   atol=ATOL * float(np.abs(r).max()))


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Both runs of one case: JAX (jit, CPU) and the port (CPU), teacher
    forced with JAX's greedy tokens."""
    name = request.param
    jc, tc = _cfgs(name)
    S = CASES[name][2]
    max_len = S + STEPS
    jp = jax_init(jax_specs(jc), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = lm_params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jb = jax_batch(jc, batch=B, seq_len=S, seed=1)
    tb = make_train_batch(tc, batch=B, seq_len=S, seed=1, device="cpu")

    j_logits, j_cache, j_pos = jax.jit(lambda p, b: jax_prefill(jc, p, b, max_len=max_len))(jp, jb)
    step = jax.jit(lambda p, c, pos, t: jax_decode(jc, p, c, pos, t))
    jax_run = {"logits": [np.asarray(j_logits)],
               "caches": [jax.tree_util.tree_map(np.asarray, j_cache)], "tokens": []}
    for i in range(STEPS):
        tok = jnp.argmax(j_logits[:, : jc.vocab_size], -1).astype(jnp.int32)
        jax_run["tokens"].append(np.asarray(tok))
        j_logits, j_cache = step(jp, j_cache, jnp.asarray(j_pos + i, jnp.int32), tok)
        jax_run["logits"].append(np.asarray(j_logits))
        jax_run["caches"].append(jax.tree_util.tree_map(np.asarray, j_cache))
    jax_run["forward"] = np.asarray(
        jax.jit(lambda p, b: jax_forward(jc, p, b, train=False)[0])(jp, jb))

    t_logits, t_cache, t_pos = prefill(tc, tp, tb, max_len=max_len)
    port_run = {"pos": t_pos, "logits": [t_logits],
                "caches": [{k: v.clone() for k, v in t_cache.items()}]}
    for i in range(STEPS):
        tok = torch.tensor(jax_run["tokens"][i], dtype=torch.int64)
        t_logits, t_cache = decode_step(tc, tp, t_cache, t_pos + i, tok)
        port_run["logits"].append(t_logits)
        port_run["caches"].append({k: v.clone() for k, v in t_cache.items()})
    port_run["forward"], aux = forward(tc, tp, tb, train=False)
    assert float(aux) == 0.0
    return {"name": name, "cfg": tc, "S": S, "j_pos": int(j_pos), "jax": jax_run,
            "port": port_run, "tokens_equal": np.array_equal(
                tb["tokens"].numpy(), np.asarray(jb["tokens"]))}


def test_prefill_matches_jax(run):
    assert run["tokens_equal"]
    assert run["port"]["pos"] == run["j_pos"] == run["S"]
    assert run["port"]["logits"][0].shape == (B, run["cfg"].padded_vocab)
    assert_logits_close(run["port"]["logits"][0], run["jax"]["logits"][0])
    assert_cache_close(run["port"]["caches"][0], run["jax"]["caches"][0])


def test_decode_steps_match_jax(run):
    for i in range(1, STEPS + 1):
        assert torch.isfinite(run["port"]["logits"][i]).all()
        assert_logits_close(run["port"]["logits"][i], run["jax"]["logits"][i])
        assert_cache_close(run["port"]["caches"][i], run["jax"]["caches"][i])


def test_decode_runs_past_the_ring_wrap(run):
    cfg, S = run["cfg"], run["S"]
    C = run["port"]["caches"][0]["k"].shape[2]
    assert C == (min(S + STEPS, cfg.window) if cfg.window else S + STEPS)
    if cfg.window:
        assert S + STEPS - 1 >= C  # the last steps write slots already used


def test_greedy_tokens_equal_where_the_margin_allows(run):
    V = run["cfg"].vocab_size
    compared = 0
    for port, ref in zip(run["port"]["logits"], run["jax"]["logits"]):
        ref = ref[:, :V]
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MARGIN
        got = torch.argmax(port[:, :V], dim=-1).numpy()
        assert np.array_equal(got[clear], np.argmax(ref, -1)[clear])
        compared += int(clear.sum())
    assert compared > 0


def test_forward_matches_jax_and_prefill(run):
    fwd = run["port"]["forward"]
    assert fwd.shape == (B, run["S"], run["cfg"].padded_vocab)
    assert_logits_close(fwd, run["jax"]["forward"])
    assert_logits_close(fwd[:, -1], run["jax"]["logits"][0])
    np.testing.assert_allclose(fwd[:, -1].numpy(), run["port"]["logits"][0].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_forward_train_raises():
    cfg = get_reduced("granite_3_2b")
    with pytest.raises(NotImplementedError, match="training"):
        forward(cfg, {}, {}, train=True)


@pytest.mark.parametrize("name", list(CASES))
def test_init_decode_cache_matches_prefill(name):
    _, cfg = _cfgs(name)
    S = CASES[name][2]
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg, batch=B, seq_len=S, seed=3, device="cpu")
    _, cache, _ = prefill(cfg, params, batch, max_len=S)
    blank = init_decode_cache(cfg, B, S, device="cpu")
    assert tree_paths(cache).keys() == tree_paths(blank).keys()
    for path, leaf in tree_paths(cache).items():
        other = tree_paths(blank)[path]
        assert leaf.shape == other.shape and leaf.dtype == other.dtype
        assert not other.any()


def test_decode_past_the_cache_raises():
    cfg = get_reduced("granite_3_2b")
    cache = init_decode_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        decode_step(cfg, {"embed": torch.zeros(cfg.padded_vocab, cfg.d_model)}, cache, 4,
                    torch.zeros(1, dtype=torch.int64))


def test_serve_cli_on_cpu(capsys):
    res = serve_mod.main(["--arch", "granite_3_2b", "--device", "cpu", "--new-tokens", "6"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] arch=granite-3-2b-reduced family=dense batch=4")
    assert out[1].startswith("[serve] prefill ") and out[1].endswith(" ms/token")
    assert res["tokens"].shape == (4, 6) and res["logits_finite"]
    assert ((res["tokens"] >= 0) & (res["tokens"] < 256)).all()
    assert len(res["decode_ms"]) == 5
    cfg = get_reduced("granite_3_2b")
    assert res["cache_bytes"] == 2 * 2 * 4 * 70 * 2 * 16 * 4
    assert res["param_bytes"] == 4 * cfg.param_count(param_specs(cfg))


# arch -> (family, the reduced cache's bytes at batch 4 and max_len 70)
SERVED = {
    "deepseek_moe_16b": ("moe", 2 * 2 * 4 * 70 * 4 * 16 * 4),
    "mixtral_8x7b": ("moe", 2 * 2 * 4 * 32 * 2 * 16 * 4),  # the window's ring
    "rwkv6_7b": ("rwkv6", 2 * 4 * (2 * 64 + 4 * 16 * 16) * 4),
    "recurrentgemma_2b": ("hybrid", 4 * ((2 + 2) * (3 * 64 + 64) + 2 * 32 * 16) * 4),
    # self k / v over 70 positions and the cross k / v of 64 / 4 = 16 frames
    "seamless_m4t_large_v2": ("encdec", 2 * 2 * 4 * (70 + 16) * 4 * 16 * 4),
    # 32 patches and 32 tokens of the 64-position prompt share the KV cache
    "llava_next_mistral_7b": ("dense", 2 * 2 * 4 * 70 * 2 * 16 * 4),
}


@pytest.mark.parametrize("arch", list(SERVED))
def test_serve_cli_on_cpu_each_family(capsys, arch):
    family, cache_bytes = SERVED[arch]
    res = serve_mod.main(["--arch", arch, "--device", "cpu", "--new-tokens", "6"])
    out = capsys.readouterr().out.splitlines()
    cfg = get_reduced(arch)
    assert out[0].startswith(f"[serve] arch={cfg.name} family={family} batch=4")
    assert out[1].startswith("[serve] prefill ") and out[1].endswith(" ms/token")
    assert res["family"] == family and res["tokens"].shape == (4, 6) and res["logits_finite"]
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)).all()
    assert len(res["decode_ms"]) == 5
    assert res["cache_bytes"] == cache_bytes
    assert res["param_bytes"] == 4 * cfg.param_count(param_specs(cfg))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "rwkv6_7b", "recurrentgemma_2b",
                                  "seamless_m4t_large_v2", "llava_next_mistral_7b"])
def test_serve_loop_of_each_family_matches_a_hand_driven_one(arch):
    cfg = get_reduced(arch)
    res = serve_mod.serve(cfg, batch=2, prompt_len=16, new_tokens=5, device="cpu", seed=4)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(4), device="cpu")
    batch = make_train_batch(cfg, batch=2, seq_len=16, seed=4, device="cpu")
    logits, cache, pos = prefill(cfg, params, batch, max_len=21)
    toks = [logits[:, :cfg.vocab_size].argmax(-1)]
    for i in range(4):
        logits, cache = decode_step(cfg, params, cache, pos + i, toks[-1])
        toks.append(logits[:, :cfg.vocab_size].argmax(-1))
    assert torch.equal(res["tokens"], torch.stack(toks, 1))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "rwkv6_7b", "recurrentgemma_2b"])
def test_init_decode_cache_matches_prefill_each_family(arch):
    cfg = get_reduced(arch)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    batch = make_train_batch(cfg, batch=B, seq_len=24, seed=3, device="cpu")
    _, cache, _ = prefill(cfg, params, batch, max_len=40)
    blank = init_decode_cache(cfg, B, 40, device="cpu")
    assert tree_paths(cache).keys() == tree_paths(blank).keys()
    for path, leaf in tree_paths(cache).items():
        other = tree_paths(blank)[path]
        assert leaf.shape == other.shape and leaf.dtype == other.dtype, path
        assert not other.any()
    wide = init_decode_cache(cfg, B, 40, dtype=torch.float64, device="cpu")
    for path, leaf in tree_paths(wide).items():  # the recurrent states stay float32
        want = torch.float32 if path[-1] in ("wkv", "h") else torch.float64
        assert leaf.dtype == want, path


def test_serve_greedy_loop_matches_a_hand_driven_one():
    cfg = get_reduced("qwen3_32b")
    res = serve_mod.serve(cfg, batch=2, prompt_len=16, new_tokens=5, device="cpu", seed=4)
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(4), device="cpu")
    batch = make_train_batch(cfg, batch=2, seq_len=16, seed=4, device="cpu")
    logits, cache, pos = prefill(cfg, params, batch, max_len=21)
    toks = [logits[:, :cfg.vocab_size].argmax(-1)]
    for i in range(4):
        logits, cache = decode_step(cfg, params, cache, pos + i, toks[-1])
        toks.append(logits[:, :cfg.vocab_size].argmax(-1))
    assert torch.equal(res["tokens"], torch.stack(toks, 1))


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llava_next_mistral_7b"])
def test_serve_cli_takes_reduced_and_full(monkeypatch, arch):
    seen = []
    monkeypatch.setattr(serve_mod, "serve", lambda cfg, **kw: seen.append((cfg, kw)) or {
        "prefill_ms": 1.0, "decode_ms_per_token": 1.0, "tokens": torch.zeros(kw["batch"], 1)})
    serve_mod.main(["--arch", arch, "--device", "cpu", "--reduced"])
    serve_mod.main(["--arch", arch, "--device", "cpu", "--full", "--batch", "1"])
    assert seen[0][0] == get_reduced(arch) and seen[1][0] == get_config(arch)
    assert seen[1][1]["batch"] == 1 and seen[1][1]["device"] == torch.device("cpu")


def test_serve_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(["--arch", "granite_3_2b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve(get_reduced("granite_3_2b"), batch=1, prompt_len=4, new_tokens=2)
