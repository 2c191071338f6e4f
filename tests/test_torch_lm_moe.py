"""The MoE family of the port against the JAX package's.

Serving: ``prefill``, twelve teacher-forced ``decode_step``s and
``forward(train=False)`` (logits and the routers' aux loss) on the reduced
deepseek-moe (64-expert family, 2 shared experts) and mixtral (sliding
window 32; prompts of 24 and 64 tokens, the ring wrapping in decode and
in prefill), JAX's parameters carried over with
``convert.lm_params_from_numpy``. Tolerances those of
``tests/test_torch_lm_decode.py`` plus twice the reference's own spread
(``tests/_lm_parity.py`` says how it is measured and why).

Routing (``models/moe.py``), read from JAX's ``moe_ffn`` through a
recorder of its ``jnp.einsum`` calls: ``top_e``, the kept assignments and
``dispatch`` (0/1) equal JAX's exactly, and so does where ``combine`` is
nonzero; its values are the port's ``top_p`` bit for bit (one product a
slot), and ``top_p`` is within ``rtol = 1e-6`` of JAX's (the softmax's exp
and sum round differently in torch and XLA, by an ulp or two). Tied router
columns put the lower expert first; a group past its capacity gives zero
dispatch rows and does not raise; ``y`` and ``aux`` at ``rtol = 1e-5``
(``y``'s atol 1e-5 x max |y|: its entries are sums of terms up to ~300,
the experts' weights having std 1/sqrt(E) by ``init_params``' rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.models import common as JC
from repro.models import moe as JM
from repro_torch.models import moe as TM
from repro_torch.models.common import tree_map

STEPS = 12
# name -> (arch, prompt length)
CASES = {
    "deepseek": ("deepseek_moe_16b", 64),
    "mixtral": ("mixtral_8x7b", 64),
    "mixtral_wrapped": ("mixtral_8x7b", 24),
}


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    arch, S = CASES[request.param]
    jc, tc = P.configs(arch)
    jp = P.jax_params(jc)
    jax_run = P.run_jax(jc, jp, S, STEPS)
    port_run = P.run_port(tc, P.port_params(tc, jp), S, jax_run["tokens"])
    return {"cfg": tc, "S": S, "jax": jax_run, "port": port_run}


def test_prefill_matches_jax(run):
    spread = run["jax"]["spread"]
    assert np.array_equal(run["port"]["batch_tokens"], run["jax"]["batch_tokens"])
    assert run["port"]["pos"] == run["jax"]["pos"] == run["S"]
    assert run["port"]["logits"][0].shape == (2, run["cfg"].padded_vocab)
    P.assert_logits_close(run["port"]["logits"][0], run["jax"]["logits"][0], spread["logits"])
    P.assert_cache_close(run["port"]["caches"][0], run["jax"]["caches"][0], spread["cache"])


def test_decode_steps_match_jax(run):
    spread = run["jax"]["spread"]
    for i in range(1, STEPS + 1):
        assert torch.isfinite(run["port"]["logits"][i]).all()
        P.assert_logits_close(run["port"]["logits"][i], run["jax"]["logits"][i],
                              spread["logits"])
        P.assert_cache_close(run["port"]["caches"][i], run["jax"]["caches"][i],
                             spread["cache"])
    assert P.assert_greedy_equal_where_clear(run["port"]["logits"], run["jax"]["logits"],
                                             run["cfg"].vocab_size, spread["logits"]) > 0


def test_forward_logits_and_aux_match_jax(run):
    spread = run["jax"]["spread"]
    fwd = run["port"]["forward"]
    assert fwd.shape == (2, run["S"], run["cfg"].padded_vocab)
    P.assert_logits_close(fwd, run["jax"]["forward"], spread["forward"])
    aux = run["port"]["aux"]
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(run["jax"]["aux"]) > 0
    np.testing.assert_allclose(float(aux), float(run["jax"]["aux"]), rtol=P.RTOL,
                               atol=2 * spread["aux"])


# ---------------------------------------------------------------------------
# routing against JAX's moe_ffn
# ---------------------------------------------------------------------------
class _EinsumRecorder:
    """Stands in for ``jnp`` in ``repro.models.moe``: records the operands
    and the result of every ``einsum`` by its subscripts."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        out = jnp.einsum(spec, *ops, **kw)
        self.calls[spec] = ([np.asarray(o) for o in ops], np.asarray(out))
        return out


def _jax_moe(monkeypatch, cfg, params, x):
    """JAX's ``moe_ffn`` (eager) and the routing read from its einsums."""
    rec = _EinsumRecorder()
    monkeypatch.setattr(JM, "jnp", rec)
    y, aux = JM.moe_ffn({k: jnp.asarray(v) for k, v in params.items()}, cfg, jnp.asarray(x))
    monkeypatch.undo()
    (top_p, in_cap, slot_oh), combine = rec.calls["gsk,gske,gskc->gsec"]
    (_, onehot), _ = rec.calls["gske,gske->gsk"]
    _, dispatch = rec.calls["gske,gskc->gsec"]
    return {"y": np.asarray(y), "aux": float(aux), "top_p": top_p,
            "top_e": onehot.argmax(-1), "in_cap": in_cap, "dispatch": dispatch,
            "combine": combine}


def _moe_inputs(cfg, G, S, seed):
    specs = JM.moe_param_specs(JM.MoEConfig(**dataclasses.asdict(cfg)))
    params = jax.tree_util.tree_map(
        np.array, JC.init_params(specs, jax.random.PRNGKey(seed), dtype=jnp.float32))
    x = np.random.default_rng(seed).standard_normal((G, S, cfg.d_model)).astype(np.float32)
    return params, x


def assert_routing_equal(r, ref):
    """The exact parts equal, ``combine`` the port's own ``top_p`` where it
    is nonzero, ``top_p`` within an ulp or two of JAX's."""
    assert np.array_equal(r.top_e.numpy(), ref["top_e"])
    assert np.array_equal(r.in_cap.numpy(), ref["in_cap"])
    assert np.array_equal(r.dispatch.numpy(), ref["dispatch"])
    assert np.array_equal(r.combine.numpy() != 0, ref["combine"] != 0)
    # combine[g, s, e, c] = top_p[g, s, k] for the kept assignment (k -> e, c)
    want = torch.einsum("gsk,gske,gsec->gsec", r.top_p, r.in_cap, r.dispatch)
    assert torch.equal(r.combine, want)
    np.testing.assert_allclose(r.top_p.numpy(), ref["top_p"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(r.combine.numpy(), ref["combine"], rtol=1e-6, atol=0)


def assert_output_close(y, aux, ref):
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref["y"]).max()))
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5)


def _port_moe(cfg, params, x):
    tp = tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), params)
    tcfg = TM.MoEConfig(**dataclasses.asdict(cfg))
    r = TM.route(tp, tcfg, torch.from_numpy(x))
    y, aux = TM.moe_ffn(tp, tcfg, torch.from_numpy(x))
    return r, y, aux


# (d_model, d_expert, experts, top_k, shared, groups, group size): prefill-
# and decode-shaped groups of the reduced configs, and deepseek's 64 x top-6
MOE_SHAPES = {
    "deepseek_prefill": (64, 96, 8, 2, 2, 2, 64),
    "deepseek_decode": (64, 96, 8, 2, 2, 1, 4),
    "mixtral_prefill": (64, 128, 4, 2, 0, 2, 24),
    "wide_top6": (32, 16, 64, 6, 2, 3, 16),
}


@pytest.mark.parametrize("name", list(MOE_SHAPES))
def test_routing_dispatch_and_combine_equal_jax(monkeypatch, name):
    D, F_, E, K, n_shared, G, S = MOE_SHAPES[name]
    cfg = JM.MoEConfig(d_model=D, d_expert=F_, n_experts=E, top_k=K, n_shared=n_shared)
    params, x = _moe_inputs(cfg, G, S, seed=len(name))
    ref = _jax_moe(monkeypatch, cfg, params, x)
    r, y, aux = _port_moe(cfg, params, x)
    assert r.dispatch.shape[-1] == TM.capacity(TM.MoEConfig(**dataclasses.asdict(cfg)), S)
    assert_routing_equal(r, ref)
    assert_output_close(y, aux, ref)


def test_tied_router_columns_put_the_lower_expert_first(monkeypatch):
    cfg = JM.MoEConfig(d_model=16, d_expert=8, n_experts=6, top_k=2)
    params, x = _moe_inputs(cfg, 2, 8, seed=3)
    # experts 4 and 1 score the same, and lead every token
    x = x + 4.0
    params["router"][:, 1] = 1.0
    params["router"][:, 4] = 1.0
    ref = _jax_moe(monkeypatch, cfg, params, x)
    r, _, _ = _port_moe(cfg, params, x)
    probs = r.probs
    assert torch.equal(probs[..., 1], probs[..., 4])
    tied = r.top_p[..., 0] == r.top_p[..., 1]
    assert tied.all()
    assert (r.top_e[..., 0] == 1).all() and (r.top_e[..., 1] == 4).all()
    assert_routing_equal(r, ref)


def test_overflowing_group_drops_assignments_without_raising(monkeypatch):
    cfg = JM.MoEConfig(d_model=16, d_expert=8, n_experts=8, top_k=2)
    params, x = _moe_inputs(cfg, 1, 16, seed=5)
    x[:] = x[:, :1]  # one token repeated: every token picks the same two experts
    C = max(int(1.25 * 16 * 2 / 8), 4)
    assert C == 5
    ref = _jax_moe(monkeypatch, cfg, params, x)
    r, y, aux = _port_moe(cfg, params, x)
    e0, e1 = r.top_e[0, 0].tolist()
    assert (r.top_e[0, :, 0] == e0).all() and (r.top_e[0, :, 1] == e1).all()
    kept = r.dispatch[0].sum(dim=-1)  # [S, E]: the first C tokens of each queue
    for e in (e0, e1):
        assert kept[:C, e].eq(1).all() and kept[C:, e].eq(0).all()
    assert int(r.onehot.sum() - r.in_cap.sum()) == 2 * (16 - C)
    assert_routing_equal(r, ref)
    assert torch.equal(y[0, C:], torch.zeros_like(y[0, C:]))  # dropped, no shared experts
    assert_output_close(y, aux, ref)


def test_decode_routes_the_batch_as_one_group():
    """Prefill routes a group a sequence, decode one group of B tokens:
    the capacities differ, as in JAX (``decode.py:128``)."""
    cfg = TM.MoEConfig(d_model=8, d_expert=4, n_experts=64, top_k=6)
    assert TM.capacity(cfg, 64) == 7  # deepseek's prefill at a 64-token prompt
    assert TM.capacity(cfg, 4) == 4  # its decode of a batch of 4
    jcfg = JM.MoEConfig(d_model=8, d_expert=4, n_experts=64, top_k=6)
    for S in (1, 4, 64, 4096):
        assert TM.capacity(cfg, S) == max(int(jcfg.capacity_factor * S * 6 / 64), 4)
