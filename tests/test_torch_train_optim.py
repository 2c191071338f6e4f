"""AdamW of the port against the JAX package's, on the CPU:
``adamw_update`` fed JAX's own gradients (of the reduced granite, as numpy)
against JAX's ``adamw_update``: bitwise JAX run op by op where the gradient
is not clipped (the update is the same float32 operations; the port's
square root is correctly rounded, as XLA's), and within rtol 1e-6 (atol
1e-6 x max|leaf|: a few ulps of the leaf) of JAX jitted and of a clipped
update, where XLA fuses multiply-adds and the global norm's reduction order
differs; ``lr_at`` bitwise across warmup and the cosine; ``global_norm``
and the train state's layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.launch.inputs import make_train_batch as jax_batch
from repro.models import logical_specs as jax_logical
from repro.models import loss_fn as jax_loss
from repro.models import param_specs as jax_specs
from repro.train import AdamWConfig as JaxAdamW
from repro.train import train_state_specs as jax_state_specs
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw
from repro.train.optimizer import global_norm as jax_global_norm
from repro.train.optimizer import lr_at as jax_lr_at
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import logical_specs, param_specs
from repro_torch.models.common import tree_leaves, tree_paths
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    adamw_update_,
    train_state_specs,
)
from repro_torch.train.optimizer import global_norm, lr_at
from repro_torch.train.train_loop import TrainState, init_train_state

ARCH = "granite_3_2b"


@pytest.fixture(scope="module")
def jax_grads():
    """The reduced granite's parameters and JAX's gradients at two batches."""
    jc, tc = P.configs(ARCH)
    params = P.jax_params(jc)
    grad = jax.jit(jax.grad(lambda p, b: jax_loss(jc, p, b, train=True)[0]))
    gs = [grad(params, jax_batch(jc, batch=2, seq_len=32, seed=s)) for s in (1, 2)]
    return tc, params, gs


def _to_port(tc, tree):
    return lm_params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _state_pair(tc, jopt):
    return {"mu": _to_port(tc, jopt["mu"]), "nu": _to_port(tc, jopt["nu"]),
            "step": torch.tensor(int(jopt["step"]), dtype=torch.int32)}


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("clip_norm", [1e4, 1.0])
def test_adamw_update_matches_jax_on_its_gradients(jax_grads, jit, clip_norm):
    tc, jparams, (g1, g2) = jax_grads
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=clip_norm)
    update = jax.jit(jax_adamw, static_argnums=0) if jit else jax_adamw
    # a second step, so that both moments are non-zero
    p1, s1, _ = update(JaxAdamW(**cfg), jparams, g1, jax_adamw_init(jparams))
    p2, s2, m2 = update(JaxAdamW(**cfg), p1, g2, s1)
    tp, ts, tm = adamw_update(AdamWConfig(**cfg), _to_port(tc, p1), _to_port(tc, g2),
                              _state_pair(tc, s1))
    assert int(ts["step"]) == int(s2["step"]) == 2 and ts["step"].dtype == torch.int32
    # XLA's fused cosine may move lr's last bit under jit
    np.testing.assert_allclose(float(tm["lr"]), float(m2["lr"]), rtol=0 if not jit else 1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(m2["grad_norm"]), rtol=1e-6)
    # the clip is active at 1.0 (the gradient's norm is ~30), not at 1e4
    assert (float(m2["grad_norm"]) > clip_norm) == (clip_norm == 1.0)
    for ref, got in ((p2, tp), (s2["mu"], ts["mu"]), (s2["nu"], ts["nu"])):
        ref, got = P.jax_paths(ref), tree_paths(got)
        assert ref.keys() == got.keys()
        for k, r in ref.items():
            g = got[k].numpy()
            assert g.dtype == r.dtype == np.float32
            if not jit and clip_norm > 1e3:
                assert np.array_equal(g, r), k
            else:
                np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6 * float(np.abs(r).max()),
                                           err_msg="/".join(k))


def test_adamw_update_is_pure_and_update_in_place_writes(jax_grads):
    tc, jparams, (g1, _) = jax_grads
    params, grads = _to_port(tc, jparams), _to_port(tc, g1)
    state = adamw_init(params)
    before = [t.clone() for t in tree_leaves(params) + tree_leaves(state)]
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    new_p, new_s, _ = adamw_update(cfg, params, grads, state)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params) + tree_leaves(state)))
    out_p, out_s, _ = adamw_update_(cfg, params, grads, state)
    assert out_p is params and out_s["mu"] is state["mu"] and int(state["step"]) == 0
    for a, b in zip(tree_leaves(new_p) + tree_leaves(new_s),
                    tree_leaves(out_p) + tree_leaves(out_s)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg", [dict(warmup_steps=100, total_steps=10_000),
                                 dict(lr=3e-3, warmup_steps=10, total_steps=60),
                                 dict(warmup_steps=0, total_steps=7, min_lr_ratio=0.25)])
def test_lr_at_matches_jax_across_warmup_and_cosine(cfg):
    steps = sorted({0, 1, 5, 9, 10, 11, 30, 59, 60, 61, 99, 100, 101, 5000, 9999, 10_000, 12_000})
    for s in steps:
        ref = jax_lr_at(JaxAdamW(**cfg), jnp.asarray(s, jnp.int32))
        got = lr_at(AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and float(got) == float(ref), s


def test_global_norm_sums_leaves_in_order(jax_grads):
    tc, _, (g1, _) = jax_grads
    grads = _to_port(tc, g1)
    np.testing.assert_allclose(float(global_norm(grads)), float(jax_global_norm(g1)), rtol=1e-6)
    sq = [torch.sum(torch.square(x)) for x in tree_leaves(grads)]
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    assert torch.equal(global_norm(grads), torch.sqrt(total))


def test_train_state_layout_matches_jax():
    jc, tc = P.configs("deepseek_moe_16b")
    state = init_train_state(tc, P.port_params(tc, P.jax_params(jc)))
    assert state.opt_state["step"].dtype == torch.int32 and state.opt_state["step"].shape == ()
    for mom in ("mu", "nu"):
        assert tree_paths(state.opt_state[mom]).keys() == tree_paths(state.params).keys()
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in tree_leaves(state.opt_state[mom]))
    ref = jax_state_specs(jax_logical(jax_specs(jc)))
    got = train_state_specs(logical_specs(param_specs(tc)))
    assert isinstance(got, TrainState)
    assert got.params == ref.params and got.opt_state == ref.opt_state
