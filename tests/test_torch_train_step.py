"""The microbatched train step of the port against the JAX package's, on
the CPU: a whole ``make_train_step`` (microbatches 1 and 2) against JAX's
jitted one. The loss, ``grad_norm``, ``mu`` and ``nu`` at the gradient
tolerance of ``tests/_lm_parity.py`` (rtol 1e-4, atol 1e-4 x max|leaf|,
plus twice the spread of both packages' steps under one-ulp-nudged
parameters). The new parameters are compared only where the step's
direction is certain: Adam's first step is ``-lr * (g / (|g| + eps) + wd *
p)``, about ``+-lr``, so where |g| lies within the gradient tolerance of
zero (here: |mu| within mu's tolerance) the sign may flip; elsewhere they
are held at rtol 1e-6 plus ``lr * eps / |g|``, the most that ``g / (|g| +
eps)`` can move there. The step writes the state in place; a cloned state
takes the same step to the same bits.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.launch.inputs import make_train_batch as jax_batch
from repro.train import AdamWConfig as JaxAdamW
from repro.train import make_train_step as jax_make_step
from repro.train.train_loop import init_train_state as jax_init_state
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models.common import tree_leaves, tree_paths
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import clone_state, init_train_state

ARCH = "granite_3_2b"


def _step_run(step_fn, state, batch):
    state, metrics = step_fn(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("arch,microbatches", [(ARCH, 1), (ARCH, 2), ("deepseek_moe_16b", 2)])
def test_train_step_matches_jax(arch, microbatches):
    jc, tc = P.configs(arch)
    jparams = P.jax_params(jc)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_step(jc, JaxAdamW(**kw), microbatches=microbatches))
    jb = jax_batch(jc, batch=4, seq_len=32, seed=1)
    tb = make_train_batch(tc, batch=4, seq_len=32, seed=1, device="cpu")
    tstep = make_train_step(tc, AdamWConfig(**kw), microbatches=microbatches)

    def jax_run(p):
        s, m = jstep(jax_init_state(jc, p), jb)
        return s, {k: float(v) for k, v in m.items()}

    def port_run(p):
        return _step_run(tstep, init_train_state(tc, P.port_params(tc, p)), tb)

    (js, jm), (ts, tm) = jax_run(jparams), port_run(jparams)
    nudges = [jax_run(P.nudged(jparams, seed)) for seed in (0, 1)]
    port_nudge = port_run(P.nudged(jparams))

    assert int(ts.opt_state["step"]) == int(js.opt_state["step"]) == 1
    assert tm["lr"] == jm["lr"]
    for key in ("loss", "grad_norm"):
        spread = max([abs(m[key] - jm[key]) for _, m in nudges]
                     + [abs(port_nudge[1][key] - tm[key])])
        assert abs(tm[key] - jm[key]) <= P.ATOL + P.RTOL * abs(jm[key]) + 2 * spread, key
    tol = {}
    for mom in ("mu", "nu"):
        ref, got = P.jax_paths(js.opt_state[mom]), tree_paths(ts.opt_state[mom])
        others = [P.jax_paths(s.opt_state[mom]) for s, _ in nudges]
        own = tree_paths(port_nudge[0].opt_state[mom])
        for k, r in ref.items():
            spread = max([float(np.abs(o[k] - r).max()) for o in others]
                         + [float((own[k] - got[k]).abs().max())])
            tol[mom, k] = P.ATOL * float(np.abs(r).max()) + 2 * spread
            np.testing.assert_allclose(got[k].numpy(), r, rtol=P.RTOL, atol=tol[mom, k],
                                       err_msg=f"{mom} {'/'.join(k)}")
    # the parameters where the step's sign is certain. There the update is
    # -lr * (u + wd * p) with u = g / (|g| + eps) within eps / |g| of sign(g)
    # in both packages (g: the clipped gradient, mu / (1 - b1) after one step)
    ref_mu = P.jax_paths(js.opt_state["mu"])
    ref_p, got_p = P.jax_paths(js.params), tree_paths(ts.params)
    eps, b1, compared = AdamWConfig().eps, AdamWConfig().b1, 0
    for k, r in ref_p.items():
        sure = np.abs(ref_mu[k]) > tol["mu", k] + P.RTOL * np.abs(ref_mu[k])
        ghat = np.abs(ref_mu[k][sure]) / (1 - b1)
        gap = np.abs(got_p[k].numpy()[sure] - r[sure])
        assert (gap <= 1e-6 * np.abs(r[sure]) + kw["lr"] * eps / ghat).all(), "/".join(k)
        compared += int(sure.sum())
    assert compared > 0.5 * sum(r.size for r in ref_p.values())


def test_train_step_writes_the_state_in_place():
    cfg = P.configs(ARCH)[1]
    state = init_train_state(cfg, P.port_params(cfg, P.jax_params(P.configs(ARCH)[0])))
    kept = clone_state(state)
    batch = make_train_batch(cfg, batch=2, seq_len=16, seed=3, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    new, _ = step(state, batch)
    assert new.params["embed"] is state.params["embed"]
    assert not torch.equal(state.params["embed"], kept.params["embed"])
    # the kept copy takes the same step to the same bits
    again, _ = step(kept, batch)
    for a, b in zip(tree_leaves(dataclasses.asdict(new)), tree_leaves(dataclasses.asdict(again))):
        assert torch.equal(a, b)
