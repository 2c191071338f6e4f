"""Shared helpers of the LM parity tests of the MoE, RWKV-6 and hybrid
families: runs of the JAX package and of the port on the same parameters
and tokens (prefill, teacher-forced decode steps, ``forward``), caches
flattened to ``{path: array}``, and the comparisons.

Tolerance. The stated one is ``tests/test_torch_lm_decode.py``'s (float32):
logits ``rtol = atol = 1e-4`` elementwise, cache leaves ``rtol = 1e-4`` and
``atol = 1e-4 * max|leaf|``. To it each comparison adds twice the
reference's own resolution at these inputs, measured in the same test:
the largest gap (over the run, per logits / forward / aux / cache leaf)
between JAX's jitted run and two other float32 evaluations of the same JAX
function, (a) with every parameter moved by one ulp at random and (b) op by
op under ``jax.disable_jit()``. Where the reference is well conditioned
that spread is far below 1e-4 and the stated tolerance decides; where it is
not, no float32 evaluation (JAX's own included) is closer than the spread:
  * the RG-LRU's ``sqrt(max(1 - a^2, 1e-12))`` with ``a = exp(log_a)``
    within a few ulps of 1 (every channel whose gate r is small): ``1 - a^2``
    is a multiple of 2^-24 there, so ``mult`` moves by up to 2^-12 when
    ``a``'s last bit does, and XLA's fused evaluation keeps a different last
    bit than its op-by-op one (measured on the reduced recurrentgemma: jit
    against op-by-op, logits 1.0e-2 apart, max |logit| 3.3);
  * attention logits of std ~50 (``init_params``' ``fan_in = n_layers``),
    where two keys nearly tie (the reduced mixtral's forward at one
    position: a one-ulp nudge moves JAX's logits by 4.1e-4).
Greedy tokens are compared where the reference's top-2 margin exceeds
twice the logits' bound.

The training slice's gradients (``grad_run``, ``assert_grads_close``)
take the same rule: each leaf of ``jax.grad`` of ``loss_fn(train=True)``
within ``rtol = 1e-4`` and ``atol = 1e-4 * max|leaf|`` plus twice the
leaf's spread. A gradient is more sensitive than the logits: through the
near one-hot softmax (attention logits of std ~50) a one-ulp nudge moves
the reduced granite's attention gradients by up to ~9e-4 of a leaf's
largest, in JAX and in the port alike, and which draw moves them most
differs between the two; so the spread is the larger of both packages'
responses to the nudge (two draws for JAX, one for the port). The RG-LRU
adds ``d sqrt(1 - a^2) / da = -a / sqrt(1 - a^2)``: the reduced
recurrentgemma's gradients move by up to ~9% of a leaf's largest between
JAX's jitted and op-by-op runs, so its spread includes the op-by-op run
(which costs ~35 s of eager dispatch; for the other nine configs the
op-by-op run lies within 2.2e-4 of jit, inside the nudges' spread).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.launch.inputs import make_train_batch as jax_batch
from repro.models import decode_step as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro.models import loss_fn as jax_loss
from repro.models import param_specs as jax_specs
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.inputs import make_train_batch
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.train.train_loop import microbatch_grads

RTOL = ATOL = 1e-4
MARGIN = 1e-3
B = 2


def jax_paths(tree, prefix=()):
    """``{path: numpy array}`` of a JAX tree of dicts, sorted keys."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(jax_paths(tree[k], prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def snapshot(cache):
    """``{path: numpy copy}`` of the port's cache, cloned with a tree map
    (``decode_step`` writes it in place, and it nests for the hybrid)."""
    return {p: t.numpy() for p, t in tree_paths(tree_map(torch.clone, cache)).items()}


def configs(arch, **changes):
    """(JAX config, port config) of the arch's REDUCED twin, with
    ``changes`` through ``dataclasses.replace``."""
    return (dataclasses.replace(jax_reduced(arch), **changes),
            dataclasses.replace(get_reduced(arch), **changes))


def jax_params(jc):
    return jax_init(jax_specs(jc), jax.random.PRNGKey(0), dtype=jnp.float32)


def port_params(tc, jparams):
    return lm_params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def nudged(params, seed=0):
    """Every parameter moved up by one ulp with probability 1/2."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        a = np.asarray(a)
        return jnp.asarray(np.where(rng.random(a.shape) < 0.5,
                                    np.nextafter(a, np.float32(np.inf)), a))

    return jax.tree_util.tree_map(nudge, params)


def _run_jax(jc, params, S, steps, fns, tokens=None):
    batch = jax_batch(jc, batch=B, seq_len=S, seed=1)
    pf, step, fw = fns
    logits, cache, pos = pf(params, batch)
    out = {"logits": [np.asarray(logits)], "caches": [jax_paths(cache)], "tokens": [],
           "pos": int(pos), "batch_tokens": np.asarray(batch["tokens"])}
    for i in range(steps):
        tok = (jnp.argmax(logits[:, :jc.vocab_size], -1).astype(jnp.int32) if tokens is None
               else jnp.asarray(tokens[i]))
        out["tokens"].append(np.asarray(tok))
        logits, cache = step(params, cache, jnp.asarray(pos + i, jnp.int32), tok)
        out["logits"].append(np.asarray(logits))
        out["caches"].append(jax_paths(cache))
    f_logits, aux = fw(params, batch)
    out["forward"], out["aux"] = np.asarray(f_logits), np.asarray(aux)
    return out


def run_jax(jc, params, S, steps):
    """JAX's run (jitted): prefill over ``make_train_batch(seed=1)``,
    ``steps`` greedy decode steps, ``forward``; then the same teacher
    forced with nudged parameters and op by op, whose gaps to it are
    ``out["spread"]``."""
    def pf(p, b):
        return jax_prefill(jc, p, b, max_len=S + steps)

    def step(p, c, pos, t):
        return jax_decode(jc, p, c, pos, t)

    def fw(p, b):
        return jax_forward(jc, p, b, train=False)

    out = _run_jax(jc, params, S, steps, (jax.jit(pf), jax.jit(step), jax.jit(fw)))
    others = [_run_jax(jc, nudged(params), S, steps, (jax.jit(pf), jax.jit(step), jax.jit(fw)),
                       out["tokens"])]
    with jax.disable_jit():
        others.append(_run_jax(jc, params, S, steps, (pf, step, fw), out["tokens"]))
    out["spread"] = spread(out, others)
    return out


def spread(ref, others):
    """Per kind, the largest gap between ``ref`` and the other runs."""
    gap = {"logits": 0.0, "forward": 0.0, "aux": 0.0,
           "cache": {p: 0.0 for p in ref["caches"][0]}}
    for o in others:
        gap["logits"] = max([gap["logits"]] + [float(np.abs(a - b).max())
                                               for a, b in zip(ref["logits"], o["logits"])])
        gap["forward"] = max(gap["forward"], float(np.abs(ref["forward"] - o["forward"]).max()))
        gap["aux"] = max(gap["aux"], float(np.abs(ref["aux"] - o["aux"])))
        for p in gap["cache"]:
            gap["cache"][p] = max([gap["cache"][p]] + [
                float(np.abs(a[p] - b[p]).max()) for a, b in zip(ref["caches"], o["caches"])])
    return gap


def run_port(tc, params, S, tokens):
    """The port on the CPU, teacher forced with ``tokens``; the keys of
    ``run_jax`` but the spread."""
    batch = make_train_batch(tc, batch=B, seq_len=S, seed=1, device="cpu")
    logits, cache, pos = prefill(tc, params, batch, max_len=S + len(tokens))
    out = {"logits": [logits.clone()], "caches": [snapshot(cache)], "pos": pos,
           "batch_tokens": batch["tokens"].numpy()}
    for i, tok in enumerate(tokens):
        logits, cache = decode_step(tc, params, cache, pos + i,
                                    torch.tensor(tok, dtype=torch.int64))
        out["logits"].append(logits.clone())
        out["caches"].append(snapshot(cache))
    f_logits, aux = forward(tc, params, batch, train=False)
    out["forward"], out["aux"] = f_logits, aux
    return out


def assert_logits_close(port, ref, spread=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL + 2 * spread)


def assert_cache_close(port, ref, spread=None):
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        assert port[k].shape == r.shape and port[k].dtype == r.dtype, k
        extra = 2 * spread[k] if spread else 0.0
        np.testing.assert_allclose(port[k], r, rtol=RTOL,
                                   atol=ATOL * float(np.abs(r).max()) + extra,
                                   err_msg="/".join(k))


def assert_greedy_equal_where_clear(port_logits, ref_logits, vocab, spread=0.0):
    """Greedy tokens equal wherever the reference's top-2 margin exceeds
    ``MARGIN`` and twice the logits' bound; returns the rows compared."""
    compared = 0
    for port, ref in zip(port_logits, ref_logits):
        ref = ref[:, :vocab]
        top2 = np.sort(ref, axis=-1)[:, -2:]
        bound = ATOL + 2 * spread + RTOL * np.abs(top2).max()
        clear = top2[:, 1] - top2[:, 0] > max(MARGIN, 2 * bound)
        got = torch.argmax(port[:, :vocab], dim=-1).numpy()
        assert np.array_equal(got[clear], np.argmax(ref, -1)[clear])
        compared += int(clear.sum())
    return compared



def _gaps(ref, others):
    return {k: max(float(np.abs(o[k] - r).max()) for o in others) for k, r in ref.items()}


def grad_run(arch, S, *, op_by_op=False, **changes):
    """JAX's loss and gradients (``jax.value_and_grad`` of ``loss_fn(train=
    True)``, jitted) and the port's (``microbatch_grads`` on the CPU) on
    the arch's reduced parameters (``changes`` applied) and
    ``make_train_batch(batch=B, seq_len=S, seed=1)``, with the spread: per
    leaf and for the loss, the largest gap of JAX jitted with parameters
    nudged by one ulp (two draws), of the port with the first draw, and
    (``op_by_op``) of JAX under ``jax.disable_jit()``, each to the same
    package unnudged. Where a float32 evaluation of the function moves by
    its last bits, no float32 evaluation is closer than that."""
    jc, tc = configs(arch, **changes)
    jparams = jax_params(jc)
    jb = jax_batch(jc, batch=B, seq_len=S, seed=1)

    def f(p, b):
        return jax_loss(jc, p, b, train=True)[0]

    vg = jax.value_and_grad(f)
    loss, grads = jax.jit(vg)(jparams, jb)
    ref = jax_paths(grads)
    others = [jax.jit(vg)(nudged(jparams, seed), jb) for seed in (0, 1)]
    if op_by_op:
        with jax.disable_jit():
            others.append(vg(jparams, jb))
    port_loss, port = port_grad_run(tc, port_params(tc, jparams), S)
    nudged_loss, port_nudged = port_grad_run(tc, port_params(tc, nudged(jparams)), S)
    spread = {k: max(a, b) for (k, a), b in zip(
        _gaps(ref, [jax_paths(g) for _, g in others]).items(),
        _gaps(port, [port_nudged]).values())}
    loss_spread = max([abs(float(l) - float(loss)) for l, _ in others]
                      + [abs(nudged_loss - port_loss)])
    return {"loss": float(loss), "grads": ref, "spread": spread, "loss_spread": loss_spread,
            "port_loss": port_loss, "port_grads": port}


def port_grad_run(tc, params, S, *, batch=B, seed=1, microbatches=1):
    """The port's loss and mean gradients on the CPU (``microbatch_grads``)
    over ``make_train_batch(seed)``: (loss, {path: numpy array})."""
    tb = make_train_batch(tc, batch=batch, seq_len=S, seed=seed, device="cpu")
    grads, loss = microbatch_grads(tc, params, tb, microbatches)
    return float(loss), {k: t.numpy() for k, t in tree_paths(grads).items()}


def assert_grads_close(port, ref, spread):
    """Every leaf at rtol 1e-4, atol 1e-4 * max|leaf| plus twice its spread."""
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        assert port[k].shape == r.shape and port[k].dtype == r.dtype, k
        np.testing.assert_allclose(port[k], r, rtol=RTOL,
                                   atol=ATOL * float(np.abs(r).max()) + 2 * spread[k],
                                   err_msg="/".join(k))


def assert_loss_close(port, run):
    assert abs(port - run["loss"]) <= ATOL + RTOL * abs(run["loss"]) + 2 * run["loss_spread"]
