"""Shared helpers of the dry-run FLOP parity tests: one cell of a reduced
config as JAX's jitted program on the CPU, counted by ``analyze_hlo``,
and as the port's program on ``meta``, counted by ``OpCounter``.

Both count dot FLOPs alone, 2 * out * contracted (``hlo_analysis.py``).
The counts are equal but for dots one side has and the other has not,
each named in ``named_gaps``:

  * ``xla_size1`` — a port dot whose contraction has size 1 (an outer
    product: the RWKV-6 serial WKV's gradient of r·S w.r.t. the state).
    XLA's CPU compiler rewrites such a dot into a multiply, which
    ``analyze_hlo`` does not count. Added back to JAX's count.
  * ``xla_cse`` — the encoder-decoder prefill's cross-attention k / v
    projections of the encoder output, written twice in the JAX source
    (``src/repro/models/decode.py:331-336``: for the cache and inside
    ``multi_head_attention``) and in the port alike; XLA's common
    subexpression elimination keeps one of each. Added back to JAX's
    count.
  * ``jax_transpose`` — in the train step only: the gradients of an
    elementwise product that JAX writes as an einsum (RWKV-6's
    ``kv = einsum("bhk,bhv->bhkv")``, two contractions per token; the MoE
    combine's router weights, the ``gsk`` factor of
    ``einsum("gsk,gske,gskc->gsec")``, one contraction over the experts).
    JAX's autodiff transposes each into a dot; torch's autograd takes the
    same gradient as a multiply and a sum (``torch.einsum`` lowers a
    product with no contraction to ``mul``), so no dot. Taken from JAX's
    count.
"""
import dataclasses

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_reduced as jax_reduced
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import abstract_params as jax_abstract
from repro.models import decode_step as jax_decode
from repro.models import param_specs as jax_specs
from repro.models import prefill as jax_prefill
from repro.models.decode import init_decode_cache as jax_cache
from repro.train import AdamWConfig as JaxAdamW
from repro.train import make_train_step as jax_train_step
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.train_loop import TrainState as JaxTrainState
from repro_torch.configs import get_reduced
from repro_torch.launch.inputs import token_split
from repro_torch.launch.op_analysis import count_ops
from repro_torch.models import abstract_params, decode_step, param_specs, prefill
from repro_torch.models.decode import init_decode_cache
from repro_torch.train import AdamWConfig, TrainState, make_train_step
from repro_torch.train.optimizer import adamw_init

FAMILIES = ["granite_3_2b", "deepseek_moe_16b", "rwkv6_7b", "recurrentgemma_2b",
            "seamless_m4t_large_v2", "llava_next_mistral_7b"]
B, S, M = 4, 64, 2  # train batch, positions, microbatches; prefill/decode batch 2
MAX_LEN = S + 8


def _batches(cfg, b, labels):
    p, t = token_split(cfg, S)
    jb = {"tokens": jax.ShapeDtypeStruct((b, t), jnp.int32)}
    tb = {"tokens": torch.empty((b, t), dtype=torch.int64, device="meta")}
    if labels:
        jb["labels"] = jax.ShapeDtypeStruct((b, t), jnp.int32)
        tb["labels"] = torch.empty((b, t), dtype=torch.int64, device="meta")
    if p:
        jb["frontend_embeds"] = jax.ShapeDtypeStruct((b, p, cfg.d_model), jnp.float32)
        tb["frontend_embeds"] = torch.empty((b, p, cfg.d_model), device="meta")
    return jb, tb


def _hlo_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def counts(arch: str, kind: str, remat: bool = True):
    """(JAX's analyze_hlo flops, the port's OpCounter, the port's config)
    of one cell of ``arch``'s reduced config."""
    jcfg = dataclasses.replace(jax_reduced(arch), remat=remat)
    cfg = dataclasses.replace(get_reduced(arch), remat=remat)
    jp = jax_abstract(jax_specs(jcfg), dtype=jnp.float32)
    tp = abstract_params(param_specs(cfg))
    if kind == "prefill":
        jb, tb = _batches(cfg, 2, labels=False)
        jf = _hlo_flops(lambda p, b: jax_prefill(jcfg, p, b, max_len=MAX_LEN), jp, jb)
        _, c = count_ops(lambda: prefill(cfg, tp, tb, max_len=MAX_LEN), log=True)
    elif kind == "decode":
        enc = S // 4 if cfg.family == "encdec" else 0
        jc = jax.eval_shape(lambda: jax_cache(jcfg, 2, MAX_LEN, enc_len=enc, dtype=jnp.float32))
        tc = init_decode_cache(cfg, 2, MAX_LEN, enc_len=enc, device="meta")
        i32 = jax.ShapeDtypeStruct
        jf = _hlo_flops(lambda p, c, ps, t: jax_decode(jcfg, p, c, ps, t), jp, jc,
                        i32((), jnp.int32), i32((2,), jnp.int32))
        pos = torch.empty((), dtype=torch.int64, device="meta")
        tok = torch.empty((2,), dtype=torch.int64, device="meta")
        _, c = count_ops(lambda: decode_step(cfg, tp, tc, pos, tok), log=True)
    else:
        jb, tb = _batches(cfg, B, labels=True)
        jstate = jax.eval_shape(lambda: JaxTrainState(
            params=jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), jp),
            opt_state=jax_adamw_init(jp)))
        jf = _hlo_flops(jax_train_step(jcfg, JaxAdamW(), microbatches=M), jstate, jb)
        state = TrainState(params=tp, opt_state=adamw_init(tp))
        _, c = count_ops(lambda: make_train_step(cfg, AdamWConfig(), microbatches=M)(state, tb),
                         log=True)
    return jf, c, cfg


def _contracted(name, shapes) -> int:
    a = shapes[0] if name in ("mm", "bmm") else shapes[1]  # addmm / baddbmm: self first
    return a[-1]


def named_gaps(kind: str, counter, cfg) -> dict:
    """The dots one side counts and the other does not (module docstring),
    in FLOPs; ``xla_*`` are the port's, ``jax_transpose`` JAX's."""
    gaps = {"xla_size1": sum(f for name, shapes, f in counter.dots
                             if name in ("mm", "bmm", "addmm", "baddbmm")
                             and _contracted(name, shapes) == 1)}
    if kind == "prefill" and cfg.family == "encdec":
        enc, b = S // 4, 2
        proj = 2 * b * enc * cfg.d_model * cfg.n_kv_heads * cfg.hd
        gaps["xla_cse"] = 2 * proj * (cfg.n_dec_layers or cfg.n_layers)
    if kind == "train":
        tokens = (B // M) * S
        if cfg.family == "rwkv6" and not (cfg.wkv_chunk and S % cfg.wkv_chunk == 0):
            H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
            per_token = 2 * (2 * (B // M) * H * Dh * Dh)  # d k and d v of k ⊗ v
            gaps["jax_transpose"] = per_token * S * cfg.n_layers * M
        if cfg.family == "moe":
            gaps["jax_transpose"] = 2 * tokens * cfg.moe.top_k * cfg.moe.n_experts \
                * cfg.n_layers * M
    return gaps


def assert_equal_but_named(jf: float, counter, cfg, kind: str) -> dict:
    gaps = named_gaps(kind, counter, cfg)
    port_only = sum(v for k, v in gaps.items() if k.startswith("xla"))
    jax_only = gaps.get("jax_transpose", 0)
    assert counter.flops - port_only == jf - jax_only, (counter.flops, jf, gaps)
    return gaps
