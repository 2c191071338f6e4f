"""The training slice's synthetic data and gradient compression against the
JAX package's, on the CPU: ``SyntheticLMData`` gives JAX's tokens, labels
and frontend embeddings exactly, shard by shard and step by step (the same
``np.random`` stream; int64 tokens where JAX has int32), and the int8
compression with error feedback is exact: ``quantize_int8``'s ``q`` and
``scale``, ``dequantize_int8`` and ``ef_compress_tree`` over several steps
equal JAX's jitted ones bit for bit (round half to even in both). Under
jit XLA compiles the scale's ``max / 127.0 + 1e-12`` as one fused
multiply-add with ``float32(1/127)`` and the residual ``g - q * scale`` as
another, and the port spells them so; JAX run op by op rounds each
operation, so its scale lies within one ulp of the port's, ``q`` within
one and the residual within an ulp of the leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMData as JaxData
from repro.distributed import compression as JC
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import compression as TC
from repro_torch.models.common import tree_map


def _equal(port: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return port.shape == ref.shape and np.array_equal(port.numpy(), ref)


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (0, 4), (3, 4)])
@pytest.mark.parametrize("frontend", [0, 6])
def test_synthetic_data_matches_jax(shard, n_shards, frontend):
    kw = dict(vocab=97, batch=3, seq=17, seed=11, shard=shard, n_shards=n_shards,
              frontend_positions=frontend, d_model=8 if frontend else 0)
    ref, got = JaxData(**kw), SyntheticLMData(**kw, device="cpu")
    for step in (0, 1, 7, 1000):
        r, g = ref.batch_at(step), got.batch_at(step)
        assert r.keys() == g.keys() == ({"tokens", "labels"}
                                        | ({"frontend_embeds"} if frontend else set()))
        assert g["tokens"].dtype == g["labels"].dtype == torch.int64
        for key in r:
            assert _equal(g[key], r[key]), (step, key)
        if frontend:
            assert g["frontend_embeds"].dtype == torch.float32
        # labels are the next tokens of the stream
        assert torch.equal(g["labels"][:, :-1], g["tokens"][:, 1:])
        assert torch.equal(got.next_batch(step)["tokens"], g["tokens"])


def test_synthetic_data_is_pure_and_shards_differ():
    a = SyntheticLMData(vocab=50, batch=2, seq=8, seed=1, device="cpu")
    b = SyntheticLMData(vocab=50, batch=2, seq=8, seed=1, shard=1, n_shards=2, device="cpu")
    assert torch.equal(a.batch_at(5)["tokens"], a.batch_at(5)["tokens"])
    assert not torch.equal(a.batch_at(5)["tokens"], a.batch_at(6)["tokens"])
    assert not torch.equal(a.batch_at(5)["tokens"], b.batch_at(5)["tokens"])


def test_prefetching_yields_the_steps_in_order_and_stops():
    data = SyntheticLMData(vocab=50, batch=2, seq=8, seed=2, device="cpu")
    it = data.prefetching(start_step=3, depth=2)
    for want in (3, 4, 5, 6):
        step, batch = next(it)
        assert step == want and torch.equal(batch["tokens"], data.batch_at(want)["tokens"])
    it.close()  # the producer thread ends


def test_prefetching_raises_the_producers_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = SyntheticLMData(vocab=50, batch=2, seq=8).prefetching()
    with pytest.raises(RuntimeError, match="CUDA"):
        next(it)


def _sample(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(np.float32)
    x[:3] = 0.0
    return x


@pytest.mark.parametrize("n", [7, 256, 1000, 3 * 4096 + 5])
def test_quantize_dequantize_match_jax_bitwise(n):
    x = _sample(n, n)
    jq, js = jax.jit(JC.quantize_int8)(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert _equal(tq, jq) and _equal(ts, js)
    assert _equal(TC.dequantize_int8(tq, ts, x.shape, x.size),
                  jax.jit(JC.dequantize_int8, static_argnums=(2, 3))(jq, js, x.shape, x.size))
    # JAX op by op divides by 127: the scale within an ulp, q within one
    eq, es = JC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(es), maxulp=1)
    assert np.abs(tq.numpy().astype(int) - np.asarray(eq).astype(int)).max() <= 1


def test_quantize_rounds_half_to_even():
    # a block whose largest |x| is 127, so the scale is 1 and x / scale = x
    x = np.zeros(256, np.float32)
    x[:7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5]
    q, s = TC.quantize_int8(torch.from_numpy(x))
    assert float(s) == 1.0
    assert q[0, :7].tolist() == [127, 0, 2, 2, 0, -2, 4]
    assert _equal(q, JC.quantize_int8(jnp.asarray(x))[0])


def test_error_feedback_tree_matches_jax_over_steps():
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 300), "b": {"c": (17,), "d": (2, 3, 129)}}

    def tree(f):
        return {"a": f(shapes["a"]), "b": {k: f(v) for k, v in shapes["b"].items()}}

    grads = [tree(lambda s: (rng.standard_normal(s) * 0.01).astype(np.float32)) for _ in range(4)]
    je = JC.init_error_buffers(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    te = TC.init_error_buffers(tree_map(torch.from_numpy, grads[0]))
    compress = jax.jit(JC.ef_compress_tree)
    for g in grads:
        jg, je_next = compress(jax.tree_util.tree_map(jnp.asarray, g), je)
        tg, te_next = TC.ef_compress_tree(tree_map(torch.from_numpy, g), te)
        for ref, got in ((jg, tg), (je_next, te_next)):
            for r, t in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
                assert _equal(t, r)
        # JAX op by op on the same buffers rounds q * scale first: each
        # residual within an ulp of the leaf's largest |g + e|
        _, eager = JC.ef_compress_tree(jax.tree_util.tree_map(jnp.asarray, g), je)
        leaves = jax.tree_util.tree_leaves
        for r, t, gl, el in zip(leaves(eager), leaves(te_next), leaves(g), leaves(te)):
            ulp = np.spacing(np.abs(gl + el.numpy()).max())
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=0, atol=ulp)
        je, te = je_next, te_next


def test_compressed_transform_carries_the_residual():
    # tiny uniform gradients quantize to almost nothing alone; the buffer
    # carries the rest, so the stream delivers ~the true sum (JAX's test)
    g = {"w": torch.full((10,), 0.001)}
    state = {"e": TC.init_error_buffers(g)}
    transform = TC.compressed_grad_transform(state)
    total = torch.zeros(10)
    for _ in range(400):
        total = total + transform(g)["w"]
    np.testing.assert_allclose(total.numpy(), 0.4, rtol=0.05)
    assert state["e"]["w"].abs().max() < 0.001 / 127 * 2
