"""The port's op counter (``launch/op_analysis.py``) on the programs of
``tests/test_hlo_analysis.py`` written in torch: its dot FLOPs equal
``analyze_hlo``'s on JAX's compiled program (loops included: an eager
loop runs every iteration, as the trip-count weighting assumes), the
weight stream's bytes lie within that file's bounds, and the ``meta``
count equals the CPU count op by op."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.launch.op_analysis import OpCounter, count_ops, tensor_bytes


def _jax_flops(fn, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*specs).compile().as_text()).flops


def _jax_scan(x, ws):
    def step(h, w):
        return jnp.tanh(h @ w), None

    return jax.lax.scan(step, x, ws)[0]


def _jax_nested(x, ws):
    def outer(hh, w):
        def inner(a, _):
            return jnp.tanh(a @ w), None

        return jax.lax.scan(inner, hh, None, length=5)[0], None

    return jax.lax.scan(outer, x, ws)[0]


def _loop(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def _nested(x, ws):
    for w in ws:
        for _ in range(5):
            x = torch.tanh(x @ w)
    return x


PROGRAMS = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b, [(256, 512), (512, 128)],
               2 * 256 * 512 * 128),
    "loop10": (_loop, _jax_scan, [(64, 128), (10, 128, 128)], 10 * 2 * 64 * 128 * 128),
    "nested10x5": (_nested, _jax_nested, [(64, 128), (10, 128, 128)],
                   10 * 5 * 2 * 64 * 128 * 128),
}


def _inputs(shapes, device):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).to(device) for s in shapes]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_flops_equal_analyze_hlo(name):
    fn, jfn, shapes, expected = PROGRAMS[name]
    _, c = count_ops(fn, *_inputs(shapes, "cpu"))
    assert c.flops == expected == _jax_flops(jfn, *shapes)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_meta_count_equals_cpu_op_by_op(name):
    fn, _, shapes, _ = PROGRAMS[name]
    out_cpu, c_cpu = count_ops(fn, *_inputs(shapes, "cpu"), log=True)
    out_meta, c_meta = count_ops(fn, *[torch.empty(s, device="meta") for s in shapes], log=True)
    assert c_meta.log == c_cpu.log and len(c_cpu.log) > 0
    assert c_meta.costed() == c_cpu.costed()
    assert (c_meta.flops, c_meta.bytes) == (c_cpu.flops, c_cpu.bytes)
    assert c_meta.breakdown() == c_cpu.breakdown()
    assert out_meta.shape == out_cpu.shape and out_meta.device.type == "meta"


def test_weight_stream_bytes_within_hlo_bounds():
    """Each of the 10 weights is read once a step: at least one slice read
    per iteration, nowhere near 10 reads of the full stack (the bounds of
    test_hlo_analysis.py)."""
    fn, _, shapes, _ = PROGRAMS["loop10"]
    _, c = count_ops(fn, *_inputs(shapes, "cpu"))
    per_iter_weights = 128 * 128 * 4
    assert 10 * per_iter_weights <= c.bytes < 10 * 10 * per_iter_weights
    assert c.by_op["unbind"].bytes == 0  # the loop's slices move no data


def test_views_move_no_data_and_counts_reach_backward():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    with OpCounter(log=True) as c:
        y = (x.t().contiguous().t() @ w).sum()
        y.backward()
    ops = {name for name, _, _ in c.log}
    assert {"t", "mm"} <= ops
    assert all(b == 0 for name, _, b in c.log if name in ("t", "view", "expand"))
    # forward x @ w plus the two gradient products
    assert c.flops == 3 * 2 * 8 * 16 * 4
    assert tensor_bytes(torch.zeros(4, 1).expand(4, 1000)) == 16
    assert c.peak_live_bytes > 0
