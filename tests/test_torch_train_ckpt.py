"""The port's checkpoints, in the JAX package's on-disk format, on the CPU:
a round trip, corruption (the CRC32 of a leaf), a shape mismatch against
the template, ``AsyncCheckpointer``'s garbage collection and its host
snapshot, a kill-and-resume that continues bit for bit (as
``tests/test_distributed_extras.py`` holds the JAX package's), and
cross-reading both ways: a port checkpoint restored by JAX's
``restore_checkpoint(template=JAX TrainState)`` and a JAX checkpoint
restored by the port, every leaf ``np.array_equal`` in value and dtype,
the manifests' paths equal. ``convert.train_state_from_numpy`` carries a
JAX ``TrainState`` into the port with the parameter checks.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.train.train_loop import init_train_state as jax_init_state
from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint, save_checkpoint
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import SyntheticLMData
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.train_loop import TrainState, clone_state, init_train_state

ARCH = "granite_3_2b"


def _states():
    """(JAX config, port config, JAX TrainState, the port's of the same
    parameters, a step taken so that every moment is non-zero)."""
    jc, tc = P.configs(ARCH)
    jparams = P.jax_params(jc)
    jstate = jax_init_state(jc, jparams)
    state = init_train_state(tc, P.port_params(tc, jparams))
    data = SyntheticLMData(vocab=tc.vocab_size, batch=2, seq=16, seed=3, device="cpu")
    state, _ = make_train_step(tc, AdamWConfig(lr=1e-3, warmup_steps=1))(state, data.batch_at(0))
    return jc, tc, jstate, state


def _leaves(state):
    """A state's leaves in JAX's flatten order: params, then opt_state."""
    return tree_leaves(state.params) + tree_leaves(state.opt_state)


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_round_trip_is_exact(tmp_path):
    _, _, _, state = _states()
    save_checkpoint(tmp_path / "ck", state, step=7, extra={"note": "x"})
    restored, meta = restore_checkpoint(tmp_path / "ck", template=state, device="cpu")
    assert meta == {"step": 7, "note": "x"}
    assert isinstance(restored, TrainState)
    _assert_states_equal(restored, state)
    assert restored.opt_state["step"].dtype == torch.int32
    assert not (tmp_path / "ck.tmp").exists()


def test_corruption_is_detected(tmp_path):
    _, _, _, state = _states()
    save_checkpoint(tmp_path / "ck", state, step=1)
    victim = sorted((tmp_path / "ck").glob("leaf_*.npy"))[3]
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path / "ck", template=state, device="cpu")


def test_shape_mismatch_and_missing_leaf_are_rejected(tmp_path):
    _, tc, _, state = _states()
    save_checkpoint(tmp_path / "ck", state, step=1)
    wide = P.configs(ARCH, d_model=128, n_heads=8, d_ff=256)
    bad = init_train_state(wide[1], P.port_params(wide[1], P.jax_params(wide[0])))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(tmp_path / "ck", template=bad, device="cpu")
    save_checkpoint(tmp_path / "params", state.params, step=1)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(tmp_path / "params", template=state, device="cpu")


def test_async_checkpointer_keeps_the_newest_and_snapshots(tmp_path):
    _, _, _, state = _states()
    ck = AsyncCheckpointer(str(tmp_path / "ckpts"), keep=2)
    assert ck.latest() is None
    for step in (1, 2, 3, 4):
        ck.save(state, step=step)
        if step == 4:
            # the snapshot is the state at save(): writing the parameters
            # in place afterwards (as the next train step does) changes nothing
            saved = clone_state(state)
            for t in tree_leaves(state.params):
                t.add_(1.0)
    ck.wait()
    assert ck.latest().name == "step_00000004"
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()) == [
        "step_00000003", "step_00000004"]
    restored, meta = restore_checkpoint(ck.latest(), template=state, device="cpu")
    assert meta["step"] == 4
    _assert_states_equal(restored, saved)


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    _, _, _, state = _states()
    (tmp_path / "file").write_text("")
    ck = AsyncCheckpointer(str(tmp_path / "file"))
    ck.save(state, step=1)
    with pytest.raises(OSError):
        ck.wait()


def test_kill_and_resume_is_bitwise(tmp_path):
    _, tc, _, state = _states()
    data = SyntheticLMData(vocab=tc.vocab_size, batch=2, seq=32, seed=3, device="cpu")
    step_fn = make_train_step(tc, AdamWConfig(lr=1e-3), microbatches=2)
    for s in range(1, 4):
        state, _ = step_fn(state, data.batch_at(s))
    save_checkpoint(tmp_path / "ck", state, step=4)
    state_a, metrics_a = step_fn(clone_state(state), data.batch_at(4))
    restored, meta = restore_checkpoint(tmp_path / "ck", template=state, device="cpu")
    state_b, metrics_b = step_fn(restored, data.batch_at(meta["step"]))
    _assert_states_equal(state_a, state_b)
    assert all(torch.equal(metrics_a[k], metrics_b[k]) for k in metrics_a)


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


def test_port_checkpoint_restores_in_jax(tmp_path):
    _, _, jstate, state = _states()
    save_checkpoint(tmp_path / "port", state, step=5, extra={"from": "port"})
    jax_save(tmp_path / "jax", jstate, step=5)
    # the same paths in the same order: JAX's key strings
    assert _manifest(tmp_path / "port")["paths"] == _manifest(tmp_path / "jax")["paths"]
    assert _manifest(tmp_path / "port")["paths"][0] == "[<flat index 0>]/['embed']"
    restored, meta = jax_restore(tmp_path / "port", template=jstate)
    assert meta == {"step": 5, "from": "port"}
    assert type(restored).__name__ == "TrainState"
    for got, want in zip(jax.tree_util.tree_leaves(restored), _leaves(state)):
        got = np.asarray(got)
        assert got.dtype == want.numpy().dtype and np.array_equal(got, want.numpy())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    _, _, jstate, state = _states()
    # a JAX state with every leaf non-zero: the port's stepped one, carried over
    moved = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jstate),
                                         [jnp.asarray(t.numpy()) for t in _leaves(state)])
    jax_save(tmp_path / "jax", moved, step=9)
    restored, meta = restore_checkpoint(tmp_path / "jax", template=state, device="cpu")
    assert meta["step"] == 9
    for got, want in zip(_leaves(restored), jax.tree_util.tree_leaves(moved)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)
    # without a template both packages rebuild the same nested dict
    port_tree, _ = restore_checkpoint(tmp_path / "jax", device="cpu")
    jax_tree, _ = jax_restore(tmp_path / "jax")
    flat_p = jax.tree_util.tree_flatten_with_path(tree_map(lambda t: t.numpy(), port_tree))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_j]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_p, flat_j))


def test_train_state_from_numpy_carries_a_jax_state():
    jc, tc, jstate, _ = _states()
    tree = {"params": jstate.params, "opt_state": jstate.opt_state}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    state = train_state_from_numpy(tc, tree, device="cpu")
    assert isinstance(state, TrainState)
    assert state.opt_state["step"].dtype == torch.int32 and int(state.opt_state["step"]) == 0
    for got, want in zip(_leaves(state), jax.tree_util.tree_leaves(jstate)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="keys"):
        train_state_from_numpy(tc, {"params": tree["params"]}, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        train_state_from_numpy(tc, dict(tree, opt_state={**tree["opt_state"], "extra": 0}),
                               device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        train_state_from_numpy(tc, dict(tree, opt_state={**tree["opt_state"],
                                                         "step": np.zeros(2)}), device="cpu")
    bad_mu = dict(tree["opt_state"]["mu"], embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="misshaped"):
        train_state_from_numpy(tc, dict(tree, opt_state={**tree["opt_state"], "mu": bad_mu}),
                               device="cpu")
