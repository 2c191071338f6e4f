"""The port's LM configs and parameter trees against the JAX package's: the
four dense and the four MoE / RWKV-6 / hybrid configs field for field, the
registry, the full-size parameter specs leaf for leaf (no allocation), the
per-leaf init scale, and ``convert.lm_params_from_numpy`` (its checks, and
each family's REDUCED tree carried over from JAX's ``init_params``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.models import common as JC
from repro.models import lm as JL
from repro_torch import configs as TCFG
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import inputs as TI
from repro_torch.models import abstract_params, init_params, logical_specs, param_specs
from repro_torch.models import common as TC
from repro_torch.models.lm import ModelConfig

DENSE = ["granite_3_2b", "phi3_mini_3_8b", "qwen3_32b", "mistral_large_123b"]
FAMILIES = ["deepseek_moe_16b", "mixtral_8x7b", "rwkv6_7b", "recurrentgemma_2b"]
PORTED = DENSE + FAMILIES
LATER = ["seamless_m4t_large_v2", "llava_next_mistral_7b"]


def _jax_specs(cfg):
    leaves = jax.tree_util.tree_flatten_with_path(
        JL.param_specs(cfg), is_leaf=lambda x: isinstance(x, JC.ParamSpec))[0]
    return {tuple(k.key for k in path): s for path, s in leaves}


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_jax(arch):
    for which in ("MODEL", "REDUCED"):
        j = getattr(__import__(f"repro.configs.{arch}", fromlist=[which]), which)
        t = getattr(__import__(f"repro_torch.configs.{arch}", fromlist=[which]), which)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        for prop in ("hd", "padded_vocab", "sub_quadratic"):
            assert getattr(t, prop) == getattr(j, prop)
        assert dataclasses.asdict(t.attn_cfg()) == dataclasses.asdict(j.attn_cfg())
    assert TCFG.get_config(arch) == TCFG.get_config(arch.replace("_", "-"))
    assert dataclasses.asdict(TCFG.get_reduced(arch)) == dataclasses.asdict(
        JCFG.get_reduced(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_and_recurrent_configs_equal_jax(arch):
    for which in ("MODEL", "REDUCED"):
        j = getattr(__import__(f"repro.configs.{arch}", fromlist=[which]), which)
        t = getattr(__import__(f"repro_torch.configs.{arch}", fromlist=[which]), which)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        for prop in ("hd", "padded_vocab", "sub_quadratic"):
            assert getattr(t, prop) == getattr(j, prop)
        if t.moe is not None:
            assert type(t.moe).__module__ == "repro_torch.models.moe"
            assert [f.name for f in dataclasses.fields(t.moe)] == [
                f.name for f in dataclasses.fields(j.moe)]
        for sub in ("rwkv_cfg", "rglru_cfg"):
            assert dataclasses.asdict(getattr(t, sub)()) == dataclasses.asdict(getattr(j, sub)())
        assert t.rwkv_cfg().head_dim == j.rwkv_cfg().head_dim
    assert dataclasses.asdict(TCFG.get_config(arch)) == dataclasses.asdict(JCFG.get_config(arch))


def test_registry_equal_jax():
    assert TCFG.ARCH_IDS == JCFG.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in TCFG.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JCFG.SHAPES.items()}
    assert TCFG.SHAPES["decode_32k"].cell_name("x") == JCFG.SHAPES["decode_32k"].cell_name("x")
    assert TCFG.canonical("granite-3.2b") == JCFG.canonical("granite-3.2b")


@pytest.mark.parametrize("arch", PORTED)
def test_full_size_param_specs_equal_jax(arch):
    cfg = TCFG.get_config(arch)
    jspecs = _jax_specs(JCFG.get_config(arch))
    tspecs = TC.tree_paths(param_specs(cfg))
    assert tspecs.keys() == jspecs.keys()
    for path, s in tspecs.items():
        j = jspecs[path]
        assert (s.shape, s.logical, s.init, s.scale) == (j.shape, j.logical, j.init, j.scale), path
    logical = TC.tree_paths(logical_specs(param_specs(cfg)))
    assert logical == {p: s.logical for p, s in jspecs.items()}
    meta = abstract_params(param_specs(cfg))
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in TC.tree_leaves(meta))
    n = cfg.param_count(meta)
    assert n == cfg.param_count(param_specs(cfg)) == sum(
        int(np.prod(s.shape)) for s in jspecs.values())
    if arch in FULL_PARAMS:
        assert n == FULL_PARAMS[arch]


# the full-size parameter counts (the float32 bytes are four times these)
FULL_PARAMS = {
    "granite_3_2b": 2_642_577_408,
    "deepseek_moe_16b": 16_879_568_896,
    "mixtral_8x7b": 46_709_084_160,
    "rwkv6_7b": 7_534_546_944,
    "recurrentgemma_2b": 3_549_841_920,
}


def test_hybrid_specs_split_superblocks_and_tail():
    specs = param_specs(TCFG.get_config("recurrentgemma_2b"))
    assert set(specs) == {"embed", "unembed", "out_norm", "superblocks", "tail"}
    assert specs["superblocks"]["rec1"]["temporal"]["gate_a"].shape == (8, 2560, 2560)
    assert specs["superblocks"]["attn"]["temporal"]["wk"].shape == (8, 2560, 1, 256)
    assert specs["tail"]["temporal"]["w_out"].shape == (2, 2560, 2560)
    even = param_specs(dataclasses.replace(TCFG.get_reduced("recurrentgemma_2b"), n_layers=6))
    assert "tail" not in even


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_32b", "deepseek_moe_16b",
                                  "rwkv6_7b", "recurrentgemma_2b"])
def test_init_params_std_follows_the_jax_rule(arch):
    # fan_in = shape[0]: the layer count for the stacked layer weights (the
    # superblock count for the hybrid's: one here)
    cfg = dataclasses.replace(TCFG.get_reduced(arch), n_layers=3)
    specs = param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    for path, s in TC.tree_paths(specs).items():
        t = TC.tree_paths(params)[path]
        assert t.shape == s.shape and t.dtype == torch.float32
        if s.init in ("ones", "zeros"):
            assert torch.equal(t, torch.full(s.shape, float(s.init == "ones")))
            continue
        fan_in = s.shape[0] if len(s.shape) > 1 else s.shape[-1]
        want = s.scale / np.sqrt(fan_in)
        got = float(t.double().std())
        # the sample std of N normals is within 5 / sqrt(2N) of sigma
        assert abs(got / want - 1) < 5 / np.sqrt(2 * t.numel()), path
    if arch == "granite_3_2b":
        assert abs(float(params["layers"]["attn"]["wq"].std()) - 3 ** -0.5) < 0.02
    # the same seed, the same draws
    again = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(TC.tree_leaves(params), TC.tree_leaves(again)))


def _jax_tree(cfg):
    return jax.tree_util.tree_map(
        np.asarray, JC.init_params(JL.param_specs(cfg), jax.random.PRNGKey(0),
                                   dtype=np.float32))


def test_lm_params_from_numpy_copies_and_checks():
    cfg = TCFG.get_reduced("qwen3_32b")
    tree = _jax_tree(cfg)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    for path, a in TC.tree_paths(tree).items():
        t = TC.tree_paths(params)[path]
        assert np.array_equal(t.numpy(), a)
        assert not np.shares_memory(t.numpy(), a)
    wide = lm_params_from_numpy(cfg, tree, device="cpu", dtype=torch.float64)
    assert all(t.dtype == torch.float64 for t in TC.tree_leaves(wide))

    missing = dict(tree, layers=dict(tree["layers"]))
    del missing["layers"]["ln2"]
    with pytest.raises(ValueError, match="missing.*layers/ln2"):
        lm_params_from_numpy(cfg, missing, device="cpu")
    extra = dict(tree, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra.*bias"):
        lm_params_from_numpy(cfg, extra, device="cpu")
    bad = dict(tree, out_norm=np.zeros(cfg.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="misshaped.*out_norm"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    # another config's tree (qk_norm leaves where the port expects none)
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_numpy(TCFG.get_reduced("granite_3_2b"),
                             _jax_tree(JCFG.get_reduced("qwen3_32b")), device="cpu")


@pytest.mark.parametrize("arch", LATER)
def test_unported_family_raises(arch):
    with pytest.raises(NotImplementedError, match="comes with"):
        TCFG.get_config(arch)
    with pytest.raises(NotImplementedError, match="comes with"):
        TCFG.get_reduced(arch)
    # a config of that family built by hand is refused by the model code too
    jcfg = JCFG.get_reduced(arch)
    cfg = ModelConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "moe"})
    with pytest.raises(NotImplementedError, match="comes with"):
        param_specs(cfg)


def test_unknown_arch_and_family():
    with pytest.raises(ModuleNotFoundError):
        TCFG.get_config("no_such_arch")
    cfg = dataclasses.replace(TCFG.get_reduced("granite_3_2b"), family="nope")
    with pytest.raises(ValueError, match="unknown family"):
        param_specs(cfg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_params_from_numpy_carries_each_family(arch):
    cfg = TCFG.get_reduced(arch)
    tree = _jax_tree(JCFG.get_reduced(arch))
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    got, want = TC.tree_paths(params), TC.tree_paths(tree)
    assert got.keys() == want.keys() == TC.tree_paths(param_specs(cfg)).keys()
    for path, a in want.items():
        assert np.array_equal(got[path].numpy(), a) and got[path].dtype == torch.float32, path
    with pytest.raises(ValueError, match="missing"):  # another family's tree
        lm_params_from_numpy(dataclasses.replace(cfg, family="dense"), tree, device="cpu")


@pytest.mark.parametrize("arch", PORTED)
def test_make_train_batch_tokens_equal_jax(arch):
    from repro.launch.inputs import make_train_batch, token_split

    cfg = TCFG.get_reduced(arch)
    for seed in (0, 3):
        j = make_train_batch(cfg, batch=3, seq_len=40, seed=seed)
        t = TI.make_train_batch(cfg, batch=3, seq_len=40, seed=seed, device="cpu")
        assert t.keys() == j.keys()
        for k in j:
            assert np.array_equal(t[k].numpy(), np.asarray(j[k]))
    assert TI.token_split(cfg, 64) == token_split(cfg, 64)
