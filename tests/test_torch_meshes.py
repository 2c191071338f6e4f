"""The port's logical-sharding resolution against the JAX package's, leaf
by leaf: every parameter of every arch on both production meshes, every
decode-cache leaf through ``resolve_kv_logical`` at ``decode_32k``, the
activation-sharding rules, and the input shapes and logical specs of
every (arch × shape) cell. JAX's meshes are ``AbstractMesh``es, which
need no devices; the port's are ``make_production_mesh(devices="meta")``.
A JAX spec is compared as ``tuple(PartitionSpec)``."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.distributed import meshes as jm
from repro.distributed import sharding_ctx as jctx
from repro.launch import inputs as ji
from repro.models import logical_specs as jax_logical
from repro.models import param_specs as jax_param_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import meshes as tm
from repro_torch.distributed import sharding_ctx as tctx
from repro_torch.launch import inputs as ti
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import logical_specs, param_specs
from repro_torch.models.common import tree_paths

MESHES = {
    "pod": (((16, 16), ("data", "model")), False),
    "multi_pod": (((2, 16, 16), ("pod", "data", "model")), True),
}


def _meshes(which):
    (shape, axes), multi = MESHES[which]
    return AbstractMesh(shape, axes), make_production_mesh(multi_pod=multi, devices="meta")


def _jax_paths(tree, is_leaf=None):
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)
    return {tuple(k.key for k in p): v for p, v in leaves}


def _is_spec(x):
    return isinstance(x, tuple) and all(isinstance(e, str) or e is None for e in x)


def test_production_meshes():
    for which in MESHES:
        jmesh, mesh = _meshes(which)
        assert mesh.axis_names == jmesh.axis_names
        assert dict(mesh.shape) == dict(jmesh.shape)
        assert {str(d) for d in mesh.devices.ravel()} == {"meta"}
    local = make_local_mesh(model=4, data=2, devices="cpu")
    assert dict(local.shape) == {"data": 2, "model": 4}


@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, which):
    jmesh, mesh = _meshes(which)
    jspecs = jax_param_specs(jax_config(arch))
    jlog = _jax_paths(jax_logical(jspecs), is_leaf=_is_spec)
    jleaves = _jax_paths(jspecs, is_leaf=lambda x: hasattr(x, "logical"))
    jshape = {k: v.shape for k, v in jleaves.items()}
    specs = param_specs(get_config(arch))
    log = tree_paths(logical_specs(specs))
    assert log.keys() == jlog.keys()
    for path, logical in log.items():
        assert logical == jlog[path], path
        shape = tuple(tree_paths(specs)[path].shape)
        assert shape == tuple(jshape[path]), path
        want = tuple(jm.resolve_spec(jmesh, jlog[path], shape))
        assert tm.resolve_spec(mesh, logical, shape) == want, (path, want)
    # the spec trees the dry run builds, and what a chip holds of them
    shards = tm.shardings_for(mesh, logical_specs(specs), specs)
    assert tree_paths(shards).keys() == log.keys()


@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(arch, which):
    jmesh, mesh = _meshes(which)
    shape = SHAPES["decode_32k"]
    jcache, _ = ji.decode_state_shapes(jax_config(arch), JAX_SHAPES["decode_32k"])
    cache, _ = ti.decode_state_shapes(get_config(arch), shape)
    jlog = _jax_paths(ji.cache_logical(jax_config(arch)), is_leaf=_is_spec)
    log = tree_paths(ti.cache_logical(get_config(arch)))
    assert log == jlog
    jshapes = _jax_paths(jcache)
    for path, t in tree_paths(cache).items():
        shp = tuple(t.shape)
        want = tuple(ji.resolve_kv_logical(jmesh, jlog[path], shp))
        assert ti.resolve_kv_logical(mesh, log[path], shp) == want, path
        assert shp == tuple(jshapes[path].shape), path


@pytest.mark.parametrize("which", list(MESHES))
def test_resolve_kv_logical_tp2_equals_jax(which):
    """The 'tp2' branch: 'model' on the kv-head dim when it divides, else
    on head_dim."""
    jmesh, mesh = _meshes(which)
    logical = (None, "batch", None, "tp", "tp2")
    for shape in [(4, 128, 64, 16, 128), (4, 128, 64, 8, 128), (4, 128, 64, 8, 6),
                  (4, 3, 64, 32, 64)]:
        want = tuple(ji.resolve_kv_logical(jmesh, logical, shape))
        assert ti.resolve_kv_logical(mesh, logical, shape) == want, shape


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("which", list(MESHES))
def test_activation_rules_equal_jax(which, seq_sharded):
    jmesh, mesh = _meshes(which)
    with jctx.activation_sharding(jmesh, seq_sharded=seq_sharded):
        jrules = {k: tuple(v) for k, v in jctx._CTX.get().items()}
    with tctx.activation_sharding(mesh, seq_sharded=seq_sharded):
        rules = tctx._CTX.get()
        x = torch.empty((4, 8, 16), device="meta")
        assert tctx.constrain(x, "residual") is x
    assert tctx._CTX.get() is None
    assert rules == jrules
    assert tm.activation_spec(mesh, seq_sharded=seq_sharded) == tuple(
        jm.activation_spec(jmesh, seq_sharded=seq_sharded))
    assert tm.batch_axes(mesh) == jm.batch_axes(jmesh)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_shapes_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    s, js = SHAPES[shape], JAX_SHAPES[shape]
    assert ti.train_batch_shapes(cfg, s) == ji.train_batch_shapes(jcfg, js)
    assert ti.batch_logical(cfg, s.kind) == ji.batch_logical(jcfg, js.kind)
    cache, tok = ti.decode_state_shapes(cfg, s)
    jcache, jtok = ji.decode_state_shapes(jcfg, js)
    assert tok == jtok
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tree_paths(cache).items()}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _jax_paths(jcache).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in tree_paths(cache).values())
    assert np.dtype(tok[1]) == np.int32
