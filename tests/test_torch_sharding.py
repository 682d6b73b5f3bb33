"""The port's placements against the reference's, at full size.

Every parameter, decode-cache and batch leaf of every config of the zoo
gets the reference's spec (``parallel/sharding.py``): the port's trees
are built on the meta device (no memory), the reference's with
``jax.eval_shape``, and the port's per-layer leaves are mapped onto the
reference's stacked ones through ``convert``'s path map, where a
stacked leaf's spec is the port's with a leading ``None``.  Then the
ports of ``tests/test_sharding_static.py`` (every leaf divides on both
production meshes, the largest leaf a device under 4e9 bytes), and the
production meshes and ``launch/specs.py`` under the ``fake`` process
group of 256 and 512 ranks, in a subprocess (the group is process-wide).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro.parallel import sharding as ref_shd
from repro_torch import convert, tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs
from repro_torch.models import layers
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import layer_plan
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P

SRC = Path(__file__).resolve().parents[1] / "src"
ALL = sorted(ARCHS)
MESH_SIZES = {"single": {"data": 16, "model": 16},
              "pod2": {"pod": 2, "data": 16, "model": 16}}
CACHE_B, CACHE_T = 4, 64


def _ref_leaves(tree_):
    return {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree_, is_leaf=lambda x: isinstance(x, RefP))}


def _stacked(specs_):
    """The spec of a stacked leaf from its layers' specs (all equal)."""
    assert all(s == specs_[0] for s in specs_), specs_
    return ("stacked", specs_[0])


def _as_reference(spec_tree, cfg):
    """The port's spec tree in the reference's layout; a stacked leaf is
    marked so."""
    if cfg.family == "audio":
        return convert.whisper_tree_to_reference(spec_tree, cfg, lambda s: s,
                                                 _stacked)
    return convert.lm_tree_to_reference(spec_tree, cfg, lambda s: s,
                                        _stacked)


def _same(port, ref) -> bool:
    """A port spec equals the reference's; a stacked one equals it
    without its leading ``None``."""
    ref = tuple(ref)
    if isinstance(port, tuple) and port[:1] == ("stacked",):
        if not ref:
            return tuple(port[1]) == ()
        return ref[0] is None and tuple(port[1]) == ref[1:]
    return tuple(port) == ref


def _compare(port_tree, ref_tree):
    port = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_leaves_with_path(
                port_tree, is_leaf=lambda x: isinstance(x, (P, tuple)))}
    ref = _ref_leaves(ref_tree)
    assert port.keys() == ref.keys()
    bad = {k: (port[k], ref[k]) for k in ref if not _same(port[k], ref[k])}
    assert not bad, bad
    return len(ref)


def _port_params(arch):
    cfg = get_config(arch)
    model = build_model(cfg, "meta")
    return cfg, model, model.init(layers.MetaGenerator())


def _ref_shapes(arch):
    cfg = ref_get_config(arch)
    model = ref_build_model(cfg)
    return cfg, model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ALL)
def test_param_pspecs_match_reference(arch):
    cfg, _, params = _port_params(arch)
    rcfg, _, shapes = _ref_shapes(arch)
    got = _as_reference(shd.param_pspecs(params, cfg), cfg)
    assert _compare(got, ref_shd.param_pspecs(shapes, rcfg)) > 5


def _port_cache_tree(cfg, cache):
    """The port's cache in the reference's layout: each group's
    sub-block ``i`` (zamba2's shared attention too) stacked over the
    groups, the tail a list; Whisper's per-layer dicts stacked."""
    lay = cache["layers"]
    if cfg.family == "audio":
        return {k: _stacked([c[k] for c in lay]) for k in lay[0]}
    plan = layer_plan(cfg)
    k = len(plan.group_kinds)
    groups = {f"sub{i}": {key: _stacked([lay[g * k + i][key]
                                          for g in range(plan.n_groups)])
                          for key in lay[i]}
              for i in range(k)}
    return {"groups": groups, "tail": lay[plan.n_groups * k:]}


@pytest.mark.parametrize("arch", ALL)
def test_cache_pspecs_match_reference(arch):
    cfg, model, params = _port_params(arch)
    rcfg, rmodel, shapes = _ref_shapes(arch)
    kw, rkw = {}, {}
    stubs = {"audio": ("frames", cfg.encoder_frames),
             "vlm": ("image_embeds", cfg.image_tokens)}
    if cfg.family in stubs:
        key, n = stubs[cfg.family]
        kw[key] = specs._meta((CACHE_B, n, cfg.d_model),
                              layers.torch_dtype(cfg.dtype))
        rkw[key] = jax.ShapeDtypeStruct((CACHE_B, n, cfg.d_model),
                                        jnp.dtype(cfg.dtype))
    cache = model.init_cache(params, CACHE_B, CACHE_T, **kw)
    rcache = jax.eval_shape(
        lambda p, **e: rmodel.init_cache(p, CACHE_B, CACHE_T, **e),
        shapes, **rkw)
    got = _port_cache_tree(cfg, shd.cache_pspecs(cache, cfg))
    want = ref_shd.cache_pspecs(rcache, rcfg)
    if cfg.family == "audio":
        assert _compare(got, want) == 4
    else:
        assert _compare(got, want) >= 2


@pytest.mark.parametrize("arch", ALL)
def test_batch_pspecs_match_reference(arch):
    cfg = get_config(arch)
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32),
             "image_embeds": np.zeros((8, 4, cfg.d_model), np.float32),
             "pos": np.zeros((), np.int32)}
    for axes in (("pod", "data"), ("data",), None):
        got = shd.batch_pspecs(batch, axes)
        want = ref_shd.batch_pspecs(batch, axes)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def _axis_size(axes, sizes):
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes.get(axes, 1)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


@pytest.mark.parametrize("mesh_name", ["single", "pod2"])
@pytest.mark.parametrize("arch", ALL)
def test_param_specs_divide(arch, mesh_name):
    sizes = MESH_SIZES[mesh_name]
    cfg, _, params = _port_params(arch)
    specs_ = shd.param_pspecs(params, cfg)
    bad = [(leaf.shape, spec) for leaf, spec in
           zip(tree.leaves(params), tree.leaves(specs_))
           for dim, axes in zip(leaf.shape, spec)
           if _axis_size(axes, sizes) > 1 and dim % _axis_size(axes, sizes)]
    assert not bad, bad[:10]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "command-r-plus-104b"])
def test_big_params_are_actually_sharded(arch):
    """The >=64-expert MoE EP-shards its experts and the huge dense
    weights are 2-D sharded: no leaf takes 4e9 bytes of a device."""
    sizes = MESH_SIZES["single"]
    cfg, _, params = _port_params(arch)
    worst = 0
    for leaf, spec in zip(tree.leaves(params),
                          tree.leaves(shd.param_pspecs(params, cfg))):
        shards = 1
        for axes in spec:
            shards *= _axis_size(axes, sizes)
        per_dev = leaf.numel() * leaf.element_size() / shards
        worst = max(worst, per_dev)
        assert per_dev < 4e9, (leaf.shape, spec, per_dev)
    assert worst > 0


def test_spec_entries_compare_as_the_reference_does():
    assert tuple(P(("pod", "data"), None, "model")) == \
        tuple(RefP(("pod", "data"), None, "model"))
    assert tuple(P()) == tuple(RefP())
    assert P("data") == P("data") and P("data") != P("model")


FAKE = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import Replicate, Shard
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
from repro_torch import tree
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as mesh_mod, specs
from repro_torch.models.registry import build_model
from repro_torch.parallel import sharding as shd
multi = WORLD == 512
mesh = mesh_mod.make_production_mesh(multi_pod=multi, device_type="cpu")
assert mesh.mesh_dim_names == (("pod", "data", "model") if multi
                               else ("data", "model"))
assert tuple(mesh.shape) == ((2, 16, 16) if multi else (16, 16))
assert mesh_mod.mesh_chips(mesh) == WORLD
axes = mesh_mod.data_axes_of(mesh)
assert axes == (("pod", "data") if multi else ("data",))
cfg = get_config("qwen3-moe-235b-a22b")
model = build_model(cfg, "meta")
params, psh = specs.param_specs(model, mesh)
state, ssh = specs.state_specs(model, mesh)
assert len(tree.leaves(state)) == 4 * len(tree.leaves(params)) + 2
for leaf, sh in zip(tree.leaves(params), tree.leaves(psh)):
    assert leaf.is_meta and len(sh.placements) == mesh.ndim
# an expert weight: experts over data, the hidden over model
w = params["layers"][0]["ffn"]["w_gate"]
sh = psh["layers"][0]["ffn"]["w_gate"]
assert tuple(w.shape) == (128, 4096, 1536)
want = (Shard(0), Shard(2)) if not multi else (Replicate(), Shard(0), Shard(2))
assert sh.placements == want, sh.placements
batch, bsh = specs.train_batch_specs(cfg, SHAPES["train_4k"], mesh)
assert tuple(batch["tokens"].shape) == (256, 4096)
assert bsh["tokens"].placements[:len(axes)] == (Shard(0),) * len(axes)
cache, csh, tok, tok_sh, pos_sh = specs.decode_specs(
    cfg, SHAPES["decode_32k"], model, mesh, params)
k = csh["layers"][0]["k"]
assert k.spec == shd.P(axes, None, "model", None), k.spec
assert pos_sh.placements == (Replicate(),) * mesh.ndim
long_cache, lsh, _, _, _ = specs.decode_specs(
    cfg, SHAPES["long_500k"], model, mesh, params)
assert tuple(lsh["layers"][0]["k"].spec)[0] is None   # batch 1: replicated
pre, presh = specs.prefill_specs(get_config("whisper-small"),
                                 SHAPES["prefill_32k"], mesh)
assert tuple(pre["frames"].shape) == (32, 1500, 768)
dist.destroy_process_group()
print("ok")
"""


@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_and_specs_under_the_fake_group(world):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", f"WORLD = {world}\n" + FAKE],
                       env=env, capture_output=True, text=True, timeout=420)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout[-2000:] + r.stderr[-4000:]
