"""The port's mesh paths against the reference's, on gloo ranks of the CPU.

Each case runs in a subprocess (``tests/_torch_mesh_cases.py``) of 8
ranks, one thread each, that join a gloo group through a ``file://``
store under the test's temporary directory; the reference's own mesh
runs take 8 virtual XLA devices in a subprocess of their own, as
``tests/test_distributed.py`` does.  Each subprocess has a 420 s timeout
and each case takes well under a minute.  The reference's parameters and
data are carried across as numpy; every config is f32.

Bounds: ``apply_ep`` within 1e-4 of the reference's ``apply_local``
where nothing drops (capacity 8.0; the reference's own bound), within
1e-5 of the reference's ``apply_ep`` where rows drop (capacity 1.0:
the same rows dropped, the combine's f32 sums in another order), its
gradients within 1e-4 x max|g| of ``jax.grad`` of the reference's
``apply_ep``; ``apply_sharded`` within 1e-4 of the reference's
``apply_local``; a sharded loss within 1e-5 of the unsharded one
(relative: f32 sums over shards); a train step on a mesh within 1e-5
x each leaf's largest magnitude of the same step unsharded (dense) or
of the reference's step on the same mesh (MoE); a checkpoint restored
onto other meshes bit-equal.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CASES = Path(__file__).resolve().parent / "_torch_mesh_cases.py"
TIMEOUT = 420
WORLD = 8

MOE_CFG = dict(d_model=32, d_expert=16, num_experts=8, top_k=2,
               dtype="float32")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env.update(extra)
    return env


def run_port(inp: dict, workdir: Path) -> dict:
    """The port's case ``inp`` on 8 gloo ranks; rank 0's results."""
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    r = subprocess.run([sys.executable, str(CASES), str(WORLD), str(workdir)],
                       env=_env(), capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + "\n" + r.stderr[-4000:]
    with open(workdir / "out.pkl", "rb") as f:
        return pickle.load(f)


def run_reference(script: str, inp: dict, workdir: Path) -> dict:
    """``script`` under 8 virtual XLA devices, with ``inp`` as ``INP``; it
    leaves its results in ``OUT``."""
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "ref_in.pkl", "wb") as f:
        pickle.dump(inp, f)
    code = (f"import pickle\nINP = pickle.load(open({str(workdir / 'ref_in.pkl')!r}, 'rb'))\n"
            + textwrap.dedent(script)
            + f"\npickle.dump(OUT, open({str(workdir / 'ref_out.pkl')!r}, 'wb'))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=TIMEOUT, env=_env(
                           XLA_FLAGS="--xla_force_host_platform_device_count=8",
                           JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout[-2000:] + "\n" + r.stderr[-4000:]
    with open(workdir / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _close_rel(got, want, rtol, floor=0.0):
    """Each leaf within ``rtol`` x its largest |want| (+ ``floor``)."""
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= rtol * np.abs(b).max() + floor, (err, np.abs(b).max())


# -- the MoE layer: apply_ep on (2, 2, 2), apply_sharded on (2, 4) ----------

REF_MOE = """
import jax, jax.numpy as jnp, numpy as np, dataclasses
from repro.models import moe
from repro.launch import mesh as mesh_mod
p = jax.tree.map(jnp.asarray, INP["params"])
x = jnp.asarray(INP["x"]); cot = jnp.asarray(INP["cot"])
OUT = {}
for path, shape, axes, data_axes in (
        ("ep", (2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
        ("sharded", (2, 4), ("data", "model"), ("data",))):
    mesh = mesh_mod.compat_make_mesh(shape, axes)
    for cf in INP["capacity_factors"]:
        cfg = dataclasses.replace(moe.MoEConfig(**INP["cfg"]),
                                  capacity_factor=cf)
        def apply(p, x):
            if path == "ep":
                return moe.apply_ep(p, x, cfg, mesh, data_axes=data_axes)
            return moe.apply_sharded(p, x, cfg, mesh, data_axes=data_axes)
        with mesh:
            out, aux, disp = jax.jit(apply)(p, x)
            g = jax.jit(jax.grad(
                lambda p, x: (apply(p, x)[0] * cot).sum() + apply(p, x)[1],
                argnums=(0, 1)))(p, x)
        local, _, _ = moe.apply_local(p, x.reshape(-1, x.shape[-1]), cfg)
        OUT[(path, cf)] = {
            "out": np.asarray(out), "aux": np.asarray(aux),
            "disp": np.asarray(disp), "local": np.asarray(local),
            "grads": jax.tree.map(np.asarray, g[0]),
            "grad_x": np.asarray(g[1])}
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The port's ``apply_ep`` and ``apply_sharded`` and the reference's,
    on the reference's layer at capacity 8.0 and 1.0."""
    import jax
    from repro.models import moe as ref_moe
    cfg = ref_moe.MoEConfig(**MOE_CFG)
    p = jax.tree.map(np.asarray, ref_moe.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    inp = {"case": "moe", "cfg": MOE_CFG, "params": p,
           "x": rng.standard_normal((4, 8, 32)).astype(np.float32),
           "cot": rng.standard_normal((4, 8, 32)).astype(np.float32),
           "capacity_factors": [8.0, 1.0]}
    tmp = tmp_path_factory.mktemp("moe")
    ref = run_reference(REF_MOE, inp, tmp / "ref")
    ep = run_port(dict(inp, path="ep", mesh=(2, 2, 2),
                       axes=("pod", "data", "model"),
                       data_axes=("pod", "data")), tmp / "ep")
    sharded = run_port(dict(inp, path="sharded", mesh=(2, 4),
                            axes=("data", "model"), data_axes=("data",)),
                       tmp / "sharded")
    return ref, ep, sharded


def test_apply_ep_matches_reference_local_where_nothing_drops(moe_runs):
    ref, ep, _ = moe_runs
    got = ep[8.0]["out"].reshape(-1, 32)
    assert np.abs(got - ref[("ep", 8.0)]["local"]).max() < 1e-4


def test_apply_ep_matches_reference_apply_ep_where_rows_drop(moe_runs):
    ref, ep, _ = moe_runs
    want = ref[("ep", 1.0)]
    # capacity 1.0 drops rows: the EP result is not apply_local's
    assert np.abs(want["out"].reshape(-1, 32) - want["local"]).max() > 1e-2
    assert np.abs(ep[1.0]["out"] - want["out"]).max() < 1e-5
    assert abs(float(ep[1.0]["aux"]) - float(want["aux"])) < 1e-5
    np.testing.assert_array_equal(ep[1.0]["disp"], want["disp"])


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_apply_ep_gradients_match_jax_grad(moe_runs, cf):
    ref, ep, _ = moe_runs
    want = ref[("ep", cf)]
    for leaf in _leaves(ep[cf]["grads"]) + [ep[cf]["grad_x"]]:
        assert np.isfinite(leaf).all()
    _close_rel(ep[cf]["grads"], want["grads"], 1e-4)
    _close_rel(ep[cf]["grad_x"], want["grad_x"], 1e-4)


def test_apply_sharded_matches_reference_local(moe_runs):
    ref, _, sharded = moe_runs
    got = sharded[8.0]["out"].reshape(-1, 32)
    assert np.abs(got - ref[("sharded", 8.0)]["local"]).max() < 1e-4
    assert np.abs(sharded[1.0]["out"]
                  - ref[("sharded", 1.0)]["out"]).max() < 1e-5


def test_apply_sharded_gradients_match_jax_grad(moe_runs):
    ref, _, sharded = moe_runs
    for cf in (8.0, 1.0):
        _close_rel(sharded[cf]["grads"], ref[("sharded", cf)]["grads"], 1e-4)
        _close_rel(sharded[cf]["grad_x"], ref[("sharded", cf)]["grad_x"],
                   1e-4)


# -- the model on a mesh: the loss, a train step, checkpoints ---------------

def _ref_lm(arch: str, seed: int = 0):
    """The reference's reduced model, its parameters as numpy and a batch
    of 8 x 32 tokens made with numpy."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models.registry import build_model as ref_build_model
    cfg = ref_get_config(arch).reduced()
    model = ref_build_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    return cfg, model, params, {"tokens": tokens, "labels": tokens}


def _to_reference(tree, arch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    return convert.lm_tree_to_reference(tree, get_config(arch).reduced(),
                                        lambda a: a, np.stack)


REF_MESH_LOSS = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.registry import build_model
from repro.parallel import ctx as pctx, sharding as shd
from repro.launch import mesh as mesh_mod
cfg = get_config(INP["arch"]).reduced()
model = build_model(cfg)
params = jax.tree.map(jnp.asarray, INP["params"])
batch = {k: jnp.asarray(v) for k, v in INP["batch"].items()}
mesh = mesh_mod.compat_make_mesh(tuple(INP["mesh"]), ("data", "model"))
params_s = jax.device_put(params, shd.param_shardings(params, cfg, mesh))
batch_s = jax.device_put(batch, jax.tree.map(
    lambda x: NamedSharding(mesh, P(("data",))), batch))
with pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model"):
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b), has_aux=True))(params_s, batch_s)
OUT = {"loss": np.asarray(loss), "xent": np.asarray(m["xent"]),
       "grads": jax.tree.map(np.asarray, g)}
"""


@pytest.mark.parametrize("arch", ["qwen2-72b", "granite-moe-1b-a400m"])
def test_sharded_loss_matches_unsharded_and_reference(arch, tmp_path):
    """qwen2-72b and granite-moe-1b-a400m (through ``apply_sharded``),
    reduced, 8 x 32 tokens on a (2, 4) mesh: the loss within 1e-5 of the
    unsharded one (granite's xent: its aux is each data shard's, as the
    reference's is on a mesh), and the loss and each gradient leaf
    within 1e-5 and 1e-4 x max|g| of the reference's on the same mesh."""
    import jax
    cfg, ref_model, params, batch = _ref_lm(arch)
    ref_loss, _ = jax.jit(lambda p, b: ref_model.loss(p, b))(params, batch)
    inp = {"case": "loss", "arch": arch, "params": params, "batch": batch,
           "mesh": (2, 4), "axes": ("data", "model"),
           "data_axes": ("data",)}
    got = run_port(inp, tmp_path / "port")
    ref = run_reference(REF_MESH_LOSS, inp, tmp_path / "ref")
    rel = dict(rtol=1e-5)
    np.testing.assert_allclose(got["mesh_xent"], got["xent"], **rel)
    np.testing.assert_allclose(got["loss"], float(ref_loss), **rel)
    if not cfg.is_moe:
        np.testing.assert_allclose(got["mesh_loss"], got["loss"], **rel)
    np.testing.assert_allclose(got["mesh_loss"], ref["loss"], **rel)
    np.testing.assert_allclose(got["mesh_xent"], ref["xent"], **rel)
    _close_rel(_to_reference(got["mesh_grads"], arch), ref["grads"], 1e-4,
               1e-7)


REF_MESH_STEP = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.registry import build_model
from repro.optim import adamw
from repro.parallel import ctx as pctx, sharding as shd
from repro.launch import mesh as mesh_mod
from repro.train import step as train_mod
cfg = get_config(INP["arch"]).reduced()
model = build_model(cfg)
params = jax.tree.map(jnp.asarray, INP["params"])
batch = {k: jnp.asarray(v) for k, v in INP["batch"].items()}
mesh = mesh_mod.compat_make_mesh(tuple(INP["mesh"]), ("data", "model"))
state = {"params": params, "opt": adamw.init(params),
         "step": jnp.zeros((), jnp.int32)}
pspecs = shd.param_pspecs(params, cfg)
sspecs = {"params": pspecs, "opt": shd.opt_state_pspecs(None, pspecs),
          "step": P()}
state = jax.device_put(state, jax.tree.map(
    lambda s: NamedSharding(mesh, s), sspecs,
    is_leaf=lambda x: isinstance(x, P)))
batch = jax.device_put(batch, jax.tree.map(
    lambda x: NamedSharding(mesh, P(("data",))), batch))
with pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model"):
    step = train_mod.make_train_step(
        model, train_mod.TrainConfig(accum_steps=INP["accum"],
                                     constrain_grad_sharding=True),
        adamw.AdamWConfig(**INP["ocfg"]))
    new, metrics = jax.jit(step)(state, batch)
OUT = {"params": jax.tree.map(np.asarray, new["params"]),
       "opt": jax.tree.map(np.asarray, new["opt"]),
       "metrics": {k: np.asarray(v) for k, v in metrics.items()}}
"""


def _step_inp(arch, mesh):
    _, _, params, batch = _ref_lm(arch)
    return {"case": "train_step", "arch": arch, "params": params,
            "batch": batch, "accum": 2,
            "ocfg": {"lr": 1e-3, "warmup_steps": 1, "eps": 1e-4},
            "mesh": mesh,
            "axes": ("data", "model"), "data_axes": ("data",)}


def _close_step(params, opt, metrics, want_params, want_opt, want_metrics):
    """Each leaf of the new parameters and AdamW state within 1e-5 x its
    largest magnitude, and the metrics within rtol 1e-5.  The steps take
    AdamW's eps as 1e-4: with the default 1e-8 the first update, lr x g
    / (|g| + eps), turns the f32 noise of a gradient element near 1e-8
    (a sum over shards in another order) into a share of lr itself, and
    the comparison would measure that conditioning, not the step."""
    _close_rel(params, want_params, 1e-5)
    _close_rel(opt, want_opt, 1e-5)
    for k in ("xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-5)


def test_train_step_on_a_mesh_matches_unsharded():
    """command-r-plus-104b reduced on a (4, 2) mesh, 2 microbatches of
    4, ``constrain_grad_sharding``: the step against the same step
    unsharded, and every leaf of the new state keeps its placements.
    (A dense model without QKV biases: a key bias's true gradient is 0,
    and AdamW's first update of its rounding noise is noise of the
    update's own size.)"""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        got = run_port(_step_inp("command-r-plus-104b", (4, 2)), Path(tmp))
    assert got["placements_kept"] and got["n_opt_dtensors"] > 0
    _close_step(got["mesh_params"], got["mesh_opt"], got["mesh_metrics"],
                got["params"], got["opt"], got["metrics"])


def test_moe_train_step_on_a_mesh_matches_reference(tmp_path):
    """granite-moe-1b-a400m reduced on a (4, 2) mesh, 2 microbatches of
    4, ``constrain_grad_sharding``: the step against the reference's
    step on the same mesh.  Not against the unsharded step: on a mesh
    each data shard's aux loss is its own tokens' (the reference's
    ``pmean`` of per-shard losses), so aux and the router's gradient
    differ from the unsharded step's by design."""
    inp = _step_inp("granite-moe-1b-a400m", (4, 2))
    got = run_port(inp, tmp_path / "port")
    ref = run_reference(REF_MESH_STEP, inp, tmp_path / "ref")
    arch = inp["arch"]
    assert got["placements_kept"] and got["n_opt_dtensors"] > 0
    assert abs(float(got["mesh_metrics"]["aux"])
               - float(got["metrics"]["aux"])) > 1e-3
    np.testing.assert_allclose(got["mesh_metrics"]["xent"],
                               got["metrics"]["xent"], rtol=1e-5)
    opt = dict(got["mesh_opt"])
    want_opt = dict(ref["opt"])
    count, want_count = opt.pop("count"), want_opt.pop("count")
    assert int(count) == int(want_count) == 1
    _close_step(_to_reference(got["mesh_params"], arch),
                {k: _to_reference(v, arch) for k, v in opt.items()},
                got["mesh_metrics"], ref["params"], want_opt,
                ref["metrics"])


ZOO = sorted(["command-r-plus-104b", "gemma2-27b", "granite-moe-1b-a400m",
              "llama-3.2-vision-11b", "qwen1.5-110b", "qwen2-72b",
              "qwen3-moe-235b-a22b", "rwkv6-7b", "whisper-small",
              "zamba2-1.2b"])
# qwen3-moe with its 128 experts cut to 64, the fewest that take the EP
# path (MoEConfig.use_ep), where the reduced config's 8 take apply_sharded
EP_VARIANT = ("qwen3-moe-235b-a22b/ep", "qwen3-moe-235b-a22b",
              {"num_experts": 64})


def _zoo_model(name, arch, changes):
    import dataclasses
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models.registry import build_model as ref_build_model
    from test_torch_families import _open_gates
    from test_torch_ssm import _perturb
    cfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    params = jax.tree.map(np.asarray, ref_build_model(cfg).init(
        jax.random.PRNGKey(0)))
    if cfg.family != "audio":
        _perturb(params, cfg)
        _open_gates(params, cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    stubs = {"audio": ("frames", cfg.encoder_frames),
             "vlm": ("image_embeds", cfg.image_tokens)}
    if cfg.family in stubs:
        key, n = stubs[cfg.family]
        batch[key] = (rng.standard_normal((8, n, cfg.d_model)) * 0.02
                      ).astype(np.float32)
    return {"name": name, "arch": arch, "changes": changes,
            "params": params, "batch": batch}


@pytest.fixture(scope="module")
def zoo_losses(tmp_path_factory):
    """Every model of the zoo, reduced, 8 x 32 tokens: its loss
    unsharded and on a (2, 4) mesh, in one run of 8 ranks."""
    models = [_zoo_model(a, a, {}) for a in ZOO] + [_zoo_model(*EP_VARIANT)]
    return run_port({"case": "zoo", "models": models, "mesh": (2, 4),
                     "axes": ("data", "model"), "data_axes": ("data",)},
                    tmp_path_factory.mktemp("zoo"))


@pytest.mark.parametrize("name", ZOO + [EP_VARIANT[0]])
def test_every_model_runs_on_a_mesh(zoo_losses, name):
    """The xent on the mesh within 1e-5 of the unsharded one (and the
    total loss too where there is no MoE aux loss, which on a mesh is
    each data shard's)."""
    got = zoo_losses[name]
    np.testing.assert_allclose(got["mesh_xent"], got["xent"], rtol=1e-5)
    if "moe" not in name:
        np.testing.assert_allclose(got["mesh_loss"], got["loss"], rtol=1e-5)


def test_checkpoint_restores_across_meshes(tmp_path):
    """A train state (parameters and AdamW state) saved from a (2, 4)
    mesh restores onto a (4, 2) and a (1, 8) mesh bit-equal, each leaf
    on its placements."""
    cfg, _, params, batch = _ref_lm("granite-moe-1b-a400m")
    got = run_port({"case": "checkpoint", "arch": "granite-moe-1b-a400m",
                    "params": params, "batch": batch}, tmp_path)
    saved = _leaves(got["saved"])
    for shape in ((4, 2), (1, 8)):
        assert got[shape]["step"] == 7 and got[shape]["placements"]
        restored = _leaves(got[shape]["state"])
        assert len(restored) == len(saved)
        for a, b in zip(restored, saved):
            np.testing.assert_array_equal(a, b)


# -- decode on a mesh ---------------------------------------------------------


def _no_drop(arch, changes=None):
    """The config's changes with a capacity factor of E for an MoE model:
    nothing drops, on the mesh or off it (each data shard reckons its own
    capacity from its own tokens)."""
    import dataclasses
    from repro.configs import get_config as ref_get_config
    changes = dict(changes or {})
    cfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    if cfg.is_moe:
        changes["moe_capacity_factor"] = float(cfg.num_experts)
    return changes


@pytest.fixture(scope="module")
def zoo_decode(tmp_path_factory):
    """Every model of the zoo, reduced, f32: a prefill of 4 x 4 tokens,
    then 4 decode steps from an empty 8-slot cache, unsharded and on a
    (2, 4) mesh with the cache laid out by ``cache_pspecs`` (the KV
    sequence over the model axis), in one run of 8 ranks."""
    models = [_zoo_model(a, a, _no_drop(a)) for a in ZOO]
    name, arch, changes = EP_VARIANT
    models.append(_zoo_model(name, arch, _no_drop(arch, changes)))
    return run_port({"case": "decode", "models": models, "mesh": (2, 4),
                     "axes": ("data", "model"), "data_axes": ("data",)},
                    tmp_path_factory.mktemp("decode"))


@pytest.mark.parametrize("name", ZOO + [EP_VARIANT[0]])
def test_decode_on_a_mesh_matches_unsharded(zoo_decode, name):
    """The prefill's logits and each decode step's on the mesh within
    1e-5 x their largest magnitude of the unsharded ones: the KV write
    lands in the shard that holds the slot, in place."""
    got = zoo_decode[name]
    assert set(got["got"]) == {"prefill", "step0", "step1", "step2",
                               "step3"}
    for key, want in got["want"].items():
        _close_rel(got["got"][key], want, 1e-5)


REF_MESH_DECODE = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch import mesh as mesh_mod
from repro.models.registry import build_model
from repro.parallel import ctx as pctx, sharding as shd
cfg = dataclasses.replace(get_config(INP["arch"]).reduced(),
                          **INP["changes"])
model = build_model(cfg)
params = jax.tree.map(jnp.asarray, INP["params"])
toks = jnp.asarray(INP["batch"]["tokens"][:4, :4])
mesh = mesh_mod.compat_make_mesh((2, 4), ("data", "model"))
params = jax.device_put(params, shd.param_shardings(params, cfg, mesh))
cache = model.init_cache(params, 4, 8)
cache = jax.device_put(cache, jax.tree.map(
    lambda s: NamedSharding(mesh, s),
    shd.cache_pspecs(cache, cfg, data_axes=("data",), seq_axis="model"),
    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
OUT = {}
with pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model"):
    step = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos=pos))
    for i in range(4):
        logits, cache = step(params, toks[:, i:i + 1], cache, jnp.int32(i))
        OUT[f"step{i}"] = np.asarray(logits, np.float32)
"""


@pytest.mark.parametrize("arch", ["qwen2-72b", "granite-moe-1b-a400m"])
def test_decode_on_a_mesh_matches_the_reference_on_its_mesh(
        zoo_decode, arch, tmp_path):
    """The port's decode steps on the (2, 4) mesh against the reference's
    decode under its own (2, 4) mesh of 8 virtual XLA devices, from the
    same parameters and tokens, within 1e-5 x the largest logit."""
    ref = run_reference(REF_MESH_DECODE,
                        _zoo_model(arch, arch, _no_drop(arch)), tmp_path)
    got = zoo_decode[arch]["got"]
    for key, want in ref.items():
        _close_rel(got[key], want, 1e-5)


# AdamW's first update is lr x g / (|g| + eps): where |g| is well above
# eps it is lr x sign(g) whatever the rounding of g; where |g| is near eps
# the rounding of g moves it by a share of lr itself
CONDITIONED_G = 1e-6       # |g| below it: eps moves the update by > 1%
CONDITIONED_BOUND = 0.05   # x the largest |change|, measured 0.0304 max


def test_train_step_on_a_mesh_at_the_default_eps():
    """command-r-plus-104b reduced on a (4, 2) mesh, as
    ``test_train_step_on_a_mesh_matches_unsharded`` but at AdamW's default
    eps 1e-8.  Each leaf's change under the step is within 1e-4 x the
    largest |change| of the unsharded step's on every element whose
    unsharded gradient is at least ``CONDITIONED_G``.  Below it, where
    eps conditions the update, the f32 rounding of a sum over shards
    moves the change by up to 3.04% of the largest (1 to 16 elements a
    leaf, gradients of 4e-10 to 3.3e-7, measured on the CPU): those are
    held within ``CONDITIONED_BOUND`` x the largest |change|."""
    import tempfile
    inp = _step_inp("command-r-plus-104b", (4, 2))
    inp["ocfg"] = {"lr": 1e-3, "warmup_steps": 1}
    with tempfile.TemporaryDirectory() as tmp:
        got = run_port(inp, Path(tmp))
    assert got["placements_kept"]
    grads = [np.abs(np.asarray(m, np.float64)) / 0.1   # m = (1 - b1) g
             for m in _leaves(got["opt"]["m"])]
    before = _leaves(got["before"])
    after, want = _leaves(got["mesh_params"]), _leaves(got["params"])
    n_conditioned = 0
    for p0, p1, w, g in zip(before, after, want, grads, strict=True):
        p0, p1, w = (np.asarray(x, np.float64) for x in (p0, p1, w))
        err = np.abs((p1 - p0) - (w - p0))
        top = np.abs(w - p0).max()
        plain = g >= CONDITIONED_G
        assert (err[plain] <= 1e-4 * top).all(), (err[plain].max(), top)
        assert (err <= CONDITIONED_BOUND * top).all(), (err.max(), top)
        n_conditioned += int((err[~plain] > 1e-4 * top).sum())
    print(f"elements past 1e-4 x the update where |g| < {CONDITIONED_G}: "
          f"{n_conditioned}")
