"""The port's RWKV-6 and Mamba-2 layers, and the rwkv6-7b and zamba2-1.2b
models, against the reference's.

On the CPU in f32, where K8's launcher runs its plain version: the
reference's parameters, initialised by ``jax.random``, are carried across
as numpy (``convert.lm_params_from_numpy`` for the models), and inputs
are made with numpy from a seed.  The reference initialises some leaves
to constants (RWKV's bonus u, ``mix_base`` and ``mix_x`` zeros, the
channel-mix lerps 0.5; Mamba's ``a_log`` and ``dt_bias`` zeros,
``d_skip`` ones, ``conv_b`` zeros), under which a dropped bonus diagonal
or a slip in the head index would pass any comparison, so every
comparison here perturbs them (``_perturb``) in the numpy parameters both
packages receive: seeded normals, with the decays kept where the chunked
forms stay finite (RWKV's ``decay_base`` about -3, a_log about -0.5).

Bounds: 1e-5 (rtol and atol; atol scaled to max |ref| for the raw
WKV and SSD outputs) for a module, 1e-4 for a whole model's logits (the
bound of ``tests/test_torch_lm.py``), 2e-2 for decode against forward
(``tests/test_models_decode.py``), 2e-3 for chunked against scan
(``tests/test_sequence_models.py``); greedy tokens equal.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro.models.registry import build_model as ref_build_model
from repro.serve import step as ref_serve
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, mamba2, rwkv6, transformer
from repro_torch.models.registry import build_model
from repro_torch.serve import step as serve_mod

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
MODULE = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = 2e-2
CHUNKED_VS_SCAN = 2e-3
ARCHS = ("rwkv6-7b", "zamba2-1.2b")
T_GRID = (1, 37, 64, 130)

# small layers: 4 RWKV heads of 16; 8 Mamba heads of 8, state 8
RWKV_KW = dict(d_model=64, head_dim=16, decay_lora=8, mix_lora=4, d_ff=96,
               dtype="float32")
MAMBA_KW = dict(d_model=32, state_dim=8, head_dim=8, chunk=16,
                dtype="float32")


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def _normal(rng, a, loc, scale):
    return (loc + scale * rng.standard_normal(a.shape)).astype(a.dtype)


def _perturb_rwkv(mix: dict, rng) -> None:
    """Non-trivial values for the RWKV leaves ``init`` sets to constants,
    in place; ``decay_base`` about -3 (per-token decay about 0.95)."""
    mix["bonus"] = _normal(rng, mix["bonus"], 0.0, 0.5)
    mix["mix_base"] = _normal(rng, mix["mix_base"], 0.0, 0.3)
    mix["mix_x"] = _normal(rng, mix["mix_x"], 0.0, 0.3)
    mix["cm_mix_k"] = _normal(rng, mix["cm_mix_k"], 0.5, 0.3)
    mix["cm_mix_r"] = _normal(rng, mix["cm_mix_r"], 0.5, 0.3)
    mix["decay_base"] = _normal(rng, mix["decay_base"], -3.0, 0.5)


def _perturb_mamba(ssm: dict, rng) -> None:
    """The same for a Mamba layer: a per-head A = -exp(a_log), dt bias
    and skip, and a conv bias."""
    ssm["a_log"] = _normal(rng, ssm["a_log"], -0.5, 0.5)
    ssm["dt_bias"] = _normal(rng, ssm["dt_bias"], 0.0, 0.5)
    ssm["d_skip"] = _normal(rng, ssm["d_skip"], 1.0, 0.5)
    ssm["conv_b"] = _normal(rng, ssm["conv_b"], 0.0, 0.1)


def _perturb(rp_np: dict, cfg, seed: int = 11) -> None:
    """Perturbs every RWKV and Mamba layer of the numpy reference
    parameters ``rp_np`` (stacked groups and the tail), in place."""
    rng = np.random.default_rng(seed)
    plan = transformer.layer_plan(cfg)
    subs = [rp_np["groups"][f"sub{i}"] for i, kind
            in enumerate(plan.group_kinds) if kind != "shared_attn"]
    for sub in subs + list(rp_np.get("tail", ())):
        if "mix" in sub:
            _perturb_rwkv(sub["mix"], rng)
        if "ssm" in sub:
            _perturb_mamba(sub["ssm"], rng)


# -- RWKV-6 ------------------------------------------------------------------


def _rwkv(seed=0):
    """(reference params, port params, reference cfg, port cfg) of one
    perturbed RWKV-6 layer."""
    rcfg = ref_rwkv6.RWKVConfig(**RWKV_KW)
    p = jax.tree.map(np.asarray, ref_rwkv6.init(jax.random.PRNGKey(seed),
                                                rcfg))
    _perturb_rwkv(p, np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, p), _torch_tree(p), rcfg,
            rwkv6.RWKVConfig(**RWKV_KW))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rwkv_init_has_the_reference_layout():
    rcfg = ref_rwkv6.RWKVConfig(**RWKV_KW)
    want = ref_rwkv6.init(jax.random.PRNGKey(0), rcfg)
    got = rwkv6.init(torch.Generator().manual_seed(0),
                     rwkv6.RWKVConfig(**RWKV_KW))
    _same_layout(got, want)
    for name in ("mix_base", "mix_x", "bonus", "decay_base", "cm_mix_k",
                 "cm_mix_r"):
        np.testing.assert_array_equal(_np(got[name]), want[name])


def _same_layout(got, want):
    """Equal key paths, shapes and dtypes."""
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, str(t.dtype)[6:]), got))
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (k, a), (_, b) in zip(flat_got, flat_want):
        assert (a.shape, a.dtype.name) == (b.shape, b.dtype.name), k


@pytest.mark.parametrize("impl,t,chunk",
                         [("scan", t, 64) for t in T_GRID]
                         + [("chunked", t, c) for t in T_GRID
                            for c in (16, 64)])
def test_time_mix_matches(impl, t, chunk):
    """Both WKV routes at a ragged T, at a chunk boundary and with
    padding; the raw WKV too, its atol scaled to max |ref|."""
    rp, p, rcfg, cfg = _rwkv()
    x = _x((2, t, 64), t)
    want = jax.jit(ref_rwkv6.time_mix, static_argnums=(2, 3, 4))(
        rp, jnp.asarray(x), rcfg, impl, chunk)
    got = rwkv6.time_mix(p, _t(x), cfg, impl=impl, chunk=chunk)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), want, **MODULE)
    # the WKV alone, on seeded r, k, v and decays (4 heads of 16)
    rng = np.random.default_rng(t)
    r, k, v = (rng.standard_normal((2, t, 4, 16)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(-3.0 + 0.5 * rng.standard_normal((2, t, 4, 16))).astype(
        np.float32)
    u = np.asarray(rp["bonus"])
    ref_fn = jax.jit(ref_rwkv6._wkv_scan if impl == "scan" else
                     lambda *a: ref_rwkv6._wkv_chunked(*a, chunk=chunk))
    fn = (rwkv6._wkv_scan if impl == "scan" else
          lambda *a: rwkv6._wkv_chunked(*a, chunk=chunk))
    want = np.asarray(ref_fn(*map(jnp.asarray, (r, k, v, logw, u))))
    got = _np(fn(*map(_t, (r, k, v, logw, u))))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("t", [37, 130])
def test_wkv_chunked_equals_scan(t):
    """The port's two routes against each other (the reference's bound);
    the bonus diagonal included."""
    rp, p, rcfg, cfg = _rwkv(seed=1)
    x = _t(_x((2, t, 64), t))
    scan = rwkv6.time_mix(p, x, cfg, impl="scan")
    for chunk in (16, 64):
        chunked = rwkv6.time_mix(p, x, cfg, impl="chunked", chunk=chunk)
        assert float((chunked - scan).abs().max()) < CHUNKED_VS_SCAN


@pytest.mark.parametrize("t", [1, 37])
def test_channel_mix_matches(t):
    rp, p, _, _ = _rwkv(seed=2)
    x = _x((2, t, 64), t)
    last = _x((2, 64), t + 1)
    for lst in (None, last):
        want = ref_rwkv6.channel_mix(rp, jnp.asarray(x),
                                     None if lst is None else jnp.asarray(lst))
        got = rwkv6.channel_mix(p, _t(x), None if lst is None else _t(lst))
        np.testing.assert_allclose(_np(got), want, **MODULE)


def test_time_mix_decode_steps_match():
    """Eight one-token steps from a zero state against the reference's,
    the state (S and last) included, then against the prefill."""
    rp, p, rcfg, cfg = _rwkv(seed=3)
    x = _x((2, 8, 64), 3)
    rstate = {"s": jnp.zeros((2, 4, 16, 16), jnp.float32),
              "last": jnp.zeros((2, 64), jnp.float32)}
    state = {"s": torch.zeros(2, 4, 16, 16), "last": torch.zeros(2, 64)}
    outs = []
    for i in range(8):
        want, rstate = ref_rwkv6.time_mix_decode(
            rp, jnp.asarray(x[:, i:i + 1]), rstate, rcfg)
        got, state = rwkv6.time_mix_decode(p, _t(x[:, i:i + 1]), state, cfg)
        np.testing.assert_allclose(_np(got), want, **MODULE)
        np.testing.assert_allclose(_np(state["s"]), rstate["s"], **MODULE)
        np.testing.assert_array_equal(_np(state["last"]), rstate["last"])
        outs.append(got)
    fwd = rwkv6.time_mix(p, _t(x), cfg)
    assert float((torch.cat(outs, 1) - fwd).abs().max()) < DECODE_TOL


# -- Mamba-2 -----------------------------------------------------------------


def _mamba(seed=0):
    rcfg = ref_mamba2.Mamba2Config(**MAMBA_KW)
    p = jax.tree.map(np.asarray, ref_mamba2.init(jax.random.PRNGKey(seed),
                                                 rcfg))
    _perturb_mamba(p, np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, p), _torch_tree(p), rcfg,
            mamba2.Mamba2Config(**MAMBA_KW))


def test_mamba_init_has_the_reference_layout():
    rcfg = ref_mamba2.Mamba2Config(**MAMBA_KW)
    want = ref_mamba2.init(jax.random.PRNGKey(0), rcfg)
    got = mamba2.init(torch.Generator().manual_seed(0),
                      mamba2.Mamba2Config(**MAMBA_KW))
    _same_layout(got, want)
    for name in ("conv_b", "a_log", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(_np(got[name]), want[name])


@pytest.mark.parametrize("t", T_GRID)
def test_mamba_apply_matches(t):
    """``apply`` at chunk 16 over a ragged T, a chunk boundary and
    padding; the raw SSD (y and the last state, atol scaled to max
    |ref|) and the causal conv."""
    rp, p, rcfg, cfg = _mamba()
    x = _x((2, t, 32), t)
    want = jax.jit(ref_mamba2.apply, static_argnums=2)(rp, jnp.asarray(x),
                                                       rcfg)
    got = mamba2.apply(p, _t(x), cfg)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), want, **MODULE)
    rng = np.random.default_rng(t)
    xs = rng.standard_normal((2, t, 8, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, t, 8)))).astype(np.float32)
    a = -np.exp(np.asarray(rp["a_log"]))
    bm, cm = (rng.standard_normal((2, t, 8)).astype(np.float32)
              for _ in range(2))
    ry, rh = jax.jit(ref_mamba2._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (xs, dt, a, bm, cm)), 16)
    y, h = mamba2._ssd_chunked(*map(_t, (xs, dt, a, bm, cm)), 16)
    for ours, theirs in ((y, ry), (h, rh)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(_np(ours), theirs, rtol=1e-5,
                                   atol=1e-5 * np.abs(theirs).max())
    xc = rng.standard_normal((2, t, 80)).astype(np.float32)
    want = jax.jit(ref_mamba2._causal_conv)(jnp.asarray(xc), rp["conv_w"],
                                            rp["conv_b"])
    got = mamba2._causal_conv(_t(xc), p["conv_w"], p["conv_b"])
    np.testing.assert_allclose(_np(got), want, **MODULE)


def test_mamba_decode_steps_match():
    """Twenty steps (the conv ring of 3 carried, the state over more than
    one chunk) against the reference's, the state included, then against
    ``apply``."""
    rp, p, rcfg, cfg = _mamba(seed=4)
    x = _x((2, 20, 32), 4)
    rstate = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_mamba2.init_state(rcfg, 2))
    state = {k: v.float() for k, v in mamba2.init_state(cfg, 2, CPU).items()}
    outs = []
    for i in range(20):
        want, rstate = ref_mamba2.decode_step(rp, jnp.asarray(x[:, i:i + 1]),
                                              rstate, rcfg)
        got, state = mamba2.decode_step(p, _t(x[:, i:i + 1]), state, cfg)
        np.testing.assert_allclose(_np(got), want, **MODULE)
        for key in ("h", "conv"):
            np.testing.assert_allclose(_np(state[key]), rstate[key], **MODULE)
        outs.append(got)
    fwd = mamba2.apply(p, _t(x), cfg)
    assert float((torch.cat(outs, 1) - fwd).abs().max()) < DECODE_TOL


# -- the models ----------------------------------------------------------------


def _config(arch, num_layers=None):
    """The reduced config of both packages; zamba2 at 5 layers: 2 groups
    of (mamba, mamba, shared_attn) and a tail of one Mamba layer."""
    changes = {"num_layers": num_layers or (5 if arch == "zamba2-1.2b"
                                            else 4)}
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


@functools.lru_cache(maxsize=None)
def _models(arch, seed=0):
    """(reduced cfg, reference model, its params, the port's model, its
    params): one set of parameters, the reference's, perturbed, in
    both.  Cached: no test changes them."""
    rcfg, cfg = _config(arch)
    ref_model = ref_build_model(rcfg)
    rp_np = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(seed)))
    _perturb(rp_np, rcfg, seed + 11)
    p = convert.lm_params_from_numpy(rp_np, rcfg, CPU)
    return (rcfg, ref_model, jax.tree.map(jnp.asarray, rp_np),
            build_model(cfg, CPU), p)


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _count_k8(monkeypatch):
    """K8's calls by q shape: on the CPU its launcher runs the plain
    version (as ``tests/test_torch_lm.py`` counts them)."""
    calls = []
    plain = fk.attention_plain

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fk, "attention_plain", counted)
    return calls


def test_zamba2_plan_has_groups_a_shared_block_and_a_tail():
    rcfg, cfg = _config("zamba2-1.2b")
    plan = transformer.layer_plan(cfg)
    assert plan == transformer.LayerPlan(
        ("mamba", "mamba", "shared_attn"), 2, ("mamba",))
    model = build_model(cfg, CPU)
    assert model.kinds == ("mamba", "mamba", "shared_attn") * 2 + ("mamba",)
    p = model.init(torch.Generator().manual_seed(0))
    assert [len(x) == 0 for x in p["layers"]] == [
        k == "shared_attn" for k in model.kinds]
    assert p["shared_attn"]["attn"]["wq"]["w"].shape == (128, 4 * 32)
    # the port's init has the reference's keys, shapes and dtypes
    ref = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    _same_layout(p["shared_attn"], ref["shared_attn"])
    _same_layout(p["layers"][-1], ref["tail"][0])
    _same_layout(p["layers"][0],
                 jax.tree.map(lambda a: a[0], ref["groups"]["sub0"]))


@pytest.mark.parametrize("arch,t", [("rwkv6-7b", 37), ("rwkv6-7b", 80),
                                    ("zamba2-1.2b", 40),
                                    ("zamba2-1.2b", 80)])
def test_forward_logits_match(arch, t, monkeypatch):
    """The whole reduced model; zamba2 with its tail, at T inside its
    window of 64 (K8, twice) and beyond it (``_sdpa`` with the band)."""
    cfg, ref_model, rp, model, p = _models(arch)
    tokens = _tokens(cfg, 2, t)
    want, _ = jax.jit(ref_model.forward)(rp, jnp.asarray(tokens))
    calls = _count_k8(monkeypatch)
    got, aux = model.forward(p, _t(tokens))
    shared = transformer.layer_plan(cfg).n_groups if arch == "zamba2-1.2b" \
        else 0
    assert calls == ([(2, 4, t, 32)] * shared if t <= cfg.window else [])
    assert got.dtype == torch.float32 and got.shape == (2, t,
                                                        cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), want, **MODEL)


def _ref_decode(ref_model):
    """The reference's decode step, jitted as its ``generate`` does."""
    return jax.jit(lambda p, c, tok, pos: ref_model.decode_step(p, tok, c,
                                                                pos=pos))


@pytest.mark.parametrize("arch,t", [("rwkv6-7b", 20), ("zamba2-1.2b", 80)])
def test_decode_steps_match_the_reference(arch, t):
    """Teacher-forced decode against the reference's step by step, and
    against the port's forward (the reference decode test's bound).
    zamba2 at T = 80 through a cache of 80: its shared block's ring holds
    the window, 64 slots, and wraps."""
    cfg, ref_model, rp, model, p = _models(arch, seed=1)
    tokens = _tokens(cfg, 2, t, seed=1)
    rcache = ref_model.init_cache(rp, 2, t)
    cache = model.init_cache(p, 2, t)
    rings = [c["k"].shape[2] for kind, c in zip(model.kinds, cache["layers"])
             if kind == "shared_attn"]
    assert rings == ([cfg.window] * 2 if arch == "zamba2-1.2b" else [])
    fwd, _ = model.forward(p, _t(tokens))
    rdecode = _ref_decode(ref_model)
    for i in range(t):
        want, rcache = rdecode(rp, rcache, jnp.asarray(tokens[:, i:i + 1]),
                               jnp.asarray(i, jnp.int32))
        got, cache = model.decode_step(p, _t(tokens[:, i:i + 1]), cache,
                                       pos=i)
        np.testing.assert_allclose(_np(got), want, **MODEL)
        assert float((got[:, 0] - fwd[:, i]).abs().max()) < DECODE_TOL
    # the carried state of the last layer (the tail for zamba2) too
    last = cache["layers"][-1]
    ref_last = (rcache["tail"][0] if arch == "zamba2-1.2b" else
                jax.tree.map(lambda a: a[-1], rcache["groups"]["sub0"]))
    assert set(last) == set(ref_last)
    for key in last:
        np.testing.assert_allclose(_np(last[key]), ref_last[key], **MODEL)


def test_rwkv_decode_equals_forward_through_the_published_depth():
    """f32 decode against the forward through all 32 layers (the reduced
    width, the perturbed leaves): the reference decode test's bound, where
    the card's f32 check holds 2 layers."""
    rcfg, cfg = (dataclasses.replace(c, num_layers=32)
                 for c in _config("rwkv6-7b"))
    rp = jax.tree.map(np.asarray,
                      ref_build_model(rcfg).init(jax.random.PRNGKey(5)))
    _perturb(rp, rcfg)
    p = convert.lm_params_from_numpy(rp, rcfg, CPU)
    model = build_model(cfg, CPU)
    tokens = _t(_tokens(cfg, 2, 16, seed=5))
    with torch.no_grad():
        fwd, _ = model.forward(p, tokens)
        cache = model.init_cache(p, 2, 16)
        for i in range(16):
            got, cache = model.decode_step(p, tokens[:, i:i + 1], cache,
                                           pos=i)
            assert float((got[:, 0] - fwd[:, i]).abs().max()) < DECODE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_equals_the_reference(arch):
    cfg, ref_model, rp, model, p = _models(arch, seed=3)
    prompt = _tokens(cfg, 2, 6, seed=3)
    want = ref_serve.generate(ref_model, rp, jnp.asarray(prompt), 8,
                              ref_serve.ServeConfig(max_len=16))
    got = serve_mod.generate(model, p, _t(prompt), 8,
                             serve_mod.ServeConfig(max_len=16))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch, monkeypatch):
    """``make_prefill``: the logits against the reference's, and an empty
    cache of the reference's shapes (zero states, zero KV rings)."""
    cfg, ref_model, rp, model, p = _models(arch)
    tokens = _tokens(cfg, 2, 12)
    rlogits, rcache = jax.jit(ref_serve.make_prefill(
        ref_model, ref_serve.ServeConfig(max_len=32)))(rp, jnp.asarray(tokens))
    calls = _count_k8(monkeypatch)
    logits, cache = serve_mod.make_prefill(
        model, serve_mod.ServeConfig(max_len=32))(p, _t(tokens))
    np.testing.assert_allclose(_np(logits), rlogits, **MODEL)
    plan = transformer.layer_plan(cfg)
    assert len(calls) == plan.group_kinds.count("shared_attn") * plan.n_groups
    k = len(plan.group_kinds)
    for n, c in enumerate(cache["layers"]):
        g, i = divmod(n, k)
        ref = (jax.tree.map(lambda a: a[g], rcache["groups"][f"sub{i}"])
               if g < plan.n_groups else rcache["tail"][i])
        assert set(c) == set(ref)
        for key, v in c.items():
            assert v.shape == ref[key].shape and not v.any(), key
            assert str(v.dtype)[6:] == ref[key].dtype.name, key


def test_convert_carries_the_shared_block_once():
    """A bf16 zamba2 tree: the shared block once, as
    ``params["shared_attn"]``, bit-equal; its layers' entries empty; the
    groups' and the tail's leaves bit-equal in the port's order, the f32
    leaves still f32; as many weights as the reference holds."""
    rcfg = dataclasses.replace(_config("zamba2-1.2b")[0], dtype="bfloat16")
    rp = jax.tree.map(np.asarray,
                      ref_build_model(rcfg).init(jax.random.PRNGKey(7)))
    _perturb(rp, rcfg)
    p = convert.lm_params_from_numpy(rp, rcfg, CPU)
    model = build_model(dataclasses.replace(_config("zamba2-1.2b")[1],
                                            dtype="bfloat16"), CPU)
    assert len(p["layers"]) == len(model.kinds) == rcfg.num_layers + 2
    pairs = [(p["shared_attn"], rp["shared_attn"])]
    for n, kind in enumerate(model.kinds):
        g, i = divmod(n, 3)
        if kind == "shared_attn":
            assert p["layers"][n] == {}
        elif g < 2:
            pairs.append((p["layers"][n], jax.tree.map(
                lambda a: a[g], rp["groups"][f"sub{i}"])))
        else:
            pairs.append((p["layers"][n], rp["tail"][i]))
    for ours, theirs in pairs:
        flat_ours = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(_bits, ours))
        flat_theirs = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(_ref_bits, theirs))
        assert [k for k, _ in flat_ours] == [k for k, _ in flat_theirs]
        for (_, a), (_, b) in zip(flat_ours, flat_theirs):
            np.testing.assert_array_equal(a, b)
    ssm = p["layers"][0]["ssm"]
    assert ssm["a_log"].dtype == torch.float32
    assert ssm["in_proj"]["w"].dtype == torch.bfloat16
    assert _numel(p) == sum(a.size for a in jax.tree.leaves(rp))


def test_convert_carries_rwkv_leaves_in_their_dtypes():
    rcfg = dataclasses.replace(_config("rwkv6-7b")[0], dtype="bfloat16")
    rp = jax.tree.map(np.asarray,
                      ref_build_model(rcfg).init(jax.random.PRNGKey(8)))
    p = convert.lm_params_from_numpy(rp, rcfg, CPU)
    mix = p["layers"][3]["mix"]
    assert {k: str(mix[k].dtype) for k in ("decay_base", "bonus")} | {
        "wr": str(mix["wr"]["w"].dtype)} == {
        "decay_base": "torch.float32", "bonus": "torch.float32",
        "wr": "torch.bfloat16"}
    np.testing.assert_array_equal(
        _bits(mix["mix_b"]), _ref_bits(rp["groups"]["sub0"]["mix"]["mix_b"][3]))
    assert _numel(p) == sum(a.size for a in jax.tree.leaves(rp))


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


# -- routes and entry points ---------------------------------------------------


def test_shared_attention_takes_k8_where_the_prompt_fits_its_window():
    for arch, t, want in (("zamba2-1.2b", 4096, True),
                          ("zamba2-1.2b", 2048, True),
                          ("zamba2-1.2b", 4097, False)):
        acfg = transformer._attn_cfg(get_config(arch), "shared_attn")
        assert acfg.window == 4096
        assert attention.flash_route(acfg, t=t) == want, t
    assert not attention.flash_route(acfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    before = dict(fk.LAUNCHES)
    out = launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", "4", "--gen", "4", "--device",
                             "cpu"])
    assert out.shape == (2, 8)
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out
    assert fk.LAUNCHES == before


def _example(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"), *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_serve_example_on_the_cpu():
    out = _example("--torch-device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]
    assert [ln.split()[1] for ln in lines] == list(ARCHS)
    assert all("on cpu: generated (4, 32)" in ln for ln in lines)


def test_serve_entry_points_refuse_without_a_card():
    """Without ``--torch-device cpu`` (``--device cpu``) the example and
    ``launch.serve`` raise where there is no card, before any work."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    before = dict(fk.LAUNCHES)
    with pytest.raises((RuntimeError, AssertionError)):
        launch_serve.main(["--arch", "zamba2-1.2b", "--reduced", "--gen",
                           "2"])
    out = _example()
    assert out.returncode != 0 and "[serve]" not in out.stdout
    assert fk.LAUNCHES == before
