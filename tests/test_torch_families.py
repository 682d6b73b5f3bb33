"""The port's gemma2, llama-3.2-vision and Whisper families against the
reference's.

On reduced f32 configs on the CPU, where K8's launcher runs its plain
version: the reference's parameters, initialised by ``jax.random``, are
carried across as numpy (``convert.lm_params_from_numpy``,
``convert.whisper_params_from_numpy``), and tokens, frames and image
embeddings are made with numpy from a seed.  llama-vision's cross layers
start with closed gates (``tanh(0) = 0``), which would make any
comparison of them pass whatever they compute, so every comparison here
opens them (``GATES``) in the numpy parameters both packages receive.

Bounds: 1e-4 for a whole model's logits and decode steps (the bound of
``tests/test_torch_lm.py``, the reference's own prefill test), 1e-5 for
Whisper's encoder alone, 2e-2 for decode against forward
(``tests/test_models_decode.py``); greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro.serve import step as ref_serve
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer, whisper
from repro_torch.models.registry import build_model, make_batch
from repro_torch.serve import step as serve_mod

CPU = "cpu"
ENCODER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = 2e-2
ARCHS = ("gemma2-27b", "llama-3.2-vision-11b", "whisper-small")
# llama-vision's (gate_attn, gate_ffn) per group, opened for every
# comparison: tanh 0.46-0.76, of both signs
GATES = ((0.5, -0.8), (-0.7, 1.0))


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _open_gates(rp_np: dict, cfg) -> None:
    """Sets every cross layer's gates of the numpy reference parameters
    ``rp_np`` to GATES, in place."""
    plan = transformer.layer_plan(cfg)
    for i, kind in enumerate(plan.group_kinds):
        if kind == "cross":
            sub = rp_np["groups"][f"sub{i}"]
            for j, name in enumerate(("gate_attn", "gate_ffn")):
                sub[name] = np.array([GATES[g % 2][j]
                                      for g in range(plan.n_groups)],
                                     np.float32)


def _models(arch, seed=0):
    """(reduced cfg, reference model, its params, the port's model, its
    params): one set of parameters, the reference's, in both."""
    cfg = ref_get_config(arch).reduced()
    ref_model = ref_build_model(cfg)
    rp_np = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(seed)))
    if cfg.family == "audio":
        p = convert.whisper_params_from_numpy(rp_np, cfg, CPU)
    else:
        _open_gates(rp_np, cfg)
        p = convert.lm_params_from_numpy(rp_np, cfg, CPU)
    model = build_model(get_config(arch).reduced(), CPU)
    return cfg, ref_model, jax.tree.map(jnp.asarray, rp_np), model, p


def _inputs(cfg, b, t, seed=0):
    """Seeded numpy tokens and the family's stub: (tokens, extras as
    numpy)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = (rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        extras["image_embeds"] = (rng.standard_normal(
            (b, cfg.image_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return tokens, extras


def _jx(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


def _tx(extras):
    return {k: _t(v) for k, v in extras.items()}


def _ref_decode(ref_model):
    """The reference's decode step, jitted as its ``generate`` does."""
    return jax.jit(lambda p, c, tok, pos: ref_model.decode_step(p, tok, c,
                                                                pos=pos))


def _count_k8(monkeypatch):
    """K8's calls as (q shape, causal): on the CPU its launcher runs the
    plain version."""
    calls = []
    plain = fk.attention_plain

    def counted(q, k, v, *, causal=True, group=1):
        calls.append((tuple(q.shape), causal))
        return plain(q, k, v, causal=causal, group=group)

    monkeypatch.setattr(fk, "attention_plain", counted)
    return calls


def _k8_layers(cfg):
    """K8 launches of one forward: Whisper's encoder and decoder
    self-attention, llama-vision's self-attention layers, none of
    gemma2's (every layer softcapped)."""
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.num_layers
    if cfg.attn_pattern == "local_global":
        return 0
    return cfg.num_layers


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, monkeypatch):
    cfg, ref_model, rp, model, p = _models(arch)
    tokens, extras = _inputs(cfg, 2, 20)
    want, _ = ref_model.forward(rp, jnp.asarray(tokens), **_jx(extras))
    calls = _count_k8(monkeypatch)
    got, aux = model.forward(p, _t(tokens), **_tx(extras))
    assert len(calls) == _k8_layers(cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 20,
                                                        cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), want, **MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch):
    cfg, ref_model, rp, model, p = _models(arch, seed=1)
    tokens, extras = _inputs(cfg, 2, 16, seed=1)
    rcache = ref_model.init_cache(rp, 2, 64, **_jx(extras))
    cache = model.init_cache(p, 2, 64, **_tx(extras))
    rdecode = _ref_decode(ref_model)
    for t in range(8):
        want, rcache = rdecode(rp, rcache, jnp.asarray(tokens[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
        got, cache = model.decode_step(p, _t(tokens[:, t:t + 1]), cache,
                                       pos=t)
        np.testing.assert_allclose(_np(got), want, **MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    """Teacher-forced decode (``_sdpa`` over the cache, the cross K/V
    projected once) against the forward (K8 where routed), in the port
    itself: the reference decode test's bound."""
    cfg, _, _, model, p = _models(arch, seed=2)
    tokens, extras = _inputs(cfg, 2, 16, seed=2)
    fwd, _ = model.forward(p, _t(tokens), **_tx(extras))
    cache = model.init_cache(p, 2, 64, **_tx(extras))
    for t in range(8):
        got, cache = model.decode_step(p, _t(tokens[:, t:t + 1]), cache,
                                       pos=t)
        assert float((got[:, 0] - fwd[:, t]).abs().max()) < DECODE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_equals_the_reference(arch):
    cfg, ref_model, rp, model, p = _models(arch, seed=3)
    prompt, extras = _inputs(cfg, 2, 6, seed=3)
    want = ref_serve.generate(ref_model, rp, jnp.asarray(prompt), 8,
                              ref_serve.ServeConfig(max_len=16),
                              extras=_jx(extras))
    got = serve_mod.generate(model, p, _t(prompt), 8,
                             serve_mod.ServeConfig(max_len=16),
                             extras=_tx(extras))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch, monkeypatch):
    """``make_prefill`` with the family's stub: the logits, and the cache
    (llama-vision's image K/V, Whisper's cross K/V of the encoded frames),
    against the reference's.  A Whisper prefill encodes the frames twice,
    as the reference's does."""
    cfg, ref_model, rp, model, p = _models(arch)
    tokens, extras = _inputs(cfg, 2, 12)
    rlogits, rcache = ref_serve.make_prefill(ref_model, ref_serve.ServeConfig(
        max_len=32))(rp, jnp.asarray(tokens), _jx(extras))
    calls = _count_k8(monkeypatch)
    logits, cache = serve_mod.make_prefill(
        model, serve_mod.ServeConfig(max_len=32))(p, _t(tokens), _tx(extras))
    np.testing.assert_allclose(_np(logits), rlogits, **MODEL)
    if cfg.family == "audio":
        assert len(calls) == 2 * cfg.encoder_layers + cfg.num_layers
        for i, c in enumerate(cache["layers"]):
            np.testing.assert_allclose(_np(c["xk"]), rcache["xk"][i], **MODEL)
            np.testing.assert_allclose(_np(c["xv"]), rcache["xv"][i], **MODEL)
            assert c["k"].shape == rcache["k"].shape[1:] and not c["k"].any()
        return
    assert len(calls) == _k8_layers(cfg)
    kinds = transformer.layer_plan(cfg).group_kinds
    for n, (kind, c) in enumerate(zip(model.kinds, cache["layers"])):
        g, i = divmod(n, len(kinds))
        ref = jax.tree.map(lambda a: a[g], rcache["groups"][f"sub{i}"])
        assert c["k"].shape == ref["k"].shape
        if kind == "cross":
            np.testing.assert_allclose(_np(c["v"]), ref["v"], **MODEL)
        else:
            assert not c["k"].any()


def test_gemma2_ring_wraps_past_the_window():
    """80 teacher-forced steps through gemma2's local layers, whose cache
    is a ring of the reduced window's 64 slots, each step against the
    reference's."""
    cfg, ref_model, rp, model, p = _models("gemma2-27b", seed=4)
    assert cfg.window == 64
    tokens, _ = _inputs(cfg, 1, 80, seed=4)
    rcache = ref_model.init_cache(rp, 1, 96)
    cache = model.init_cache(p, 1, 96)
    assert [c["k"].shape[2] for c in cache["layers"]] == [64, 96] * 2
    rdecode = _ref_decode(ref_model)
    for t in range(80):
        want, rcache = rdecode(rp, rcache, jnp.asarray(tokens[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
        got, cache = model.decode_step(p, _t(tokens[:, t:t + 1]), cache,
                                       pos=t)
        np.testing.assert_allclose(_np(got), want, **MODEL)


def _small_local_layer(t, seed=6):
    """A small windowed, softcapped f32 attention layer (window 8, cap
    5.0) and an input x (1, t, 32) x 2 from a seeded generator."""
    from repro_torch.models import attention
    acfg = attention.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2,
                                head_dim=8, window=8, logit_softcap=5.0,
                                rope_theta=1e4, dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    p = attention.init(gen, acfg)
    return acfg, p, torch.randn((1, t, 32), generator=gen) * 2


def test_banded_oracle_agrees_with_attend():
    """The f64 oracle the card's window check holds a full-width gemma2
    layer to (``tests/_gemma2_window.py``), on a small layer: ``attend``
    within 1e-5 of its band, and the band moves the rows past the window."""
    from _gemma2_window import banded_attention_f64

    from repro_torch.models import attention
    acfg, p, x = _small_local_layer(24)
    with torch.no_grad():
        got, _ = attention.attend(p, x, acfg)
    want, causal = banded_attention_f64(p, x, acfg)
    assert float((got.double() - want).abs().max()) <= 1e-5
    assert float((want - causal)[:, acfg.window:].abs().max()) > 1e-2
    assert float((want - causal)[:, :acfg.window].abs().max()) == 0.0


def test_ring_check_compares_buffers_of_different_sizes():
    """The card's ring check (``tests/_gemma2_window.py``) on a small
    layer: an 8-slot ring against a 20-slot buffer, never two rings of
    the window's size, equal within 1e-5 on every step past the wrap."""
    from _gemma2_window import ring_against_full
    acfg, p, _ = _small_local_layer(1)
    x = torch.randn((1, 20, 32), generator=torch.Generator().manual_seed(7))
    slots, worst, wrapped = ring_against_full(p, x, acfg)
    assert slots == (8, 20)
    assert worst <= 1e-5 and wrapped <= worst
    with pytest.raises(ValueError, match="never wrap"):
        ring_against_full(p, x[:, :8], acfg)


@pytest.mark.parametrize("window", [None, 8])
def test_softcapped_sdpa_backpropagates_as_the_reference(window):
    """gemma2's attention under grad: ``_sdpa`` with a softcap keeps what
    backward needs, and the gradients of q, k and v equal the reference's
    ``jax.grad`` of its ``_sdpa``."""
    from repro.models import attention as ref_attention
    from repro_torch.models import attention
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 2, 2, 16, 8)).astype(np.float32) * 4
    k = rng.standard_normal((2, 2, 16, 8)).astype(np.float32) * 4
    v = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    w = rng.standard_normal((2, 2, 2, 16, 8)).astype(np.float32)
    pos = np.arange(16)
    rbias = ref_attention._mask_bias(jnp.asarray(pos), jnp.asarray(pos),
                                     True, window)
    bias = attention._mask_bias(_t(pos), _t(pos), True, window)
    scale, cap = 8 ** -0.5, 5.0

    def ref_loss(q, k, v):
        return (ref_attention._sdpa(q, k, v, rbias, cap, scale) * w).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (attention._sdpa(tq, tk, tv, bias, cap, scale) * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **MODEL)


def test_gemma2_logits_under_grad_equal_the_served_ones():
    """The final softcap caps the f32 logits in place only where no
    gradient is kept: under grad the logits equal the served ones bit for
    bit, the reference's within MODEL, and backward reaches the table."""
    cfg, ref_model, rp, model, p = _models("gemma2-27b", seed=9)
    tokens, _ = _inputs(cfg, 2, 12, seed=9)
    want, _ = ref_model.forward(rp, jnp.asarray(tokens))
    with torch.no_grad():
        served, _ = model.forward(p, _t(tokens))
    table = p["embed"]["table"].requires_grad_()
    got, _ = model.forward(p, _t(tokens))
    assert got.requires_grad and torch.equal(got.detach(), served)
    np.testing.assert_allclose(_np(got), want, **MODEL)
    got.square().mean().backward()
    assert table.grad is not None and bool(table.grad.isfinite().all())
    assert float(table.grad.abs().max()) > 0


def test_whisper_encode_matches_the_reference():
    cfg, ref_model, rp, model, p = _models("whisper-small", seed=5)
    _, extras = _inputs(cfg, 2, 1, seed=5)
    want = ref_model.encode(rp, jnp.asarray(extras["frames"]))
    got = model.encode(p, _t(extras["frames"]))
    assert got.shape == (2, cfg.encoder_frames, cfg.d_model)
    np.testing.assert_allclose(_np(got), want, **ENCODER)


def test_whisper_positions_match_the_reference():
    """The prefill adds the float64 table of 0..T-1, a decode step the
    f32 sinusoid at its position (a Python int here, an int32 array in
    the reference), each as the reference computes it."""
    from repro.models import whisper as ref_whisper
    for pos in (0, 1, 447, 1499):
        np.testing.assert_allclose(
            _np(whisper._sinusoid_at(pos, 768, CPU)),
            ref_whisper._sinusoid_at(jnp.asarray(pos, jnp.int32), 768),
            rtol=1e-6, atol=1e-6)
    cfg, ref_model, rp, model, p = _models("whisper-small")
    tokens, _ = _inputs(cfg, 2, 9)
    np.testing.assert_allclose(_np(model._dec_embed(p, _t(tokens))),
                               ref_model._dec_embed(rp, jnp.asarray(tokens)),
                               rtol=1e-6, atol=1e-6)
    for pos in (0, 5, 63):
        np.testing.assert_allclose(
            _np(model._dec_embed(p, _t(tokens[:, :1]), pos=pos)),
            ref_model._dec_embed(rp, jnp.asarray(tokens[:, :1]),
                                 pos0=jnp.asarray(pos, jnp.int32)),
            rtol=1e-6, atol=1e-6)


def test_whisper_encoder_takes_k8_bidirectional(monkeypatch):
    """Each encoder layer is one non-causal K8 launch over the frames, each
    decoder layer one causal launch over the tokens; cross-attention
    (queries of the tokens, keys of the frames) never reaches K8."""
    cfg, _, _, model, p = _models("whisper-small")
    tokens, extras = _inputs(cfg, 2, 12)
    calls = _count_k8(monkeypatch)
    model.forward(p, _t(tokens), **_tx(extras))
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    enc = ((2, h, cfg.encoder_frames, hd), False)
    dec = ((2, h, 12, hd), True)
    assert calls == [enc] * cfg.encoder_layers + [dec] * cfg.num_layers


def test_vlm_cross_layers_never_take_k8(monkeypatch):
    """llama-vision's self-attention layers take K8 causally; its cross
    layers, which attend to the image tokens, run ``_sdpa``."""
    cfg, _, _, model, p = _models("llama-3.2-vision-11b")
    tokens, extras = _inputs(cfg, 2, 12)
    calls = _count_k8(monkeypatch)
    model.forward(p, _t(tokens), **_tx(extras))
    assert model.kinds.count("cross") == cfg.num_layers // cfg.cross_attn_every
    assert calls == [((2, cfg.num_heads, 12, cfg.resolved_head_dim), True)
                     ] * cfg.num_layers


def test_vlm_gates_start_closed_and_open_through_tanh():
    """``init`` closes the gates, as the reference's does; opened, a cross
    layer changes the logits."""
    cfg, _, _, model, p = _models("llama-3.2-vision-11b")
    fresh = model.init(torch.Generator().manual_seed(0))
    cross = [q for kind, q in zip(model.kinds, fresh["layers"])
             if kind == "cross"]
    assert all(q["gate_attn"].dtype == torch.float32
               and q["gate_attn"].shape == () and not q["gate_attn"]
               and not q["gate_ffn"] for q in cross)
    tokens, extras = _inputs(cfg, 1, 8)
    opened, _ = model.forward(p, _t(tokens), **_tx(extras))
    for kind, q in zip(model.kinds, p["layers"]):
        if kind == "cross":
            q["gate_attn"] = torch.zeros(())
            q["gate_ffn"] = torch.zeros(())
    closed, _ = model.forward(p, _t(tokens), **_tx(extras))
    assert float((opened - closed).abs().max()) > 1e-2


# -- stubs, conversion, the command line --------------------------------------


@pytest.mark.parametrize("arch,name,size,n", [
    ("llama-3.2-vision-11b", "image_embeds", "image_tokens", 1600),
    ("whisper-small", "frames", "encoder_frames", 1500)])
def test_make_batch_stubs_are_seeded(arch, name, size, n):
    """The family's stub at the published size, normal x 0.02 in the
    config's dtype, drawn from the caller's generator; tokens as for any
    arch."""
    cfg = get_config(arch)
    a, b = (make_batch(cfg, 2, 8, torch.Generator().manual_seed(4))
            for _ in range(2))
    assert set(a) == {"tokens", "labels", name}
    x = a[name]
    assert x.shape == (2, n, cfg.d_model) and x.dtype == torch.bfloat16
    assert torch.equal(x, b[name]) and torch.equal(a["tokens"], b["tokens"])
    assert abs(float(x.float().std()) - 0.02) < 1e-3
    other = make_batch(cfg, 2, 8, torch.Generator().manual_seed(5))[name]
    assert not torch.equal(x, other)
    small = make_batch(cfg.reduced(), 2, 8, torch.Generator().manual_seed(4))
    assert small[name].dtype == torch.float32
    assert small[name].shape == (2, getattr(cfg.reduced(), size), 128)
    assert set(make_batch(get_config("gemma2-27b").reduced(), 1, 4,
                          torch.Generator())) == {"tokens", "labels"}


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch,changes", [
    ("gemma2-27b", dict(num_layers=4)),
    ("llama-3.2-vision-11b", dict(num_layers=10, cross_attn_every=5)),
    ("whisper-small", dict())])
def test_convert_carries_every_layer_in_order(arch, changes):
    """bf16 parameters of the two-sub-block group (gemma2), the six-sub
    group of llama-vision's published cadence (5 + 1, two groups) and
    Whisper's stacks, bit for bit in the port's per-layer order; the cross
    layers' f32 gates with them."""
    cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                              dtype="bfloat16", **changes)
    rp = jax.tree.map(np.asarray,
                      ref_build_model(cfg).init(jax.random.PRNGKey(7)))
    if cfg.family == "audio":
        p = convert.whisper_params_from_numpy(rp, cfg, CPU)
        pairs = [(p[f"{s}_blocks"][i], jax.tree.map(lambda a: a[i],
                                                    rp[f"{s}_blocks"]))
                 for s, n in (("enc", cfg.encoder_layers),
                              ("dec", cfg.num_layers)) for i in range(n)]
        assert len(p["dec_blocks"]) == cfg.num_layers
    else:
        _open_gates(rp, cfg)
        p = convert.lm_params_from_numpy(rp, cfg, CPU)
        plan = transformer.layer_plan(cfg)
        k = len(plan.group_kinds)
        assert k == {"gemma2-27b": 2, "llama-3.2-vision-11b": 6}[arch]
        assert len(p["layers"]) == k * plan.n_groups
        pairs = [(p["layers"][g * k + i],
                  jax.tree.map(lambda a: a[g], rp["groups"][f"sub{i}"]))
                 for g in range(plan.n_groups) for i in range(k)]
        if plan.group_kinds[-1] == "cross":
            assert [float(p["layers"][g * k + k - 1]["gate_attn"])
                    for g in range(plan.n_groups)] == [
                        float(np.float32(GATES[g][0])) for g in (0, 1)]
    w = pairs[-1][0]["attn"]["wq"]["w"]
    assert w.dtype == torch.bfloat16
    for ours, theirs in pairs:
        flat_ours = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(_bits, ours))
        flat_theirs = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(_ref_bits, theirs))
        assert [k for k, _ in flat_ours] == [k for k, _ in flat_theirs]
        for (_, a), (_, b) in zip(flat_ours, flat_theirs):
            np.testing.assert_array_equal(a, b)


def test_convert_refuses_a_shared_block():
    # no longer refused: zamba2's shared block is carried once, as the
    # port's params["shared_attn"], and its layers' entries are empty
    # (tests/test_torch_ssm.py holds every leaf bit for bit)
    cfg = ref_get_config("zamba2-1.2b").reduced()
    rp = jax.tree.map(np.asarray,
                      ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    p = convert.lm_params_from_numpy(rp, cfg, CPU)
    kinds = build_model(get_config("zamba2-1.2b").reduced(), CPU).kinds
    assert [k for k, layer in zip(kinds, p["layers"]) if not layer] == [
        "shared_attn"] * (cfg.num_layers // cfg.attn_every)
    np.testing.assert_array_equal(
        p["shared_attn"]["attn"]["wq"]["w"].numpy(),
        rp["shared_attn"]["attn"]["wq"]["w"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    before = dict(fk.LAUNCHES)
    out = launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", "4", "--gen", "4", "--device",
                             "cpu"])
    assert out.shape == (2, 8)
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out
    assert fk.LAUNCHES == before
