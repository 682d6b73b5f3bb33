"""The port's dense LM serving path against the reference's.

Configs, layers, attention (the K8 prefill route and the decode route
over the cache), ``CausalLM`` forward and decode, ``make_prefill`` and
``generate``, on reduced configs (f32) on the CPU.  The reference's
parameters, initialised by ``jax.random``, are carried across with
``convert.lm_params_from_numpy``; inputs are made with numpy.  Bounds:
1e-6 for the layers (one f32 op or two), 1e-5 for attention (f32 sums in
other orders), 1e-4 for the logits of a whole model (the reference's own
prefill test, ``tests/test_optim_serve_misc.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models.registry import build_model as ref_build_model
from repro.serve import step as ref_serve
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, layers, transformer
from repro_torch.models.registry import build_model, make_batch
from repro_torch.models.whisper import WhisperModel
from repro_torch.serve import step as serve_mod

CPU = "cpu"
LAYER = dict(rtol=1e-6, atol=1e-6)
ATTN = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
PREFILL_T = 2048        # the serving path's prefill on the card


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params(tree):
    """Reference parameters as CPU tensors, keys kept."""
    if isinstance(tree, dict):
        return {k: _params(v) for k, v in tree.items()}
    return _t(tree)


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_equal_the_reference(arch):
    assert ARCHS == REF_ARCHS
    for ours, theirs in ((get_config(arch), ref_get_config(arch)),
                         (get_config(arch).reduced(),
                          ref_get_config(arch).reduced())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert (ours.padded_vocab, ours.resolved_head_dim,
                ours.param_count(), ours.active_param_count()) == (
            theirs.padded_vocab, theirs.resolved_head_dim,
            theirs.param_count(), theirs.active_param_count())


# -- layers ------------------------------------------------------------------


def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    pos = np.arange(7, 12)
    cos, sin = layers.rope_angles(_t(pos), 16, 1e6)
    rcos, rsin = ref_layers.rope_angles(jnp.asarray(pos), 16, 1e6)
    assert cos.dtype == torch.float32
    np.testing.assert_allclose(_np(cos), rcos, **LAYER)
    np.testing.assert_allclose(_np(sin), rsin, **LAYER)
    np.testing.assert_allclose(
        _np(layers.apply_rope(_t(x), cos, sin)),
        ref_layers.apply_rope(jnp.asarray(x), rcos, rsin), **LAYER)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(layers.rmsnorm({"scale": _t(scale)}, _t(x))),
        ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
        **LAYER)
    np.testing.assert_allclose(
        _np(layers.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x))),
        ref_layers.layernorm({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jnp.asarray(x)),
        **LAYER)
    np.testing.assert_allclose(_np(layers.softcap(_t(x * 40), 30.0)),
                               ref_layers.softcap(jnp.asarray(x * 40), 30.0),
                               **LAYER)
    tx = _t(x)
    assert layers.softcap(tx, None) is tx
    np.testing.assert_allclose(_np(layers.sinusoidal_positions(9, 16, CPU)),
                               ref_layers.sinusoidal_positions(9, 16), **LAYER)
    labels = rng.integers(0, 16, (2, 5))
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        np.testing.assert_allclose(
            _np(layers.softmax_xent(_t(x), _t(labels),
                                    None if m is None else _t(m))),
            ref_layers.softmax_xent(jnp.asarray(x), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m)),
            **LAYER)


def test_rmsnorm_casts_back_before_it_scales():
    """bf16: normalised in f32, rounded to bf16, then multiplied by the
    bf16 scale (the reference's order), bit for bit."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((3, 64)), jnp.bfloat16)
    scale = jnp.asarray(rng.standard_normal(64) * 3, jnp.bfloat16)
    want = ref_layers.rmsnorm({"scale": scale}, x)
    got = layers.rmsnorm({"scale": convert._tensor(np.asarray(scale), CPU)},
                         convert._tensor(np.asarray(x), CPU))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# -- attention ---------------------------------------------------------------


def _attn_case(window=None, softcap=None, d_model=64, heads=4, kv=2, hd=16):
    kw = dict(d_model=d_model, num_heads=heads, num_kv_heads=kv, head_dim=hd,
              qkv_bias=True, window=window, logit_softcap=softcap,
              rope_theta=1e6, dtype="float32")
    rcfg = ref_attention.AttnConfig(**kw)
    p = ref_attention.init(jax.random.PRNGKey(0), rcfg)
    # non-zero biases so that the bias add is checked too
    p = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, p)
    return rcfg, attention.AttnConfig(**kw), p, _params(p)


def _count_k8(monkeypatch):
    """Count K8's calls: on the CPU its launcher runs the plain version."""
    calls = []
    plain = fk.attention_plain

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fk, "attention_plain", counted)
    return calls


@pytest.mark.parametrize("t", [12, 64, 130])
def test_attend_without_cache_takes_k8_and_matches(t, monkeypatch):
    """The prefill route: K8 (its plain version here) at the real T, with
    no padding to a block, against the reference's ``_sdpa``."""
    rcfg, cfg, rp, p = _attn_case()
    assert attention.flash_route(cfg)
    calls = _count_k8(monkeypatch)
    x = np.random.default_rng(t).standard_normal((2, t, 64)).astype(
        np.float32)
    want, _ = ref_attention.attend(rp, jnp.asarray(x), rcfg)
    got, cache = attention.attend(p, _t(x), cfg)
    assert cache is None
    assert calls == [(2, 4, t, 16)]
    np.testing.assert_allclose(_np(got), want, **ATTN)


def test_flash_route_is_chosen_from_config_and_arguments():
    _, cfg, _, _ = _attn_case()
    assert attention.flash_route(cfg)
    rep = dataclasses.replace
    for other in (rep(cfg, window=8), rep(cfg, logit_softcap=50.0),
                  rep(cfg, bf16_score_grad=True)):
        assert not attention.flash_route(other)
    # a window that the sequence fits inside masks nothing: K8 takes it
    assert attention.flash_route(rep(cfg, window=8), t=8)
    assert not attention.flash_route(rep(cfg, window=8), t=9)
    assert not attention.flash_route(rep(cfg, window=8, logit_softcap=50.0),
                                     t=8)
    # bidirectional self-attention (Whisper's encoder) takes K8 too
    assert attention.flash_route(rep(cfg, causal=False))
    # the served LM layers keep their routes: a causal K8 prefill for the
    # dense, MoE and llama-vision self-attention layers; gemma2's
    # softcapped (and windowed) pair and the cross layers stay on _sdpa;
    # zamba2's shared attention (window 4096) takes K8 at T <= 4096
    for arch, kind, k8 in (("qwen2-72b", "attn", True),
                           ("zamba2-1.2b", "shared_attn", True),
                           ("qwen3-moe-235b-a22b", "attn", True),
                           ("granite-moe-1b-a400m", "attn", True),
                           ("llama-3.2-vision-11b", "attn", True),
                           ("gemma2-27b", "attn_local", False),
                           ("gemma2-27b", "attn_global", False)):
        acfg = transformer._attn_cfg(get_config(arch), kind)
        assert acfg.causal and attention.flash_route(
            acfg, t=PREFILL_T) == k8, arch
    # a head size the kernel does not take is its refusal on the card,
    # never a quiet detour through _sdpa
    assert attention.flash_route(rep(cfg, head_dim=8))
    x = torch.zeros(1, 3, 64)
    for kw in (dict(kv_x=x), dict(positions=torch.arange(3)),
               dict(cache={"k": x, "v": x, "pos": 0}), dict(kv_block=64)):
        assert not attention.flash_route(cfg, **kw)


@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (None, 20.0)])
def test_attend_plain_routes_match(window, softcap):
    """Windows and softcaps stay on the plain ``_sdpa``, as in the
    reference."""
    rcfg, cfg, rp, p = _attn_case(window=window, softcap=softcap)
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(
        np.float32)
    pos = np.arange(20)
    want, _ = ref_attention.attend(rp, jnp.asarray(x), rcfg,
                                   positions=jnp.asarray(pos))
    got, _ = attention.attend(p, _t(x), cfg, positions=_t(pos))
    np.testing.assert_allclose(_np(got), want, **ATTN)


@pytest.mark.parametrize("window,buf", [(None, 24), (8, 24), (8, 8)])
def test_decode_against_the_cache(window, buf):
    """24 decode steps through the cache, against the reference step by
    step; with a window, a full-length buffer and a ring of window size."""
    rcfg, cfg, rp, p = _attn_case(window=window)
    x = np.random.default_rng(3).standard_normal((1, 24, 64)).astype(
        np.float32)
    rc = ref_attention.init_cache(rcfg, 1, buf, jnp.float32)
    rcache = {"k": rc["k"][:, :, :buf], "v": rc["v"][:, :, :buf]}
    cache = attention.init_cache(cfg, 1, buf, torch.float32, CPU)
    for t in range(24):
        rout, nc = ref_attention.attend(
            rp, jnp.asarray(x[:, t:t + 1]), rcfg,
            positions=jnp.asarray([t]),
            cache=dict(rcache, pos=jnp.asarray(t, jnp.int32)))
        rcache = {"k": nc["k"], "v": nc["v"]}
        out, cache = attention.attend(p, _t(x[:, t:t + 1]), cfg,
                                      positions=torch.tensor([t]),
                                      cache=dict(cache, pos=t))
        assert cache["pos"] == t + 1
        np.testing.assert_allclose(_np(out), rout, **ATTN)
    np.testing.assert_allclose(_np(cache["k"]), rcache["k"], **ATTN)


def test_multi_token_write_past_the_ring_raises():
    _, cfg, _, p = _attn_case(window=8)
    cache = attention.init_cache(cfg, 1, 8, torch.float32, CPU)
    x = torch.zeros(1, 3, 64)
    with pytest.raises(ValueError, match="overruns"):
        attention.attend(p, x, cfg, positions=torch.arange(6, 9),
                         cache=dict(cache, pos=6))


# the reference's blockwise cases (tests/test_sequence_models.py): dense
# GQA, and a window with a softcap; their bound 1e-4
BLOCKWISE = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window,softcap,kv", [(None, None, 2),
                                               (24, 20.0, 4), (40, None, 2)])
@pytest.mark.parametrize("q_block", [None, 16, 64])
def test_blockwise_attention_matches_the_reference(window, softcap, kv,
                                                   q_block, monkeypatch):
    """``kv_block`` takes the blockwise path (online softmax over 16-key
    blocks), over 16-query blocks too where ``q_block`` divides T and T >
    ``q_block`` (64 does not: the 1-D path): equal to the reference's
    ``attend`` on the same path and to its dense attention, no K8."""
    rcfg, cfg, rp, p = _attn_case(window=window, softcap=softcap, kv=kv)
    x = np.random.default_rng(5).standard_normal((2, 64, 64)).astype(
        np.float32)
    want, _ = ref_attention.attend(rp, jnp.asarray(x), rcfg, kv_block=16,
                                   q_block=q_block)
    dense, _ = ref_attention.attend(rp, jnp.asarray(x), rcfg)
    calls = _count_k8(monkeypatch)
    got, _ = attention.attend(p, _t(x), cfg, kv_block=16, q_block=q_block)
    assert calls == []
    np.testing.assert_allclose(_np(got), want, **BLOCKWISE)
    np.testing.assert_allclose(_np(got), dense, **BLOCKWISE)


def test_blockwise_2d_equals_the_reference_function():
    """``_sdpa_blockwise_2d`` on the same (B,KV,G,T,hd) inputs as the
    reference's, causal with a window, and a ragged key count raises."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 2, 2, 32, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 32, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 32, 8)).astype(np.float32)
    pos = np.arange(32)
    args = (True, 12, 30.0, 8 ** -0.5, 8, 16)
    want = ref_attention._sdpa_blockwise_2d(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), *args)
    got = attention._sdpa_blockwise_2d(*(_t(a) for a in (q, k, v, pos, pos)),
                                       *args)
    np.testing.assert_allclose(_np(got), want, **BLOCKWISE)
    with pytest.raises(ValueError, match="12-key blocks"):
        attention._sdpa_blockwise(*(_t(a) for a in (q, k, v, pos, pos)),
                                  True, None, None, 1.0, 12)


# -- the model ---------------------------------------------------------------


def _models(arch, seed=0):
    cfg = ref_get_config(arch).reduced()
    ref_model = ref_build_model(cfg)
    rp = ref_model.init(jax.random.PRNGKey(seed))
    model = build_model(get_config(arch).reduced(), CPU)
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), cfg, CPU)
    return cfg, ref_model, rp, model, p


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen2-72b", "command-r-plus-104b"])
def test_forward_logits_match(arch, monkeypatch):
    """qwen2-72b: QKV bias, untied head; command-r-plus-104b: no bias,
    tied embeddings.  T = 20 pads to one 128-block in every layer."""
    cfg, ref_model, rp, model, p = _models(arch)
    assert ("lm_head" in p) == (not cfg.tie_embeddings)
    assert len(p["layers"]) == cfg.num_layers
    tokens = _tokens(cfg, 2, 20)
    want, _ = ref_model.forward(rp, jnp.asarray(tokens))
    calls = _count_k8(monkeypatch)
    got, aux = model.forward(p, _t(tokens))
    assert len(calls) == cfg.num_layers
    assert got.dtype == torch.float32 and got.shape == (2, 20,
                                                        cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), want, **MODEL)


def test_decode_steps_match_the_reference():
    cfg, ref_model, rp, model, p = _models("qwen2-72b", seed=1)
    tokens = _tokens(cfg, 2, 16, seed=1)
    rcache = ref_model.init_cache(rp, 2, 64)
    cache = model.init_cache(p, 2, 64)
    fwd, _ = model.forward(p, _t(tokens))
    for t in range(8):
        want, rcache = ref_model.decode_step(
            rp, jnp.asarray(tokens[:, t:t + 1]), rcache,
            pos=jnp.asarray(t, jnp.int32))
        got, cache = model.decode_step(p, _t(tokens[:, t:t + 1]), cache, pos=t)
        np.testing.assert_allclose(_np(got), want, **MODEL)
        # the decode route (plain _sdpa over the cache) against the prefill
        # route (K8) of the port itself: the reference decode test's bound
        assert float((got[:, 0] - fwd[:, t]).abs().max()) < 2e-2


def test_prefill_equals_forward_and_returns_an_empty_cache():
    cfg, ref_model, rp, model, p = _models("qwen2-72b")
    tokens = _tokens(cfg, 2, 12)
    scfg = serve_mod.ServeConfig(max_len=32)
    logits, cache = serve_mod.make_prefill(model, scfg)(p, _t(tokens))
    fwd, _ = model.forward(p, _t(tokens))
    assert torch.equal(logits, fwd)
    assert logits.shape == (2, 12, cfg.padded_vocab)
    rlogits, rcache = ref_serve.make_prefill(ref_model, ref_serve.ServeConfig(
        max_len=32))(rp, jnp.asarray(tokens))
    np.testing.assert_allclose(_np(logits), rlogits, **MODEL)
    assert len(cache["layers"]) == cfg.num_layers
    k = cache["layers"][0]["k"]
    assert k.shape == rcache["groups"]["sub0"]["k"].shape[1:]
    assert not k.any()


def test_greedy_generate_equals_the_reference():
    cfg, ref_model, rp, model, p = _models("qwen2-72b", seed=2)
    prompt = _tokens(cfg, 2, 6, seed=2)
    scfg = serve_mod.ServeConfig(max_len=16)
    want = ref_serve.generate(ref_model, rp, jnp.asarray(prompt), 8,
                              ref_serve.ServeConfig(max_len=16))
    got = serve_mod.generate(model, p, _t(prompt), 8, scfg)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    next_tok, logits, _ = serve_mod.make_decode_step(model)(
        p, model.init_cache(p, 2, 16), _t(prompt[:, :1]), 0)
    assert torch.equal(next_tok, logits[:, -1:].argmax(-1).to(torch.int32))


def test_temperature_sampling_draws_from_the_generator():
    cfg, _, _, model, p = _models("qwen2-72b")
    prompt = _t(_tokens(cfg, 2, 4))
    scfg = serve_mod.ServeConfig(temperature=1.0, max_len=12)
    a, b = (serve_mod.generate(model, p, prompt, 8, scfg,
                               gen=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, 12)
    assert torch.equal(a[:, :4], prompt)
    assert bool(((a >= 0) & (a < cfg.padded_vocab)).all())


def test_unported_architectures_are_refused_by_name():
    # none is refused any more: build_model builds every one of the ten
    # configs, at its published widths and reduced
    assert len(ARCHS) == 10
    for arch in ARCHS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            model = build_model(cfg, CPU)
            assert isinstance(model, WhisperModel) == (cfg.family == "audio")
            if not isinstance(model, WhisperModel):  # cross and shared
                # blocks come on top of the config's layers
                assert sum(k not in ("cross", "shared_attn")
                           for k in model.kinds) == cfg.num_layers


def test_bf16_params_cross_through_their_bits():
    cfg = dataclasses.replace(ref_get_config("qwen2-72b").reduced(),
                              dtype="bfloat16", num_layers=2)
    rp = ref_build_model(cfg).init(jax.random.PRNGKey(3))
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), cfg, CPU)
    w = p["layers"][1]["attn"]["wq"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(rp["groups"]["sub0"]["attn"]["wq"]["w"][1], np.float32))


def test_make_batch_and_init_are_seeded():
    cfg = get_config("qwen2-72b").reduced()
    a, b = (make_batch(cfg, 2, 8, torch.Generator().manual_seed(4))
            for _ in range(2))
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    model = build_model(cfg, CPU)
    p1, p2 = (model.init(torch.Generator().manual_seed(6)) for _ in range(2))
    assert torch.equal(p1["layers"][1]["ffn"]["w_up"]["w"],
                       p2["layers"][1]["ffn"]["w_up"]["w"])
    assert p1["layers"][0]["attn"]["wq"]["b"].shape == (cfg.num_heads * 32,)


def test_serve_cli_on_the_cpu(capsys):
    before = dict(fk.LAUNCHES)
    out = launch_serve.main(["--arch", "qwen2-72b", "--reduced", "--batch",
                             "2", "--prompt-len", "4", "--gen", "4",
                             "--device", "cpu"])
    assert out.shape == (2, 8)
    assert "[serve] qwen2-72b on cpu" in capsys.readouterr().out
    assert fk.LAUNCHES == before
