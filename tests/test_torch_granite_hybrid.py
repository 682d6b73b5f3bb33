"""Granite 4.0-H on the port (``configs/granite_4_0_h_small.py``, the
port's own: the reference package has no such model) against the plain
reference of the benchmark (``perfbench/reference/granite_hybrid.py``).

On the CPU in f32, at a reduced size: two periods of a pattern of one
Mamba-2 and one NoPE attention layer, 8 experts top-2 beside a shared
expert twice an expert's width, chunks of 16, Granite's four scalars;
seeded weights with Mamba-2's published init of ``a_log`` and
``dt_bias`` and random ``conv_b`` and ``d_skip`` (at ``init``'s
constants a slip in the decay or the skip would pass).  The program runs
through ``registry.build_model`` and ``serve/step.py``; the reference
computes its SSD at chunks of 64 by the segment-sum algorithm.

Bounds: 1e-4 (rtol and atol) for a whole model's logits, the bound of
``tests/test_torch_lm.py``; 1e-5 (atol scaled to max |ref|) for the SSD
alone against the reference package's product form, the module bound of
``tests/test_torch_ssm.py``.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.kinds.hybrid_prefill import mamba_init  # noqa: E402
from perfbench.reference import granite_hybrid as ref  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import PortConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.models import layers, mamba2, registry  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402
from repro_torch.serve import step as serve_step  # noqa: E402

MODEL = dict(rtol=1e-4, atol=1e-4)
MODULE = 1e-5
CHUNK = 16


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# -- the configuration -------------------------------------------------------


def test_config_has_the_published_sizes():
    cfg = get_config("granite-4.0-h-small")
    assert isinstance(cfg, PortConfig) and "granite-4.0-h-small" not in ARCHS
    assert "granite-4.0-h-small" in PORT_ARCHS
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim) == (40, 4096, 32, 8, 128)
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.num_experts, cfg.top_k, cfg.d_expert, cfg.d_shared) == (
        72, 10, 768, 1536)
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk) == (128, 64, 256)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling, cfg.norm_eps,
            cfg.nope) == (12.0, 0.22, 0.0078125, 16.0, 1e-5, True)
    assert (cfg.vocab_size, cfg.tie_embeddings) == (100352, True)


def test_parameter_counts_equal_the_model_layout():
    """32.2 B parameters, 8.8 B a token (the published 32B-A9B); the
    counts equal the leaves ``init`` lays out on the meta device."""
    cfg = get_config("granite-4.0-h-small")
    model = registry.build_model(cfg, "meta")
    assert model.plan.group_kinds == ("mamba_ffn",) * 5 + ("attn",) + (
        "mamba_ffn",) * 4 and model.plan.n_groups == 4
    params = model.init(layers.MetaGenerator())
    n = sum(t.numel() for t in _leaves(params))
    assert cfg.param_count() == n == 32_207_337_984
    assert round(cfg.active_param_count() / 1e9, 1) == 8.8


def test_the_other_configurations_keep_the_defaults():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert type(cfg).__name__ == "ModelConfig"
        assert (cfg.layer_types, cfg.d_shared, cfg.embedding_multiplier,
                cfg.residual_multiplier, cfg.attention_multiplier,
                cfg.logits_scaling, cfg.norm_eps, cfg.nope) == (
            (), 0, 1.0, 1.0, 0.0, 1.0, 1e-6, False)


def test_reduced_keeps_both_kinds_in_two_periods():
    small = get_config("granite-4.0-h-small").reduced()
    assert small.layer_types == ("mamba", "attention") * 2
    assert small.num_layers == 4 and small.d_shared == 2 * small.d_expert
    plan = registry.build_model(small, "cpu").plan
    assert plan.group_kinds == ("mamba_ffn", "attn") and plan.n_groups == 2


# -- the model against the plain reference ----------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _small(capacity_factor: float = 1.25) -> PortConfig:
    return dataclasses.replace(
        get_config("granite-4.0-h-small").reduced(), d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_expert=32, d_shared=64,
        vocab_size=500, ssm_state=16, ssm_head_dim=16, ssm_chunk=CHUNK,
        moe_capacity_factor=capacity_factor)


def _port_section(cfg: PortConfig) -> dict:
    """The configuration as a benchmark file's ``port`` section."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _weights(cfg: PortConfig, seed: int = 7):
    model = registry.build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    mamba_init(params, gen)
    for p in params["layers"]:
        if "ssm" in p:
            ssm = p["ssm"]
            ssm["conv_b"] = 0.1 * torch.randn(ssm["conv_b"].shape,
                                              generator=gen)
            ssm["d_skip"] = torch.randn(ssm["d_skip"].shape, generator=gen)
    return model, params


def _tokens(cfg, b, t, seed=11):
    return torch.randint(0, cfg.vocab_size, (b, t), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def _reference_logits(cfg, params, tokens):
    arch = ref.Arch.from_config(_port_section(cfg))
    with ref_model.exact_f32():
        h, _ = ref.hidden(params, tokens, arch, ref_model.F32)
        return ref.logits(params, h, arch, ref_model.F32)


@pytest.mark.parametrize("t", [2 * CHUNK, 3 * CHUNK + 5, 5])
def test_prefill_logits_equal_the_reference(t):
    """Through ``make_prefill``: a whole number of chunks, a ragged last
    chunk, and fewer tokens than one chunk; the capacity drops rows (the
    reference drops the same ones)."""
    cfg = _small()
    model, params = _weights(cfg)
    tokens = _tokens(cfg, 2, t)
    prefill = serve_step.make_prefill(model, serve_step.ServeConfig(
        max_len=t))
    with torch.no_grad():
        logits, cache = prefill(params, tokens)
    want = _reference_logits(cfg, params, tokens)
    torch.testing.assert_close(logits, want, **MODEL)
    kinds = [c.keys() for c in cache["layers"]]
    assert kinds == [{"h", "conv"}, {"k", "v"}] * 2


def test_decode_steps_equal_the_reference_forward():
    """Token by token from an empty cache, at a capacity factor of E,
    where no row drops in a step of two tokens or in the forward."""
    cfg = _small(capacity_factor=8.0)
    model, params = _weights(cfg)
    t = CHUNK + 7
    tokens = _tokens(cfg, 2, t)
    cache = model.init_cache(params, 2, t)
    steps = []
    with torch.no_grad():
        for i in range(t):
            logits, cache = model.decode_step(params, tokens[:, i:i + 1],
                                              cache, pos=i)
            steps.append(logits)
    want = _reference_logits(cfg, params, tokens)
    torch.testing.assert_close(torch.cat(steps, 1), want, **MODEL)


def test_attention_layers_take_k8_with_the_config_scale(monkeypatch):
    cfg = _small()
    model, params = _weights(cfg)
    seen = []
    real = fk.flash_attention_launch

    def launch(q, k, v, **kw):
        seen.append(kw)
        return real(q, k, v, **kw)
    monkeypatch.setattr(fk, "flash_attention_launch", launch)
    with torch.no_grad():
        model.forward(params, _tokens(cfg, 1, 24))
    assert seen == [{"causal": True, "group": 2,
                     "scale": cfg.attention_multiplier}] * 2


def test_k8_plain_version_takes_a_scale():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 9, 16, generator=gen) for _ in range(3))
    got = fk.flash_attention_launch(q, k[:, :2], v[:, :2], group=2,
                                    scale=0.0078125)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :2].repeat_interleave(2, 1))
    s = (s * 0.0078125).masked_fill(
        torch.ones(9, 9, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.softmax(s, -1) @ v[:, :2].repeat_interleave(2, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        fk.flash_attention_launch(q, k, v),
        fk.flash_attention_launch(q, k, v, scale=16 ** -0.5), rtol=0, atol=0)


# -- the stable SSD ------------------------------------------------------------


def _ssd_inputs(t, h, dt_value, a_value, seed=0):
    rng = np.random.default_rng(seed)
    p, n = 8, 8
    x = rng.standard_normal((1, t, h, p)).astype(np.float32)
    dt = np.full((1, t, h), dt_value, np.float32) * rng.uniform(
        0.5, 1.5, (1, t, h)).astype(np.float32)
    a = np.full((h,), a_value, np.float32)
    b = rng.standard_normal((1, t, n)).astype(np.float32)
    c = rng.standard_normal((1, t, n)).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("chunk,dt_value,a_value,t", [
    (16, 0.05, -1.0, 48), (16, 0.05, -1.0, 53), (64, 0.02, -0.5, 150),
    (256, 0.001, -1.0, 512)])
def test_stable_ssd_equals_the_product_form_where_it_is_finite(
        chunk, dt_value, a_value, t):
    """The segment-sum decay against the reference package's ``exp(cum_i)
    * exp(-cum_j)``, where the latter does not overflow."""
    args = _ssd_inputs(t, 4, dt_value, a_value)
    want_y, want_h = (np.asarray(v) for v in ref_mamba2._ssd_chunked(
        *(jnp.asarray(v) for v in args), chunk))
    assert np.isfinite(want_y).all()
    y, h = mamba2._ssd_chunked(*(torch.from_numpy(v) for v in args), chunk)
    scale = float(np.abs(want_y).max())
    np.testing.assert_allclose(y.numpy(), want_y, rtol=MODULE,
                               atol=MODULE * scale)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=MODULE,
                               atol=MODULE * float(np.abs(want_h).max()))


@pytest.mark.parametrize("dt_value,a_value", [(0.05, -8.0), (1.3, -np.e)])
def test_stable_ssd_is_finite_where_the_product_form_overflows(dt_value,
                                                               a_value):
    """Chunk 256 at dt 0.05 and A -8 (inside Mamba-2's init) and at the
    benchmark fill's dt 1.3, A -e: the product form's exp(-cum) overflows
    f32; the segment sum stays finite and equals the reference's
    segment-sum algorithm at chunk 64."""
    args = _ssd_inputs(512, 4, dt_value, a_value)
    old = np.asarray(ref_mamba2._ssd_chunked(
        *(jnp.asarray(v) for v in args), 256)[0])
    assert not np.isfinite(old).all()
    x, dt, a, b, c = (torch.from_numpy(v) for v in args)
    y, h = mamba2._ssd_chunked(x, dt, a, b, c, 256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want = ref.ssd(x, dt, a, b, c, chunk=64)
    torch.testing.assert_close(y, want, rtol=MODULE,
                               atol=MODULE * float(want.abs().max()))


def test_stable_ssd_under_autograd_equals_the_in_place_forward():
    args = [torch.from_numpy(v) for v in _ssd_inputs(40, 2, 0.1, -2.0)]
    with torch.no_grad():
        fast, _ = mamba2._ssd_chunked(*args, CHUNK)
    leaves = [v.clone().requires_grad_() for v in args]
    slow, _ = mamba2._ssd_chunked(*leaves, CHUNK)
    torch.testing.assert_close(slow.detach(), fast, rtol=0, atol=0)
    slow.sum().backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all()
               for v in leaves)


# -- spans and the chunk counter ---------------------------------------------


def _chunks() -> float:
    return mamba2.CHUNKS.value()


def test_spans_and_chunk_counter_under_the_profiler():
    cfg = _small()
    model, params = _weights(cfg)
    b, t = 2, 3 * CHUNK + 1
    tokens = _tokens(cfg, b, t)
    before = _chunks()
    with torch.no_grad():
        model.forward(params, tokens)
    assert _chunks() == before                       # counts only profiled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.forward(params, tokens)
    mamba_layers = cfg.layer_types.count("mamba")
    assert _chunks() - before == mamba_layers * b * 4
    events = prof.events()
    names = [e.name for e in events]
    for stage, n in (("ssm", mamba_layers), ("ssm.scan", mamba_layers),
                     ("moe.shared", cfg.num_layers),
                     (mamba2.CHUNK_LOOP, mamba_layers)):
        assert names.count(stage) == n, stage
    # the SSD's chunk loop inside ssm.scan, inside ssm
    loop = next(e for e in events if e.name == mamba2.CHUNK_LOOP)
    assert loop.cpu_parent.name == "ssm.scan"
    assert loop.cpu_parent.cpu_parent.name == "ssm"
    assert telemetry.tracing() is False
