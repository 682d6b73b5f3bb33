"""DeepSeek-V3 on the port (``configs/deepseek_v3.py``, the port's own: the
reference package has no such model) against the plain reference of the
benchmark (``perfbench/reference/deepseek_v3.py``).

On the CPU in f32, at a reduced size that keeps every mechanism: latent
attention with q·k heads of 16 + 8 rotary columns and v heads of 16,
YaRN, one leading dense layer and three MoE layers of 8 experts in two
groups of which the router keeps one, top 2, a shared expert, half the
experts held; seeded weights with a nonzero selection bias.  The program
runs through ``registry.build_model`` and ``serve/step.py``.

Bounds: 1e-4 (rtol and atol) for a whole model's logits, the bound of
``tests/test_torch_lm.py`` and ``tests/test_torch_granite_hybrid.py``:
the program and the reference sum the same f32 products in other orders
(the latent decode absorbs ``wkv_b`` into q, a reassociation).  1e-5
(rtol and atol) for one MoE layer's shares against the whole layer: the
same products, summed in another order.  YaRN's frequencies within
2^-23 (relative) of the float64 closed form: one f32 rounding; their cos
and sin at positions up to 4095 within 2^-22 of the largest angle, plus
1e-6: the angle is an f32 product, rounded at its own magnitude (about
3000 rad).  rtol 1e-12 for the scale, computed in float64 both ways.
2e-6 for K8's plain version against a plain softmax: the same f32
arithmetic in other orders.  The router's choices are compared exactly
and its weights within 1e-6: the same f32 scores choose.
"""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import deepseek_v3 as ref  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import PortConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.models import layers, mla, moe, registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import step as serve_step  # noqa: E402

MODEL = dict(rtol=1e-4, atol=1e-4)
SHARE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- the configuration -------------------------------------------------------


def test_config_has_the_published_sizes():
    cfg = get_config("deepseek-v3")
    assert isinstance(cfg, PortConfig) and "deepseek-v3" not in ARCHS
    assert "deepseek-v3" in PORT_ARCHS
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads) == (61, 7168, 128)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim) == (1536, 512, 128, 64, 128)
    assert (cfg.first_k_dense, cfg.d_ff_dense) == (3, 18432)
    assert (cfg.num_experts, cfg.top_k, cfg.d_expert,
            cfg.num_shared_experts) == (256, 8, 2048, 1)
    assert (cfg.router, cfg.n_group, cfg.topk_group, cfg.routed_scale) == (
        "sigmoid", 8, 4, 2.5)
    assert (cfg.rope_theta, cfg.rope_factor, cfg.rope_original_max,
            cfg.beta_fast, cfg.beta_slow, cfg.mscale_all_dim) == (
                1e4, 40.0, 4096, 32.0, 1.0, 1.0)
    assert (cfg.vocab_size, cfg.tie_embeddings, cfg.norm_eps) == (
        129280, False, 1e-6)
    assert (cfg.experts_held, cfg.expert_offset) == (0, 0)  # every expert


def test_the_other_configurations_keep_the_defaults():
    fields = ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "first_k_dense",
              "d_ff_dense", "router", "n_group", "topk_group", "routed_scale",
              "rope_factor", "rope_original_max", "experts_held",
              "expert_offset")
    want = (0, 0, 0, 0, 0, 0, 0, "softmax", 1, 1, 1.0, 1.0, 0, 0, 0)
    for arch in [*ARCHS, *PORT_ARCHS]:
        if arch == "deepseek-v3":
            continue
        cfg = get_config(arch)
        if isinstance(cfg, PortConfig):
            assert tuple(getattr(cfg, f) for f in fields) == want, arch
        else:       # the reference's fields, one for one
            assert not any(hasattr(cfg, f) for f in fields), arch
        mcfg = transformer._moe_cfg(cfg)
        assert type(mcfg) is moe.MoEConfig, arch


def test_parameter_counts_equal_the_model_layout():
    """671.0 B parameters, 37.6 B a token (the published 671B-A37B); the
    counts equal the leaves ``init`` lays out on the meta device, and so
    do the benchmark's 32 layers holding 8 experts each (20.58 B)."""
    cfg = get_config("deepseek-v3")
    cut = dataclasses.replace(cfg, num_layers=32, experts_held=8)
    for c, want in ((cfg, 671_026_419_200), (cut, 20_578_056_448)):
        model = registry.build_model(c, "meta")
        params = model.init(layers.MetaGenerator())
        assert c.param_count() == sum(t.numel() for t in _leaves(params)) \
            == want
    assert round(cfg.active_param_count() / 1e9, 1) == 37.6
    kinds = registry.build_model(cut, "meta").kinds
    assert kinds == ("mla_dense",) * 3 + ("mla_moe",) * 29


def test_reduced_keeps_every_mechanism():
    small = get_config("deepseek-v3").reduced()
    assert small.first_k_dense == 1 and small.num_layers == 4
    assert small.qk_nope_head_dim + small.qk_rope_head_dim != \
        small.v_head_dim
    assert small.n_group == 2 and small.topk_group == 1
    assert small.experts_held == small.num_experts // 2
    assert small.rope_factor == 40.0
    assert registry.build_model(small, "cpu").kinds == (
        "mla_dense",) + ("mla_moe",) * 3


# -- the model against the plain reference ----------------------------------


def _small(capacity_factor: float = 1.25, **over) -> PortConfig:
    return dataclasses.replace(get_config("deepseek-v3").reduced(),
                               d_model=64, d_expert=32, d_ff_dense=96,
                               vocab_size=500,
                               moe_capacity_factor=capacity_factor, **over)


def _port_section(cfg: PortConfig) -> dict:
    """The configuration as a benchmark file's ``port`` section."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _weights(cfg: PortConfig, seed: int = 7):
    """Seeded weights with a selection bias of 0.05 a normal draw and
    norm scales away from 1."""
    model = registry.build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for p in params["layers"]:
        if "score_bias" in p["ffn"]:
            p["ffn"]["score_bias"] = 0.05 * torch.randn(cfg.num_experts,
                                                        generator=gen)
        for norm in ("q_norm", "kv_norm"):
            scale = p["attn"][norm]["scale"]
            p["attn"][norm]["scale"] = 1 + 0.2 * torch.randn(
                scale.shape, generator=gen)
    return model, params


def _tokens(cfg, b, t, seed=11):
    return torch.randint(0, cfg.vocab_size, (b, t), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def _reference_logits(cfg, params, tokens):
    arch = ref.Arch.from_config(_port_section(cfg))
    with ref_model.exact_f32():
        h = ref.hidden(params, tokens, arch, ref_model.F32)
        return ref.logits(params, h, ref_model.F32)


@pytest.mark.parametrize("t", [37, 64])
def test_prefill_logits_equal_the_reference(t):
    """Through ``make_prefill``, at two lengths; the capacity drops rows
    (the reference drops the same ones); the fresh cache is the latent."""
    cfg = _small()
    model, params = _weights(cfg)
    tokens = _tokens(cfg, 2, t)
    prefill = serve_step.make_prefill(model, serve_step.ServeConfig(
        max_len=t))
    with torch.no_grad():
        logits, cache = prefill(params, tokens)
    want = _reference_logits(cfg, params, tokens)
    torch.testing.assert_close(logits, want, **MODEL)
    assert [set(c) for c in cache["layers"]] == [{"c_kv", "k_pe"}] * 4
    assert cache["layers"][0]["c_kv"].shape == (2, t, cfg.kv_lora_rank)


def test_decode_steps_through_the_latent_cache_equal_the_reference():
    """Token by token from an empty cache, at a capacity factor of E,
    where no row drops in a step of two tokens or in the forward."""
    cfg = _small(capacity_factor=8.0)
    model, params = _weights(cfg)
    t = 23
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


def test_generate_runs_through_the_latent_cache():
    cfg = _small(capacity_factor=8.0)
    model, params = _weights(cfg)
    out = serve_step.generate(model, params, _tokens(cfg, 2, 5), 4,
                              serve_step.ServeConfig(max_len=9))
    assert out.shape == (2, 9)


# -- YaRN ---------------------------------------------------------------------


def _yarn_closed_form(dim, theta, factor, original, fast, slow):
    """YaRN's frequencies as DeepSeek's ``precompute_freqs_cis`` writes
    them, in float64, entry by entry."""
    def corr(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) / (
            2 * math.log(theta))
    low = max(math.floor(corr(fast)), 0)
    high = min(math.ceil(corr(slow)), dim - 1)
    out = []
    for i in range(dim // 2):
        f = theta ** (-2 * i / dim)
        ramp = min(max((i - low) / ((high - low) or 0.001), 0.0), 1.0)
        out.append(f / factor * ramp + f * (1 - ramp))
    return out


@pytest.mark.parametrize("dim", [64, 8])
def test_yarn_angles_and_scale_equal_the_closed_form(dim):
    """Frequencies below the ramp kept, above it divided by 40, between a
    linear mix; the softmax scale 192^-0.5 (0.1 ln 40 + 1)^2."""
    want = _yarn_closed_form(dim, 1e4, 40.0, 4096, 32.0, 1.0)
    assert want[0] == 1.0 and math.isclose(want[-1], 1e4 ** (
        -(dim - 2) / dim) / 40, rel_tol=1e-12)
    freq = layers._yarn_freq(dim, 1e4, 40.0, 4096, 32.0, 1.0, "cpu")
    torch.testing.assert_close(freq.double(), torch.tensor(
        want, dtype=torch.float64), rtol=2.0 ** -23, atol=0)
    pos = torch.tensor([0, 1, 17, 4095])
    cos, sin = layers.yarn_angles(pos, dim, 1e4, 40.0, 4096, 32.0, 1.0)
    ang = torch.tensor([[p * f for f in want] for p in pos.tolist()],
                       dtype=torch.float64)
    tol = 2.0 ** -22 * float(ang.abs().max()) + 1e-6
    torch.testing.assert_close(cos.double(), ang.cos(), rtol=0, atol=tol)
    torch.testing.assert_close(sin.double(), ang.sin(), rtol=0, atol=tol)
    torch.testing.assert_close(cos[:2].double(), ang[:2].cos(), rtol=0,
                               atol=1e-6)
    cfg = transformer._mla_cfg(get_config("deepseek-v3"))
    m = 0.1 * math.log(40.0) + 1.0
    assert math.isclose(cfg.scale, 192 ** -0.5 * m * m, rel_tol=1e-12)
    assert round(cfg.scale, 5) == 0.13523


def test_rotation_pairs_adjacent_columns():
    """(x_2i, x_2i+1) turn together, as a complex product."""
    x = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(0))
    cos, sin = layers.yarn_angles(torch.arange(5), 8, 1e4, 40.0, 4096,
                                  32.0, 1.0)
    got = layers.apply_rope_pairs(x, cos, sin)
    z = torch.view_as_complex(x.unflatten(-1, (4, 2)).contiguous())
    want = torch.view_as_real(z * torch.polar(torch.ones_like(cos),
                                              torch.atan2(sin, cos)))
    torch.testing.assert_close(got, want.flatten(-2), rtol=1e-6, atol=1e-6)


# -- the sigmoid group-limited router -----------------------------------------


def _router_loop(w, bias, x, cfg):
    """Token by token, in plain Python over the scores."""
    e, g = cfg.num_experts, cfg.n_group
    per = e // g
    gates, ids = [], []
    for row in x:
        s = torch.sigmoid(row @ w).tolist()
        c = [s[j] + float(bias[j]) for j in range(e)]
        group = [sum(sorted(c[i * per:(i + 1) * per])[-2:])
                 for i in range(g)]
        kept = sorted(range(g), key=lambda i: (-group[i], i))[
            :cfg.topk_group]
        allowed = [j for j in range(e) if j // per in kept]
        chosen = sorted(allowed, key=lambda j: (-c[j], j))[:cfg.top_k]
        total = sum(s[j] for j in chosen)
        ids.append(chosen)
        gates.append([s[j] / total * cfg.routed_scale for j in chosen])
    return torch.tensor(gates), torch.tensor(ids, dtype=torch.int32)


def _router(n_group=4, topk_group=2, e=16, k=3):
    return moe.PortMoEConfig(d_model=12, d_expert=4, num_experts=e,
                             top_k=k, router="sigmoid", n_group=n_group,
                             topk_group=topk_group, routed_scale=2.5)


def test_sigmoid_router_equals_a_per_token_loop():
    cfg = _router()
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(12, 16, generator=gen)
    bias = 0.3 * torch.randn(16, generator=gen)
    x = torch.randn(40, 12, generator=gen)
    gates, ids, aux = moe.route({"router": {"w": w}, "score_bias": bias},
                                x, cfg)
    want_gates, want_ids = _router_loop(w, bias, x, cfg)
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(gates, want_gates, rtol=1e-6, atol=1e-6)
    assert float(aux) == 0.0


def test_the_bias_chooses_and_does_not_weigh():
    """A bias on expert 5 alone makes the router choose it (it would
    not), while its weight stays its unbiased score's share."""
    cfg = _router(n_group=1, topk_group=1, e=8, k=2)
    w = torch.zeros(12, 8)
    w[0] = torch.tensor([3.0, 2.0, 1.0, 0.0, -1.0, -2.0, -3.0, -4.0])
    x = torch.zeros(1, 12)
    x[0, 0] = 1.0
    p = {"router": {"w": w}, "score_bias": torch.zeros(8)}
    _, ids, _ = moe.route(p, x, cfg)
    assert ids.tolist() == [[0, 1]]
    p["score_bias"] = torch.zeros(8).index_fill_(0, torch.tensor([5]), 1.0)
    gates, ids, _ = moe.route(p, x, cfg)
    assert ids.tolist() == [[5, 0]]
    s = torch.sigmoid(w[0])
    want = torch.stack([s[5], s[0]]) / (s[5] + s[0]) * 2.5
    torch.testing.assert_close(gates[0], want)
    torch.testing.assert_close(gates, _router_loop(w, p["score_bias"], x,
                                                   cfg)[0])


def test_the_group_limit_changes_the_choice():
    """Expert 1's group (0, 1) holds the best single score but the worse
    pair: with one group of two kept, the router takes the other group's
    two, where without the limit it would take expert 1."""
    scores = torch.tensor([0.0, 5.0, 3.0, 3.0])   # logits: sigmoid keeps order
    w = torch.zeros(12, 4)
    w[0] = scores
    x = torch.zeros(1, 12)
    x[0, 0] = 1.0
    p = {"router": {"w": w}, "score_bias": torch.zeros(4)}
    free = moe.route(p, x, _router(n_group=1, topk_group=1, e=4, k=2))[1]
    limited = moe.route(p, x, _router(n_group=2, topk_group=1, e=4, k=2))[1]
    assert free.tolist() == [[1, 2]]
    assert limited.tolist() == [[2, 3]]
    cfg = _router(n_group=2, topk_group=1, e=4, k=2)
    assert torch.equal(limited, _router_loop(w, torch.zeros(4), x, cfg)[1])


# -- the expert share ------------------------------------------------------


def test_shares_add_up_to_the_whole_layer():
    """At a capacity that drops rows: each card's layer (its experts'
    part plus the shared expert) over the same tokens, with the shared
    expert counted once, adds up to the reference's whole layer of all E
    experts; K7 counts no row of another card's experts."""
    e, held = 8, 2
    base = moe.PortMoEConfig(d_model=32, d_expert=16, num_experts=e,
                             top_k=2, num_shared_experts=1, router="sigmoid",
                             n_group=2, topk_group=1, routed_scale=2.5,
                             capacity_factor=1.0, dtype="float32")
    whole = moe.init(torch.Generator().manual_seed(5), base)
    gen = torch.Generator().manual_seed(6)
    whole["score_bias"] = 0.05 * torch.randn(e, generator=gen)
    x = torch.randn(50, 32, generator=gen)
    arch = ref.Arch.from_config(dict(
        _port_section(_small()), num_experts=e, experts_held=e,
        expert_offset=0, top_k=2, n_group=2, topk_group=1,
        moe_capacity_factor=1.0))
    with torch.no_grad(), ref_model.exact_f32():
        want = ref.moe(whole, x, arch, ref_model.F32)
        shared = ref.mlp(whole["shared"], x, ref_model.F32)
        parts = []
        for offset in range(0, e, held):
            cfg = dataclasses.replace(base, experts_held=held,
                                      expert_offset=offset)
            p = dict(whole, **{k: whole[k][offset:offset + held]
                               for k in ("w_gate", "w_up", "w_down")})
            parts.append(moe.apply_local(p, x, cfg)[0])
    total = sum(parts) - (len(parts) - 1) * shared
    torch.testing.assert_close(total, want, **SHARE)
    # the shares drop rows: the whole layer's capacity, int(50 * 2 / 8)
    flat = moe.route(whole, x, base)[1].reshape(-1)
    assert int(torch.bincount(flat.long(), minlength=e).max()) > int(
        50 * 2 / e)


def test_a_share_holds_its_experts_alone():
    cfg = _small()
    assert cfg.experts_held == 4
    params = registry.build_model(cfg, "meta").init(layers.MetaGenerator())
    ffn = params["layers"][1]["ffn"]
    assert ffn["w_gate"].shape[0] == 4 and ffn["router"]["w"].shape[1] == 8
    assert ffn["score_bias"].shape == (8,)
    assert set(params["layers"][0]["ffn"]) == {"w_gate", "w_up", "w_down"}


# -- spans and K8 at two head sizes ----------------------------------------


def test_spans_under_the_profiler():
    cfg = _small()
    model, params = _weights(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.forward(params, _tokens(cfg, 2, 20))
    events = prof.events()
    names = [e.name for e in events]
    assert names.count("mla") == names.count("mla.attend") == cfg.num_layers
    assert names.count("moe.shared") == cfg.num_layers - cfg.first_k_dense
    core = next(e for e in events if e.name == "mla.attend")
    assert core.cpu_parent.name == "mla"
    k8 = [e for e in events if e.name == "repro_torch::flash_attention"]
    assert len(k8) == cfg.num_layers
    assert all(e.cpu_parent.name == "mla.attend" for e in k8)


def test_prefill_attention_runs_k8_at_two_head_sizes(monkeypatch):
    cfg = _small()
    model, params = _weights(cfg)
    seen = []
    real = fk.flash_attention_launch

    def launch(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(fk, "flash_attention_launch", launch)
    with torch.no_grad():
        model.forward(params, _tokens(cfg, 1, 24))
    scale = transformer._mla_cfg(cfg).scale
    assert seen == [(24, 24, 16, {"causal": True, "group": 1,
                                  "scale": scale})] * cfg.num_layers


@pytest.mark.parametrize("causal", [True, False])
def test_k8_plain_version_at_two_head_sizes(causal):
    """q and k at 24, v at 16: the plain version (the CPU route of
    ``repro_torch::flash_attention``) against a softmax written out; the
    fake implementation gives v's head size."""
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(2, 3, 11, 24, generator=gen) for _ in range(2))
    v = torch.randn(2, 3, 11, 16, generator=gen)
    got = fk.flash_attention_launch(q, k, v, causal=causal, scale=0.2)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.2
    if causal:
        s = s.masked_fill(torch.ones(11, 11, dtype=torch.bool).triu(1),
                          float("-inf"))
    torch.testing.assert_close(got, torch.softmax(s, -1) @ v, rtol=2e-6,
                               atol=2e-6)
    meta = fk.flash_attention_launch(q.to("meta"), k.to("meta"),
                                     v.to("meta"))
    assert meta.shape == (2, 3, 11, 16)


def test_attention_under_grad_takes_the_plain_route():
    """K8 has no backward at (q·k, v) = (24, 16): the core runs ``_sdpa``
    and the gradient reaches q's projection."""
    cfg = _small()
    model, params = _weights(cfg)
    w = params["layers"][0]["attn"]["wq_b"]["w"].requires_grad_()
    before = fk.LAUNCHES["flash_attention"]
    loss, _ = model.loss(params, {"tokens": _tokens(cfg, 1, 12),
                                  "labels": _tokens(cfg, 1, 12)})
    loss.backward()
    assert fk.LAUNCHES["flash_attention"] == before
    assert w.grad is not None and bool(w.grad.abs().sum() > 0)
    with pytest.raises(ValueError, match="one head_dim"):
        fk.flash_attention_autograd(torch.zeros(1, 1, 4, 24),
                                    torch.zeros(1, 1, 4, 24),
                                    torch.zeros(1, 1, 4, 16))


def test_latent_cache_holds_576_values_a_token():
    cfg = transformer._mla_cfg(get_config("deepseek-v3"))
    cache = mla.init_cache(cfg, 1, 3, device="meta")
    assert sum(t.shape[-1] for t in cache.values()) == 576
