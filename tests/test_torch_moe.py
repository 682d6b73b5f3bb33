"""The port's MoE layer and MoE serving against the reference's.

``repro_torch.models.moe`` against ``repro.models.moe`` on the same
seeded numpy inputs and on the reference's parameters (initialised by
``jax.random``, carried across as numpy), in f32 on the CPU, where K7's
and K5's launchers run their plain versions.  Bounds: ids, counts and
tokens equal; 1e-6 for the router and the expert rows (one f32 product or
two); 1e-5 for the layer's output (its combine sums in another order);
1e-4 for a whole model's logits and aux loss (the bound of
``tests/test_torch_lm.py``, the reference's own prefill test).
"""

import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.registry import build_model as ref_build_model
from repro.serve import step as ref_serve
from repro_torch import convert
from repro_torch.analysis import InstrumentedKernelProvider, Session
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.serve import step as serve_mod

from _port_compare import load_example

CPU = "cpu"
ROUTER = dict(rtol=1e-6, atol=1e-6)
LAYER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ("qwen3-moe-235b-a22b", "granite-moe-1b-a400m")


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params(tree):
    if isinstance(tree, dict):
        return {k: _params(v) for k, v in tree.items()}
    return _t(tree)


def _layer(capacity_factor=8.0, shared=0, d=32, f=16, e=8, k=2, seed=0):
    """Reference config and params, the port's config and the same params."""
    kw = dict(d_model=d, d_expert=f, num_experts=e, top_k=k,
              num_shared_experts=shared, capacity_factor=capacity_factor,
              dtype="float32")
    rcfg = ref_moe.MoEConfig(**kw)
    rp = ref_moe.init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, moe.MoEConfig(**kw), rp, _params(rp)


def _x(t, d, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((t, d)) * scale
            ).astype(np.float32)


def _count_launchers(monkeypatch):
    """Record K7's and K5's launcher calls (their plain versions run)."""
    calls = {"bincount": [], "scatter_add": []}
    k7, k5 = sk.bincount_launch, sk.scatter_add_launch

    def bincount(ids, num_segments):
        out = k7(ids, num_segments)
        calls["bincount"].append((ids, num_segments, out))
        return out

    def scatter_add(values, ids, num_segments):
        out = k5(values, ids, num_segments)
        calls["scatter_add"].append((values, ids, num_segments, out))
        return out

    monkeypatch.setattr(sk, "bincount_launch", bincount)
    monkeypatch.setattr(sk, "scatter_add_launch", scatter_add)
    return calls


# -- the layer's parts -------------------------------------------------------


def test_config_matches_the_reference():
    rcfg, cfg, _, _ = _layer()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    for e in (32, 64, 128):
        assert (moe.MoEConfig(8, 4, e, 2).use_ep
                == ref_moe.MoEConfig(8, 4, e, 2).use_ep)


def test_init_shapes_scales_and_seed():
    cfg = moe.MoEConfig(d_model=64, d_expert=32, num_experts=8, top_k=2,
                        num_shared_experts=1, dtype="float32")
    rcfg = ref_moe.MoEConfig(**dataclasses.asdict(cfg))
    p1, p2 = (moe.init(torch.Generator().manual_seed(3), cfg)
              for _ in range(2))
    rp = ref_moe.init(jax.random.PRNGKey(0), rcfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), rp)
    assert jax.tree.map(lambda a: tuple(a.shape), p1,
                        is_leaf=lambda a: isinstance(a, torch.Tensor)) \
        == shapes
    assert torch.equal(p1["w_up"], p2["w_up"])
    # truncated normal at the fan-in scales: |w| <= 2 scale
    assert float(p1["w_gate"].abs().max()) <= 2 * 64 ** -0.5 + 1e-7
    assert float(p1["w_down"].abs().max()) <= 2 * 32 ** -0.5 + 1e-7
    assert 0.5 < float(p1["w_gate"].std()) / 64 ** -0.5 < 1.0


@pytest.mark.parametrize("zero_router", [False, True])
def test_route_matches_the_reference(zero_router):
    """ids equal, gates and aux within 1e-6; a zero router makes every
    probability equal, where the lower expert must win each tie as in
    ``jax.lax.top_k``."""
    rcfg, cfg, rp, p = _layer()
    if zero_router:
        rp = dict(rp, router={"w": jnp.zeros_like(rp["router"]["w"])})
        p = dict(p, router={"w": torch.zeros_like(p["router"]["w"])})
    x = _x(64, cfg.d_model)
    rg, rids, raux = ref_moe.route(rp, jnp.asarray(x), rcfg)
    gates, ids, aux = moe.route(p, _t(x), cfg)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(_np(ids), np.asarray(rids))
    np.testing.assert_allclose(_np(gates), rg, **ROUTER)
    np.testing.assert_allclose(float(aux), float(raux), **ROUTER)
    if zero_router:
        assert (_np(ids) == np.arange(cfg.top_k)).all()


@pytest.mark.parametrize("capacity", [2, 5, 40])
def test_expert_ffn_grouped_matches_the_reference(capacity):
    """A routed, expert-sorted stream at capacities that drop most rows,
    some rows and none."""
    rcfg, cfg, rp, p = _layer()
    x = _x(20, cfg.d_model)
    _, rids, _ = ref_moe.route(rp, jnp.asarray(x), rcfg)
    flat = np.asarray(rids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    xs = np.repeat(x, cfg.top_k, axis=0)[order]
    sids = flat[order].astype(np.int32)
    want = ref_moe._expert_ffn_grouped(rp, jnp.asarray(xs), jnp.asarray(sids),
                                       cfg.num_experts, capacity, rcfg, None)
    got = moe._expert_ffn_grouped(p, _t(xs), _t(sids), cfg.num_experts,
                                  capacity, cfg)
    np.testing.assert_allclose(_np(got), want, **ROUTER)
    counts = np.bincount(sids, minlength=cfg.num_experts)
    kept = int(np.minimum(counts, capacity).sum())
    assert int((_np(got) != 0).any(axis=1).sum()) == kept


def test_collapsed_stream_keeps_exactly_capacity_rows():
    """The reference's own drop case (``tests/test_optim_serve_misc.py``):
    every row wants expert 0, so the first ``capacity`` rows are kept."""
    kw = dict(d_model=16, d_expert=8, num_experts=4, top_k=1,
              capacity_factor=0.5, dtype="float32")
    rcfg = ref_moe.MoEConfig(**kw)
    rp = ref_moe.init(jax.random.PRNGKey(0), rcfg)
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 16),
                                      jnp.float32))
    ids = np.zeros(32, np.int32)
    want = ref_moe._expert_ffn_grouped(rp, jnp.asarray(xs), jnp.asarray(ids),
                                       4, 4, rcfg, None)
    got = moe._expert_ffn_grouped(_params(rp), _t(xs), _t(ids), 4, 4,
                                  moe.MoEConfig(**kw))
    np.testing.assert_allclose(_np(got), want, **ROUTER)
    nonzero = (np.abs(_np(got)) > 1e-9).any(axis=1)
    assert int(nonzero.sum()) == 4 and nonzero[:4].all()
    np.testing.assert_array_equal(_np(got)[4:], 0.0)


def _slot_oracle(sorted_ids, groups, capacity):
    """First come, first served in stream order: (slot, kept), the spare
    ``groups * capacity`` for a dropped row or an id past the groups."""
    seen = np.zeros(groups, np.int64)
    slot = np.full(len(sorted_ids), groups * capacity, np.int64)
    for i, g in enumerate(sorted_ids):
        if g < groups:
            if seen[g] < capacity:
                slot[i] = g * capacity + seen[g]
            seen[g] += 1
    return slot, slot < groups * capacity


def _zipf_ids(n, e, seed):
    """An ascending expert stream, skewed towards the low experts."""
    p = 1.0 / np.arange(1, e + 1) ** 1.3
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(e, n, p=p / p.sum())).astype(np.int32)


@pytest.mark.parametrize("case", [
    "drops_most", "drops_some", "drops_none", "ids_past_the_groups",
    "by_rank"])
def test_slot_map_matches_a_numpy_oracle(case, monkeypatch):
    """``slot_map`` against first-come positions counted in numpy: at
    capacities that drop most rows, some and none; with ids at or past
    the number of groups sorted last (the EP body's empty send slots,
    whose id is ``e_local``); and grouped by rank, ``id // e_local``, as
    the EP body's send buffers are.  One K7 launch a call."""
    ids = _zipf_ids(96, 8, seed=7)
    groups, capacity = 8, {"drops_most": 2, "drops_some": 14,
                           "drops_none": 96}.get(case, 6)
    if case == "ids_past_the_groups":
        # the last group has room: a past id counted into it would fit
        assert (ids == groups - 1).sum() < capacity
        ids = np.concatenate([ids, np.full(20, groups, np.int32)])
    if case == "by_rank":
        ids, groups = ids // 4, 2            # 8 experts, 4 a rank
    calls = _count_launchers(monkeypatch)
    slot, keep = moe.slot_map(_t(ids), groups, capacity)
    want_slot, want_keep = _slot_oracle(ids, groups, capacity)
    assert slot.dtype == torch.int64 and keep.dtype == torch.bool
    np.testing.assert_array_equal(_np(slot), want_slot)
    np.testing.assert_array_equal(_np(keep), want_keep)
    dropped = int((~want_keep).sum())
    assert (dropped == 0) == (case == "drops_none")
    if case == "drops_most":
        assert dropped > len(ids) // 2
    assert len(calls["bincount"]) == 1
    kept = want_slot[want_keep]
    assert len(np.unique(kept)) == len(kept)        # a slot holds one row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_send_combine_equals_the_gather_by_stream_entry(dtype):
    """The EP body's sender-side combine (``moe.combine_slots`` over the
    rows returned in their send slots) gives K5 bit for bit the values
    and token ids of a gather of the gates through a map from each send
    slot to its stream entry, ``tk`` for an empty one, as the body had
    it; the gates' gradient too.  No process group: two ranks' send
    buffers with rows dropped, the returning rows in ``dtype`` (f32, or
    bf16 as ``bf16_combine`` sends them)."""
    _, cfg, _, p = _layer()
    t, k, ranks = 40, cfg.top_k, 2
    e_local = cfg.num_experts // ranks
    tx = _t(_x(t, cfg.d_model, seed=8))
    gates, ids, _ = moe.route(p, tx, cfg)
    _, order, sorted_ids, _ = moe._sort(tx, ids, k)
    cap = 12                      # of the 40 rows a rank on average
    slot, keep = moe.slot_map(torch.div(sorted_ids, e_local,
                                        rounding_mode="floor"), ranks, cap)
    slots = ranks * cap
    assert 0 < int(keep.sum()) < t * k
    gen = torch.Generator().manual_seed(9)
    back = torch.randn((slots, cfg.d_model), generator=gen).to(dtype)
    w = torch.randn((t, cfg.d_model), generator=gen)

    def gathered(g_in):
        entry = torch.full((slots + 1,), t * k, dtype=torch.int64)
        entry[slot] = order
        entry = entry[:slots]
        g = torch.cat([g_in.reshape(-1), g_in.new_zeros(1)])[entry]
        vals = back.to(torch.float32) * g[:, None]
        return vals, torch.div(entry, k, rounding_mode="floor").to(
            torch.int32)

    results = []
    for make in (gathered,
                 lambda g_in: moe.combine_slots(back, slot, g_in, order, k,
                                                t)):
        g_in = gates.detach().clone().requires_grad_()
        vals, tok = make(g_in)
        (sk.scatter_add_autograd(vals, tok, t) * w).sum().backward()
        results.append((vals.detach(), tok, g_in.grad))
    for want, got in zip(*results):
        assert torch.equal(want, got)
    grad = results[1][2].reshape(-1)
    dropped = torch.zeros(t * k, dtype=torch.bool)
    dropped[order[~keep]] = True
    assert not grad[dropped].any() and grad[~dropped].ne(0).all()
    out = moe.combine(back, slot, gates, order, k, torch.float32)
    assert torch.equal(out, sk.scatter_add_plain(*results[0][:2], t))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("shared", [0, 1])
def test_apply_local_matches_the_reference(capacity_factor, shared):
    """out within 1e-5 and the dispatch ids equal; 1.25 drops rows."""
    rcfg, cfg, rp, p = _layer(capacity_factor, shared)
    x = _x(48, cfg.d_model, seed=3)
    want, raux, rdisp = ref_moe.apply_local(rp, jnp.asarray(x), rcfg)
    got, aux, disp = moe.apply_local(p, _t(x), cfg)
    assert got.dtype == torch.float32 and disp.dtype == torch.int32
    np.testing.assert_array_equal(_np(disp), np.asarray(rdisp))
    np.testing.assert_allclose(_np(got), want, **LAYER)
    np.testing.assert_allclose(float(aux), float(raux), **ROUTER)
    counts = np.bincount(_np(disp), minlength=cfg.num_experts)
    capacity = max(1, int(disp.numel() / cfg.num_experts * capacity_factor))
    assert (counts.max() > capacity) == (capacity_factor == 1.25)


def test_apply_local_counts_with_k7_and_combines_with_k5(monkeypatch):
    """One K7 launch on the sorted dispatch stream (int32, its counts the
    stream's histogram) and one K5 launch on T segments over the (E, C)
    slots: each token's k rows in kept slots, T (dropped) in the rest."""
    rcfg, cfg, rp, p = _layer()
    calls = _count_launchers(monkeypatch)
    x = _t(_x(24, cfg.d_model, seed=4))
    _, _, disp = moe.apply_local(p, x, cfg)
    assert len(calls["bincount"]) == 1 and len(calls["scatter_add"]) == 1
    ids, segments, counts = calls["bincount"][0]
    assert ids.dtype == torch.int32 and segments == cfg.num_experts
    np.testing.assert_array_equal(_np(ids), np.sort(_np(disp)))
    np.testing.assert_array_equal(
        _np(counts), np.bincount(_np(disp), minlength=cfg.num_experts))
    values, ids, segments, _ = calls["scatter_add"][0]
    capacity = int(24 * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    slots = cfg.num_experts * capacity
    assert values.shape == (slots, cfg.d_model) and segments == 24
    assert values.dtype == torch.float32 and ids.dtype == torch.int32
    assert sorted(_np(ids).tolist()) == sorted(
        list(range(24)) * cfg.top_k + [24] * (slots - 24 * cfg.top_k))
    assert not values[ids == 24].any()


def _collapsed(rp, x, experts=2, bias=4.0):
    """A router collapsed onto its first ``experts`` experts: a constant
    feature 0 in x and router weights on it that favour them, so that
    past a capacity most rows drop."""
    w = np.array(rp["router"]["w"])
    w[0, :experts], w[0, experts:] = bias, -bias
    x = x.copy()
    x[:, 0] = 3.0
    return dict(rp, router={"w": jnp.asarray(w)}), x


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
def test_apply_local_drops_equal_the_sorted_row_combine(capacity_factor):
    """With most rows dropped, the slot-layout combine is bit for bit the
    sorted-row one: ``_expert_ffn_grouped``'s rows (zero where dropped)
    times their gates by ``order``, summed by token with the plain segment
    sum.  Both add the same kept products in the same order in f64; the
    dropped rows add only zeros."""
    rcfg, cfg, rp, _ = _layer(capacity_factor)
    rp, x = _collapsed(rp, _x(48, cfg.d_model, seed=6))
    p, tx = _params(rp), _t(x)
    got, _, _ = moe.apply_local(p, tx, cfg)
    gates, ids, _ = moe.route(p, tx, cfg)
    _, order, sorted_ids, xs = moe._sort(tx, ids, cfg.top_k)
    capacity = moe._capacity(ids.numel(), cfg.num_experts, cfg)
    rows = moe._expert_ffn_grouped(p, xs, sorted_ids, cfg.num_experts,
                                   capacity, cfg)
    vals = rows.to(torch.float32) * gates.reshape(-1)[order][:, None]
    tok = torch.div(order, cfg.top_k, rounding_mode="floor").to(torch.int32)
    want = sk.scatter_add_plain(vals, tok, 48).to(tx.dtype)
    kept = int(torch.clamp(sk.bincount_plain(sorted_ids, cfg.num_experts),
                           max=capacity).sum())
    assert kept < 0.5 * sorted_ids.numel()      # most rows drop
    assert torch.equal(got, want)
    want_ref, _, _ = ref_moe.apply_local(rp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(_np(got), want_ref, **LAYER)


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_carries_the_expert_ffn(arch):
    cfg, _, rp, _, p = _models(arch)
    ffn = p["layers"][cfg.num_layers - 1]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down"}
    assert ffn["w_gate"].shape == (cfg.num_experts, cfg.d_model,
                                   cfg.d_expert)
    ref = rp["groups"]["sub0"]["ffn"]
    np.testing.assert_array_equal(_np(ffn["router"]["w"]),
                                  np.asarray(ref["router"]["w"][-1]))
    np.testing.assert_array_equal(_np(ffn["w_down"]),
                                  np.asarray(ref["w_down"][-1]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match(arch, monkeypatch):
    """qwen3-moe: untied head; granite-moe: tied embeddings.  K8 (its
    plain version here), K7 and K5 once per layer."""
    cfg, ref_model, rp, model, p = _models(arch)
    tokens = _tokens(cfg, 2, 20)
    want, raux = ref_model.forward(rp, jnp.asarray(tokens))
    calls = _count_launchers(monkeypatch)
    before = fk.LAUNCHES["flash_attention"]
    flash = []
    plain = fk.attention_plain
    monkeypatch.setattr(fk, "attention_plain",
                        lambda *a, **kw: flash.append(1) or plain(*a, **kw))
    got, aux = model.forward(p, _t(tokens))
    assert fk.LAUNCHES["flash_attention"] == before
    assert (len(flash), len(calls["bincount"]), len(calls["scatter_add"])) \
        == (cfg.num_layers,) * 3
    assert got.shape == (2, 20, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), want, **MODEL)
    assert float(raux) > 0
    np.testing.assert_allclose(float(aux), float(raux), **MODEL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_steps_match_the_reference(arch):
    cfg, ref_model, rp, model, p = _models(arch, seed=1)
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
        # reduced() sets capacity factor 8: nothing drops in either route
        assert float((got[:, 0] - fwd[:, t]).abs().max()) < 2e-2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_generate_equals_the_reference(arch):
    cfg, ref_model, rp, model, p = _models(arch, seed=2)
    prompt = _tokens(cfg, 2, 6, seed=2)
    want = ref_serve.generate(ref_model, rp, jnp.asarray(prompt), 8,
                              ref_serve.ServeConfig(max_len=16))
    got = serve_mod.generate(model, p, _t(prompt), 8,
                             serve_mod.ServeConfig(max_len=16))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_decode_drops_follow_the_reference_capacity():
    """At the published capacity factor (1.25) a decode step of 2 tokens
    has capacity 1 an expert, so rows drop where the prefill keeps them:
    both routes still equal the reference's."""
    arch = "qwen3-moe-235b-a22b"
    cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                              moe_capacity_factor=1.25)
    ref_model = ref_build_model(cfg)
    rp = ref_model.init(jax.random.PRNGKey(4))
    model = build_model(dataclasses.replace(get_config(arch).reduced(),
                                            moe_capacity_factor=1.25), CPU)
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), cfg, CPU)
    tokens = _tokens(cfg, 2, 12, seed=4)
    want, _ = ref_model.forward(rp, jnp.asarray(tokens))
    got, _ = model.forward(p, _t(tokens))
    np.testing.assert_allclose(_np(got), want, **MODEL)
    rcache, cache = ref_model.init_cache(rp, 2, 16), model.init_cache(p, 2, 16)
    for t in range(4):
        want, rcache = ref_model.decode_step(
            rp, jnp.asarray(tokens[:, t:t + 1]), rcache,
            pos=jnp.asarray(t, jnp.int32))
        step, cache = model.decode_step(p, _t(tokens[:, t:t + 1]), cache,
                                        pos=t)
        np.testing.assert_allclose(_np(step), want, **MODEL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    before = dict(sk.LAUNCHES)
    out = launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", "4", "--gen", "4",
                             "--device", "cpu"])
    assert out.shape == (2, 8)
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out
    assert sk.LAUNCHES == before


# -- the example -------------------------------------------------------------


def test_dispatch_profile_example_prints_the_reference_lines():
    """``torch_moe_dispatch_profile.py``, given the reference example's
    weights and activations, prints its e, U and verdict lines; on its own
    seeds it runs on the CPU with ``--torch-device cpu``."""
    ref = load_example("moe_dispatch_profile")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    want = buf.getvalue().splitlines()
    # the reference example's inputs, as it draws them
    cfg = ref_get_config("qwen3-moe-235b-a22b").reduced()
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    p_moe = jax.tree.map(lambda a: np.asarray(a[0]),
                         params["groups"]["sub0"]["ffn"])
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (8 * 128, cfg.d_model), jnp.float32)
                   * 0.3)
    port = load_example("torch_moe_dispatch_profile")
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_expert=cfg.d_expert,
                         num_experts=cfg.num_experts, top_k=cfg.top_k,
                         dtype=cfg.dtype)
    session = Session(device="v5e",
                      provider=InstrumentedKernelProvider(torch_device=CPU))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port.profile_routers(_params(p_moe), _t(h), mcfg, session)
    got = buf.getvalue().splitlines()
    assert len(want) == 4 and got == want
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        profiles = port.main(["--torch-device", CPU])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 4 and all(" e=" in line for line in lines[1:])
    # the collapsed router concentrates the stream: e rises
    assert profiles[2].e > profiles[0].e
