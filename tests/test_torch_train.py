"""The port's training path against the reference's.

On reduced f32 configs on the CPU, where K5's and K7's launchers run
their plain versions: the reference's parameters, initialised by
``jax.random``, are carried across as numpy (``convert``), with the
constant RWKV/Mamba leaves perturbed and llama-vision's gates opened as
the serving tests do, and tokens and stubs are made with numpy from a
seed.  The port's gradients and AdamW state come back through
``convert.lm_params_to_numpy`` / ``whisper_params_to_numpy`` and are
held against the reference's ``jax.grad`` leaf by leaf.

Bounds: the loss within 1e-5 relative (f32 sums in other orders); each
gradient leaf within 1e-4 max|g_ref| + 1e-7 (the bound of a whole
model's logits, scaled to the leaf; the floor for leaves whose true
gradient is 0, such as a key bias under the softmax, where both packages
return rounding noise); AdamW within rtol 1e-6 (a few f32 ulps of the
same arithmetic), plus atol 1e-8, two ulps of the leaves' O(0.1) values,
for an element that the update's subtraction brings near 0.  Remat
changes nothing: losses and gradients equal.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core import microbench as ref_microbench
from repro.core import profiler as ref_profiler
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.kernels.scatter_add import ops as ref_scatter_ops
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_train
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import microbench, profiler
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.kernels.scatter_add import ops as scatter_ops
from repro_torch.models import attention, moe, transformer
from repro_torch.models.registry import build_model, make_batch
from repro_torch.optim import adamw
from repro_torch.train import step as train_mod
from test_torch_families import _open_gates
from test_torch_ssm import _perturb

CPU = "cpu"
ALL_ARCHS = sorted(REF_ARCHS)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
ADAMW = dict(rtol=1e-6, atol=1e-8)
MODULE = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the test workers share the machine's
    cores, where torch's thread pools in several processes only contend
    (a training loop ran 20 times slower beside one other worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_numpy(tree_, cfg):
    fn = (convert.whisper_params_to_numpy if cfg.family == "audio"
          else convert.lm_params_to_numpy)
    return fn(tree_, cfg)


def _setup(arch, seed=0):
    """(reduced cfg, reference model, its params as jnp, the port's model,
    its params, the batch as numpy): one set of parameters in both."""
    cfg = ref_get_config(arch).reduced()
    ref_model = ref_build_model(cfg)
    rp_np = jax.tree.map(np.array,
                         ref_model.init(jax.random.PRNGKey(seed)))
    if cfg.family == "audio":
        p = convert.whisper_params_from_numpy(rp_np, cfg, CPU)
    else:
        _perturb(rp_np, cfg, seed + 11)
        _open_gates(rp_np, cfg)
        p = convert.lm_params_from_numpy(rp_np, cfg, CPU)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    stubs = {"audio": ("frames", cfg.encoder_frames),
             "vlm": ("image_embeds", cfg.image_tokens)}
    if cfg.family in stubs:
        name, n = stubs[cfg.family]
        batch[name] = (rng.standard_normal((B, n, cfg.d_model))
                       * 0.02).astype(np.float32)
    return (cfg, ref_model, jax.tree.map(jnp.asarray, rp_np),
            build_model(get_config(arch).reduced(), CPU), p, batch)


@pytest.fixture(scope="module")
def reference_grads():
    """arch -> (the setup, the reference's loss, metrics and gradients):
    each jitted ``jax.value_and_grad`` once for the module."""
    memo = {}

    def get(arch):
        if arch not in memo:
            s = _setup(arch)
            loss_fn = ref_train.make_loss_fn(s[1], ref_train.TrainConfig())
            (loss, metrics), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(
                s[2], jax.tree.map(jnp.asarray, s[5]))
            memo[arch] = (s, float(loss), metrics, grads)
        return memo[arch]

    return get


def _assert_grads_close(got_np, want):
    assert jax.tree.structure(got_np) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got_np)):
        w = np.asarray(w)
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = float(np.abs(g - w).max())
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


# -- the loss and its gradients ---------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_grads_match_the_reference(arch, reference_grads,
                                            monkeypatch):
    """Every config's loss (xent, and 0.001 aux for MoE) and the gradient
    of every parameter leaf against ``jax.grad`` of the reference's."""
    (cfg, _, _, model, p, batch), loss, metrics, want = reference_grads(arch)
    calls = _count(monkeypatch, sk, "scatter_add_plain")
    grads, got = train_mod.make_grad_fn(model, train_mod.TrainConfig())(
        p, {k: _t(v) for k, v in batch.items()})
    for name in ("xent", "aux"):
        np.testing.assert_allclose(float(got[name]), float(metrics[name]),
                                   rtol=LOSS_RTOL)
    total = float(got["xent"]) + (0.001 * float(got["aux"]) if cfg.is_moe
                                  else 0.0)
    np.testing.assert_allclose(total, loss, rtol=LOSS_RTOL)
    # an MoE layer's combine ran forward twice under remat
    assert len(calls) == (2 * cfg.num_layers if cfg.is_moe else 0)
    _assert_grads_close(_to_numpy(grads, cfg), want)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-small",
                                  "zamba2-1.2b", "gemma2-27b"])
def test_remat_changes_nothing(arch):
    """Recomputing each layer in the backward pass gives the same loss
    and the same gradients as keeping its activations."""
    cfg, _, _, _, p, batch = _setup(arch)
    batch = {k: _t(v) for k, v in batch.items()}
    out = {}
    for remat in ("block", "none"):
        c = dataclasses.replace(get_config(arch).reduced(), remat=remat)
        out[remat] = train_mod.make_grad_fn(
            build_model(c, CPU), train_mod.TrainConfig())(p, batch)
    (g1, m1), (g0, m0) = out["block"], out["none"]
    assert float(m1["xent"]) == float(m0["xent"])
    assert float(m1["aux"]) == float(m0["aux"])
    for a, b in zip(tree.leaves(g1), tree.leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("chunk", [7, 8, 31])
def test_chunked_xent_matches_the_reference(chunk):
    """The sequence-chunked xent, its last chunk padded and masked, and
    its gradient, against the reference's ``_chunked_xent``."""
    cfg, ref_model, rp, model, p, batch = _setup("qwen2-72b", seed=3)
    h = np.random.default_rng(4).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    labels = batch["labels"]

    def ref_loss(rp, h):
        return ref_transformer._chunked_xent(ref_model, rp, h,
                                             jnp.asarray(labels), chunk)

    want, (want_gp, want_gh) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(rp, jnp.asarray(h))
    th = _t(h).requires_grad_()
    table = p["lm_head"]["w"].requires_grad_()
    got = transformer._chunked_xent(model, p, th, _t(labels), chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(th.grad), want_gh, **MODULE)
    np.testing.assert_allclose(_np(table.grad), want_gp["lm_head"]["w"],
                               **MODULE)


# -- K5 under autograd and the MoE layer -------------------------------------


def _count(monkeypatch, module, name):
    """Calls of ``module.name`` (a plain version: a launch on the CPU)."""
    calls = []
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("num_segments", [1, 7, 64])
def test_scatter_add_autograd_forward_and_backward(num_segments):
    """K5 under autograd: the forward is the launcher's (here its plain
    version), the backward the gather, bit for bit the gradient autograd
    takes through ``scatter_add_plain``'s ``index_add``; rows with an id
    outside [0, S), negative or not, get zero."""
    rng = np.random.default_rng(num_segments)
    n, d = 300, 5
    ids = rng.integers(-3, num_segments + 3, n).astype(np.int32)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((num_segments, d)).astype(np.float32)
    a = _t(vals).requires_grad_()
    out = sk.scatter_add_autograd(a, _t(ids), num_segments)
    (out * _t(w)).sum().backward()
    b = _t(vals).requires_grad_()
    plain = sk.scatter_add_plain(b, _t(ids), num_segments)
    (plain * _t(w)).sum().backward()
    assert torch.equal(out.detach(), plain.detach())
    assert torch.equal(a.grad, b.grad)
    kept = (ids >= 0) & (ids < num_segments)
    assert not a.grad[~torch.as_tensor(kept)].any()
    np.testing.assert_array_equal(_np(a.grad)[kept], w[ids[kept]])


def _leaves(rp):
    """The reference's MoE parameters as torch leaves that take a grad."""
    return {k: ({kk: _t(vv).requires_grad_() for kk, vv in v.items()}
                if isinstance(v, dict) else _t(v).requires_grad_())
            for k, v in rp.items()}


def test_moe_layer_grads_match_the_reference():
    """One MoE layer's output and the gradients of its input, router and
    expert weights against ``jax.grad`` through the reference's
    ``apply_local``, with rows dropped past the capacity."""
    kw = dict(d_model=16, d_expert=8, num_experts=4, top_k=2,
              capacity_factor=0.75, dtype="float32")
    rcfg, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    rp = ref_moe.init(jax.random.PRNGKey(0), rcfg)
    x = np.random.default_rng(1).standard_normal((40, 16)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((40, 16)).astype(np.float32)

    def ref_loss(rp, x):
        out, aux, _ = ref_moe.apply_local(rp, x, rcfg)
        return (out * w).sum() + aux

    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(rp, jnp.asarray(x))
    p, tx = _leaves(rp), _t(x).requires_grad_()
    out, aux, _ = moe.apply_local(p, tx, cfg)
    got = (out * _t(w)).sum() + aux
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(tx.grad), want_gx, **MODULE)
    for name in ("w_gate", "w_up", "w_down"):
        assert p[name].grad.abs().sum() > 0
        np.testing.assert_allclose(_np(p[name].grad), want_gp[name], **MODULE)
    np.testing.assert_allclose(_np(p["router"]["w"].grad),
                               want_gp["router"]["w"], **MODULE)


def _collapsed_layer(capacity_factor, t=48):
    """An 8-expert top-2 layer whose router is collapsed onto experts 0
    and 1 (a constant feature 0 in x, router weights on it that favour
    them), so that past the capacity most rows drop: (reference config,
    the port's, reference params, x)."""
    kw = dict(d_model=16, d_expert=8, num_experts=8, top_k=2,
              capacity_factor=capacity_factor, dtype="float32")
    rp = jax.tree.map(np.array, ref_moe.init(jax.random.PRNGKey(3),
                                             ref_moe.MoEConfig(**kw)))
    rp["router"]["w"][0, :2], rp["router"]["w"][0, 2:] = 4.0, -4.0
    x = np.random.default_rng(4).standard_normal((t, 16)).astype(np.float32)
    x[:, 0] = 3.0
    return ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw), rp, x


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
def test_moe_layer_grads_under_drops_match_the_reference(capacity_factor):
    """A collapsed router drops most rows: the gradients of x, the router
    and every expert weight against ``jax.grad`` through the reference's
    ``apply_local``; the gates of dropped rows get a zero gradient
    through the slot-layout combine, those of kept rows not."""
    rcfg, cfg, rp, x = _collapsed_layer(capacity_factor)
    t, k = x.shape[0], cfg.top_k
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def ref_loss(rp, x):
        out, aux, _ = ref_moe.apply_local(rp, x, rcfg)
        return (out * w).sum() + aux

    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, rp),
                                   jnp.asarray(x))
    p, tx = _leaves(rp), _t(x).requires_grad_()
    out, aux, _ = moe.apply_local(p, tx, cfg)
    got = (out * _t(w)).sum() + aux
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(tx.grad), want_gx, **MODULE)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(_np(p[name].grad), want_gp[name], **MODULE)
    np.testing.assert_allclose(_np(p["router"]["w"].grad),
                               want_gp["router"]["w"], **MODULE)

    with torch.no_grad():
        gates, ids, _ = moe.route(p, tx, cfg)
        sent = moe.dispatch(tx, ids, cfg)
    gates = gates.requires_grad_()
    order, slot, keep = sent["order"], sent["slot"], sent["keep"]
    y = moe.experts(p, sent.pop("buf"), cfg)
    vals, tok = moe.combine_slots(y, slot, gates, order, k, t)
    (sk.scatter_add_autograd(vals, tok, t) * _t(w)).sum().backward()
    dropped = torch.zeros(t * k, dtype=torch.bool)
    dropped[order[~keep]] = True
    assert int(dropped.sum()) > t * k // 2          # most rows drop
    g = gates.grad.reshape(-1)
    assert not g[dropped].any() and g[~dropped].ne(0).all()


def test_moe_combine_indexes_no_expert_row():
    """Walking ``apply_local``'s graph from its output under grad, with
    most rows dropped: the only gathers left are ``x[order // k]`` and
    the gates' permutation ``gates.reshape(-1)[order]``; every index write
    is without accumulate (its backward a gather), the gates' one writing
    each slot once but for the spare entry, and no node indexes the
    expert output, so no backward adds many rows into one."""
    _, cfg, rp, x = _collapsed_layer(1.25)
    t, d = x.shape
    p, tx = _leaves(rp), _t(x).requires_grad_()
    out, _, _ = moe.apply_local(p, tx, cfg)
    with torch.no_grad():
        _, ids, _ = moe.route(p, tx, cfg)
        order = moe.dispatch(tx, ids, cfg)["order"]
    indexing = ("Index", "Gather", "Scatter", "Take", "Embedding")
    seen, stack, found = set(), [out.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if any(word in node.name() for word in indexing):
            found.append(node)
        stack.extend(f for f, _ in node.next_functions)
    names = collections.Counter(n.name() for n in found)
    assert names == {"IndexBackward0": 2, "IndexPutBackward0": 1,
                     "ScatterBackward0": 1, "_ScatterAddBackward": 1}, names
    for node in found:
        if node.name() == "IndexPutBackward0":
            assert node._saved_accumulate is False
        if node.name() == "ScatterBackward0":    # no reduce: a gather back
            idx = node._saved_index                 # each slot once, but
            kept = idx[idx != idx.max()]            # the spare, cut off
            assert kept.unique().numel() == kept.numel() < idx.numel()
    gathers = {tuple(n._saved_self_sym_sizes): n._saved_indices
               for n in found if n.name() == "IndexBackward0"}
    assert set(gathers) == {(t, d), (t * cfg.top_k,)}
    assert torch.equal(gathers[(t, d)][0],
                       torch.div(order, cfg.top_k, rounding_mode="floor"))
    assert torch.equal(gathers[(t * cfg.top_k,)][0], order)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(t * cfg.top_k))


def test_slot_combine_serves_and_trains_alike():
    """``combine_slots`` gives the same products and token ids without
    grad (serving) and under it (training), and leaves the expert output
    unmodified in both: the gate product is a fresh f32 tensor, each
    slot's bf16 row times its gate, bit for bit; an empty slot's id is
    T, one past the end, and its value 0."""
    rng = np.random.default_rng(5)
    y = _t(rng.standard_normal((16, 4)).astype(np.float32)).to(
        torch.bfloat16)
    gates = _t(rng.random((6, 2)).astype(np.float32))
    order = torch.randperm(12, generator=torch.Generator().manual_seed(0))
    slot = torch.tensor([3, 16, 0, 7, 16, 9, 15, 1, 16, 4, 12, 16])
    with torch.no_grad():
        served, ids = moe.combine_slots(y, slot, gates, order, 2, 6)
    yg, gg = y.clone().requires_grad_(), gates.clone().requires_grad_()
    trained, ids2 = moe.combine_slots(yg, slot, gg, order, 2, 6)
    assert trained.grad_fn is not None and yg._version == 0
    assert torch.equal(yg.detach(), y)
    assert torch.equal(served, trained.detach()) and torch.equal(ids, ids2)
    assert served.dtype == torch.float32 and ids.dtype == torch.int32
    kept = slot < 16
    want = y.to(torch.float32)[slot[kept]] * gates.reshape(-1)[
        order[kept]][:, None]
    assert torch.equal(served[slot[kept]], want)
    assert torch.equal(ids[slot[kept]], (order[kept] // 2).to(torch.int32))
    empty = torch.ones(16, dtype=torch.bool)
    empty[slot[kept]] = False
    assert (ids[empty] == 6).all() and not served[empty].any()


# -- attention under grad -----------------------------------------------------


def _attn_case(**kw):
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
              qkv_bias=True, rope_theta=1e6, dtype="float32", **kw)
    rcfg = ref_attention.AttnConfig(**kw)
    rp = ref_attention.init(jax.random.PRNGKey(0), rcfg)
    rp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, rp)
    return rcfg, attention.AttnConfig(**kw), rp


@pytest.mark.parametrize("causal", [True, False])
def test_attention_under_grad_takes_the_plain_route(causal, monkeypatch):
    """K8 has no backward: under grad, attention over 0..T-1 runs the
    plain ``_sdpa`` (no K8 call), and its output and the gradients of x
    and of every projection equal the reference's ``jax.grad``; without
    grad the same call runs K8."""
    rcfg, cfg, rp = _attn_case(causal=causal)
    x = np.random.default_rng(6).standard_normal((2, 24, 64)).astype(
        np.float32)
    w = np.random.default_rng(7).standard_normal((2, 24, 64)).astype(
        np.float32)

    def ref_loss(rp, x):
        return (ref_attention.attend(rp, x, rcfg)[0] * w).sum()

    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1)))(rp, jnp.asarray(x))
    calls = _count(monkeypatch, fk, "attention_plain")
    p = {k: {kk: _t(np.asarray(vv)).requires_grad_()
             for kk, vv in v.items()} for k, v in rp.items()}
    assert not attention.flash_route(cfg, t=24, grad=True)
    assert attention.flash_route(cfg, t=24)
    tx = _t(x).requires_grad_()
    out, _ = attention.attend(p, tx, cfg)
    (out * _t(w)).sum().backward()
    assert calls == []
    np.testing.assert_allclose((out * _t(w)).sum().item(), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(tx.grad), want_gx, **MODULE)
    for k in p:
        for kk in p[k]:
            np.testing.assert_allclose(_np(p[k][kk].grad), want_gp[k][kk],
                                       **MODULE)
    with torch.no_grad():
        served, _ = attention.attend(p, tx, cfg)
    assert calls == [1]
    np.testing.assert_allclose(_np(served), _np(out), **MODULE)


def test_train_step_launches_no_flash_attention(monkeypatch):
    """A train step of granite reduced: every MoE layer's K7 and K5 run
    forward twice (the forward and its recompute), K8 never."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(cfg, CPU)
    state = train_mod.init_state(model, torch.Generator().manual_seed(0))
    counts = {name: _count(monkeypatch, mod, name) for mod, name in (
        (fk, "attention_plain"), (sk, "scatter_add_plain"),
        (sk, "bincount_plain"))}
    step = train_mod.make_train_step(model, train_mod.TrainConfig(),
                                     adamw.AdamWConfig())
    step(state, make_batch(cfg, 2, 16, device=CPU))
    assert {k: len(v) for k, v in counts.items()} == {
        "attention_plain": 0, "scatter_add_plain": 2 * cfg.num_layers,
        "bincount_plain": 2 * cfg.num_layers}


# -- AdamW and the train step -----------------------------------------------


def test_adamw_update_matches_the_reference():
    """Three updates on the same numpy gradients, clipped on the first:
    the parameters, m, v, master and the metrics within rtol 1e-6."""
    rng = np.random.default_rng(8)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, clip_norm=3.0)
    rstate = ref_adamw.init(jax.tree.map(jnp.asarray, params))
    ref_update = jax.jit(lambda g, st: ref_adamw.update(
        g, st, ref_adamw.AdamWConfig(**cfg), params_dtype=jnp.float32))
    state = adamw.init({k: _t(v) for k, v in params.items()})
    p = {k: _t(v) for k, v in params.items()}
    for i in range(3):
        g = {k: (rng.standard_normal(s) * (10 if i == 0 else 0.3)).astype(
            np.float32) for k, s in shapes.items()}
        rparams, rstate, rmet = ref_update(jax.tree.map(jnp.asarray, g),
                                           rstate)
        p, state, met = adamw.update({k: _t(v) for k, v in g.items()},
                                     state, adamw.AdamWConfig(**cfg), p)
        for k in shapes:
            np.testing.assert_allclose(_np(p[k]), rparams[k], **ADAMW)
            for part in ("m", "v", "master"):
                np.testing.assert_allclose(_np(state[part][k]),
                                           rstate[part][k], **ADAMW)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]), **ADAMW)
        assert int(state["count"]) == int(rstate["count"]) == i + 1


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(150):
        grads = {"w": 2.0 * state["master"]["w"]}  # d/dw of w^2
        params, state, _ = adamw.update(grads, state, cfg, params)
    assert float(params["w"].abs().max()) < 0.2


def test_adamw_clipping_keeps_dtypes():
    """The gradient norm before clipping; each leaf keeps its dtype (an
    f32 leaf of a bf16 tree stays f32); the count steps."""
    params = {"w": torch.ones(4, dtype=torch.bfloat16),
              "gate": torch.zeros((), dtype=torch.float32)}
    state = adamw.init(params)
    grads = {"w": torch.full((4,), 100.0), "gate": torch.tensor(0.0)}
    new, state, m = adamw.update(grads, state, adamw.AdamWConfig(), params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert new["w"].dtype == torch.bfloat16
    assert new["gate"].dtype == torch.float32
    assert int(state["count"]) == 1


@pytest.mark.parametrize("step,want", [(5, 0.5), (10, 1.0), (110, 0.1),
                                       (60, 0.55)])
def test_schedule_matches_the_reference(step, want):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    got = float(adamw.schedule(adamw.AdamWConfig(**cfg), step))
    assert got == float(ref_adamw.schedule(ref_adamw.AdamWConfig(**cfg),
                                           step))
    assert got == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decay_mask_is_the_references(arch):
    """AdamW decays a leaf where the reference does: two dimensions or
    more in its layout, where a scanned layer's norm scale is (layers, d)
    and decays, and a tail's or the final norm's is (d,) and does not."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, CPU)
    p = model.init(torch.Generator().manual_seed(0))
    mask = tree.map(lambda d: torch.tensor(float(d)),
                    train_mod.decay_mask(model, p))
    mask_np = _to_numpy(mask, cfg)
    shapes = jax.eval_shape(ref_build_model(ref_get_config(arch).reduced())
                            .init, jax.random.PRNGKey(0))
    assert jax.tree.structure(mask_np) == jax.tree.structure(shapes)
    for m, s in zip(jax.tree.leaves(mask_np), jax.tree.leaves(shapes)):
        assert np.all(m == float(len(s.shape) >= 2))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_one_accumulated_train_step(arch):
    """``accum_steps=2``, as the reference's per-arch smoke test: a finite
    xent and grad norm, the step count at 1, and the parameters moved;
    the gradients accumulate in f32."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, CPU)
    state = train_mod.init_state(model, torch.Generator().manual_seed(0))
    before = [t.clone() for t in tree.leaves(state["params"])]
    step = train_mod.make_train_step(
        model, train_mod.TrainConfig(accum_steps=2),
        adamw.AdamWConfig(warmup_steps=1, total_steps=10))
    new_state, metrics = step(state, make_batch(cfg, 4, 32, device=CPU))
    assert np.isfinite(float(metrics["xent"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_state["step"]) == 1
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree.leaves(new_state["params"]), before)]
    assert max(moved) > 0


def test_accumulated_step_matches_the_reference():
    """One ``accum_steps=2`` step: the metrics and AdamW's moments (the
    f32 mean of the two microbatches' gradients, clipped) against the
    reference's jitted step.  (The parameters are not compared: Adam's
    first step moves each element by about lr x sign(g), and a gradient
    that is rounding noise in both packages has no sign to agree on.)"""
    (cfg, ref_model, rp, model, p, batch) = _setup("qwen3-moe-235b-a22b")
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    tcfg = dict(accum_steps=2)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    rstate = {"params": rp, "opt": ref_adamw.init(rp),
              "step": jnp.zeros((), jnp.int32)}
    rnew, rmet = jax.jit(ref_train.make_train_step(
        ref_model, ref_train.TrainConfig(**tcfg),
        ref_adamw.AdamWConfig(**ocfg)))(
        rstate, jax.tree.map(jnp.asarray, batch))
    state = {"params": p, "opt": adamw.init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    new, met = train_mod.make_train_step(
        model, train_mod.TrainConfig(**tcfg), adamw.AdamWConfig(**ocfg))(
        state, {k: _t(v) for k, v in batch.items()})
    for k in ("xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                   rtol=LOSS_RTOL)
    for part in ("m", "v"):
        _assert_grads_close(_to_numpy(new["opt"][part], cfg),
                            rnew["opt"][part])


def test_compressed_grads_reach_the_update_in_the_wire_dtype(monkeypatch):
    """``compress_grads``: the gradients, summed in f32 over the
    microbatches, reach AdamW cast to ``grad_dtype``."""
    cfg = get_config("qwen2-72b").reduced()
    model = build_model(cfg, CPU)
    batch = make_batch(cfg, 4, 16, device=CPU)
    seen = {}
    update = adamw.update

    def spy(grads, *a):
        seen.setdefault("grads", []).append(grads)
        return update(grads, *a)

    monkeypatch.setattr(adamw, "update", spy)
    for compress in (False, True):
        state = train_mod.init_state(model, torch.Generator().manual_seed(0))
        train_mod.make_train_step(
            model, train_mod.TrainConfig(accum_steps=2,
                                         compress_grads=compress),
            adamw.AdamWConfig())(state, batch)
    f32, wire = (tree.leaves(g) for g in seen["grads"])
    assert all(g.dtype == torch.float32 for g in f32)
    assert all(torch.equal(w, g.to(torch.bfloat16))
               for w, g in zip(wire, f32))


# -- convert -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_convert_round_trip_is_bitwise(arch):
    """The port's parameters to the reference's layout and back: every
    leaf bit for bit, and the layout is the reference's ``init``'s."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, CPU)
    p = model.init(torch.Generator().manual_seed(1))
    back_np = _to_numpy(p, cfg)
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(back_np) == jax.tree.structure(shapes)
    assert [a.shape for a in jax.tree.leaves(back_np)] == [
        s.shape for s in jax.tree.leaves(shapes)]
    fn = (convert.whisper_params_from_numpy if cfg.family == "audio"
          else convert.lm_params_from_numpy)
    again = fn(back_np, cfg, CPU)
    assert [k for k, _ in _paths(again)] == [k for k, _ in _paths(p)]
    for (_, a), (_, b) in zip(_paths(again), _paths(p)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _paths(t, prefix=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _paths(t[k], f"{prefix}/{k}")
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, t


# -- the embedding gradient's scatter ----------------------------------------


def test_embedding_grad_scatter_profile_zipf_vs_uniform():
    """The reference's test on the port: a Zipfian batch's embedding-grad
    scatter shows a higher serialization degree than a uniform batch's
    (K6's plain version here), and each profile equals the reference's."""
    table = microbench.build_table()
    ref_table = ref_microbench.build_table()
    profs, refs = {}, {}
    for name, alpha in (("zipf", 1.2), ("uniform", 0.0)):
        kw = dict(vocab_size=4096, seq_len=2048, global_batch=8,
                  zipf_alpha=alpha)
        toks = SyntheticLM(DataConfig(**kw)).global_batch_at(0).reshape(-1)
        ref_toks = RefSyntheticLM(RefDataConfig(**kw)).global_batch_at(
            0).reshape(-1)
        np.testing.assert_array_equal(toks, ref_toks)
        _, c = scatter_ops.instrumented_scatter_add(
            toks.astype(np.int32), np.ones((toks.size, 1), np.float32),
            4096, torch_device=CPU)
        _, rc = ref_scatter_ops.instrumented_scatter_add(
            toks.astype(np.int32), np.ones((toks.size, 1), np.float32),
            4096)
        np.testing.assert_array_equal(c["degree"], np.asarray(rc["degree"]))
        for cc, tab, prof, mod in ((c, table, profs, profiler),
                                   (rc, ref_table, refs, ref_profiler)):
            cc["trace"].waves_per_tile = 32
            prof[name] = mod.profile_scatter_workload(
                cc["trace"], tab, label=name,
                bytes_read=float(toks.size * 4), overhead_cycles=500.0)
        assert profs[name].per_core[0].e == refs[name].per_core[0].e
    e_zipf = profs["zipf"].per_core[0].e
    e_uni = profs["uniform"].per_core[0].e
    assert e_zipf > 1.5 * e_uni, (e_zipf, e_uni)
    assert profs["zipf"].scatter_utilization > \
        profs["uniform"].scatter_utilization
