"""K8 under autograd: ``repro_torch::flash_attention_fwd`` (the output and
each query row's log-sum-exp) and ``repro_torch::flash_attention_bwd``
(dq, dk, dv), tied by ``register_autograd``, on the CPU.

Their CPU implementations are the plain versions' f32 math: held here to
the f32 attention and to autograd through it, at GQA groups 1, 2 and 8,
causal and not, a T that is not a whole 128-row tile, and a score scale
of the config's.  Then the route (``attention.flash_route``) under grad
case by case, and the FLOP formulas under ``FlopCounterMode`` on the
meta device.  The kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import dataclasses

import pytest
import torch
from torch.library import opcheck
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.models import attention, layers, registry, transformer

NEG_INF = -2.0e38
# f32 against f32 on the same products, summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, h, kv, t, d, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype)
            for s in ((b, h, t, d), (b, kv, t, d), (b, kv, t, d),
                      (b, h, t, d))]


def _reference(q, k, v, causal, group, scale):
    """The materialised f32 attention, out of place so that autograd
    differentiates through it: (out, lse)."""
    b, h, t, d = q.shape
    qg = q.reshape(b, h // group, group, t, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k) * scale
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1),
                          NEG_INF)
    out = torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(s, dim=-1), v)
    return out.reshape(b, h, t, d), torch.logsumexp(s, -1).reshape(b, h, t)


CASES = [(2, 4, 4, 24, 16, True, None), (2, 4, 2, 130, 16, True, None),
         (1, 8, 1, 37, 32, False, None), (2, 8, 4, 64, 64, True, 0.125),
         (1, 16, 2, 129, 8, False, 1 / 128)]


@pytest.mark.parametrize("b,h,kv,t,d,causal,scale", CASES)
def test_plain_forward_and_backward_match_autograd(b, h, kv, t, d, causal,
                                                   scale):
    """``flash_attention_fwd``'s out and LSE against the f32 attention and
    its log-sum-exp; ``flash_attention_bwd``'s dq, dk, dv against
    autograd through it (GQA sums over each group)."""
    q, k, v, dout = _qkv(b, h, kv, t, d, seed=t + h)
    group, sc = h // kv, d ** -0.5 if scale is None else scale
    out, lse = fk.flash_attention_fwd_op(q, k, v, causal, group, sc)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want, want_lse = _reference(*leaves, causal, group, sc)
    torch.testing.assert_close(out, want.detach(), **TOL)
    torch.testing.assert_close(lse, want_lse.detach(), **TOL)
    scaled = {} if scale is None else {"scale": scale}
    assert torch.equal(out, fk.attention_plain(q, k, v, causal=causal,
                                               group=group, **scaled))
    want.backward(dout)
    grads = fk.flash_attention_bwd_op(dout, q, k, v, out, lse, causal, group,
                                      sc)
    for got, leaf in zip(grads, leaves):
        assert got.shape == leaf.shape and got.dtype == leaf.dtype
        torch.testing.assert_close(got, leaf.grad, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_runs_the_backward_operator(causal, monkeypatch):
    """``flash_attention_autograd`` under ``backward()``: one call of the
    forward operator and one of the backward, whose gradients reach q, k
    and v; the LSE takes no gradient."""
    q, k, v, dout = _qkv(2, 8, 2, 40, 16, seed=5)
    calls = []
    real = fk.attention_bwd_plain

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(fk, "attention_bwd_plain", counted)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fk.flash_attention_autograd(*leaves, causal=causal, group=4).backward(
        dout)
    assert calls == [q.shape]
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    _reference(*ref, causal, 4, 16 ** -0.5)[0].backward(dout)
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad, want.grad, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_operators_opcheck(dtype):
    """The schemas, the fake implementations against the CPU ones, the
    autograd registration and the AOT dispatch."""
    q, k, v, dout = _qkv(2, 4, 2, 24, 16, seed=1, dtype=dtype)
    opcheck(fk.flash_attention_fwd_op, (q, k, v, True, 2, 0.25))
    out, lse = fk.flash_attention_fwd_op(q, k, v, True, 2, 0.25)
    opcheck(fk.flash_attention_bwd_op,
            (dout, q, k, v, out, lse, True, 2, 0.25))


def test_bf16_results_keep_their_dtypes():
    q, k, v, dout = _qkv(1, 4, 2, 20, 64, seed=2, dtype=torch.bfloat16)
    out, lse = fk.flash_attention_fwd_op(q, k, v, True, 2, 0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (1, 4, 20)
    grads = fk.flash_attention_bwd_op(dout, q, k, v, out, lse, True, 2,
                                      0.125)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def _granite_attn():
    return transformer._attn_cfg(get_config("granite-moe-1b-a400m"), "attn")


def test_flash_route_under_grad():
    """Under grad, self-attention takes K8 with its backward where the
    inputs are bf16 and head_dim 64 or 128 (the Hopper route's); every
    other case under grad stays on ``_sdpa``, and without grad the route
    is what it was."""
    rep = dataclasses.replace
    bf16 = torch.bfloat16
    cfg = _granite_attn()
    assert (cfg.head_dim, cfg.dtype) == (64, "bfloat16")
    assert attention.flash_route(cfg, grad=True, dtype=bf16)
    assert attention.flash_route(rep(cfg, head_dim=128), grad=True,
                                 dtype=bf16)
    assert attention.flash_route(rep(cfg, causal=False), grad=True,
                                 dtype=bf16)
    assert attention.flash_route(rep(cfg, window=64), t=64, grad=True,
                                 dtype=bf16)
    # the qwen3 and llama-vision self-attention layers (d = 128) too
    for arch in ("qwen3-moe-235b-a22b", "llama-3.2-vision-11b"):
        acfg = transformer._attn_cfg(get_config(arch), "attn")
        assert attention.flash_route(acfg, grad=True, dtype=bf16), arch
    # f32, other head sizes, no dtype given: the plain route
    assert not attention.flash_route(cfg, grad=True, dtype=torch.float32)
    assert not attention.flash_route(cfg, grad=True)
    for d in (16, 32, 96, 256):
        assert not attention.flash_route(rep(cfg, head_dim=d), grad=True,
                                         dtype=bf16)
        # without grad a head size K8 cannot take still raises there
        assert attention.flash_route(rep(cfg, head_dim=d), dtype=bf16)
    # softcaps, narrower windows, the bf16 score round trip
    for other in (rep(cfg, logit_softcap=50.0), rep(cfg, window=8),
                  rep(cfg, bf16_score_grad=True)):
        assert not attention.flash_route(other, t=64, grad=True, dtype=bf16)
    # gemma2's layers keep theirs
    for kind in ("attn_local", "attn_global"):
        acfg = transformer._attn_cfg(get_config("gemma2-27b"), kind)
        assert not attention.flash_route(acfg, t=64, grad=True, dtype=bf16)
    # cross-attention, given positions, caches and the blockwise path
    x = torch.zeros(1, 3, 64)
    for kw in (dict(kv_x=x), dict(positions=torch.arange(3)),
               dict(cache={"k": x, "v": x, "pos": 0}), dict(kv_block=64)):
        assert not attention.flash_route(cfg, grad=True, dtype=bf16, **kw)


def _bf16_layer(head_dim=64, seed=0):
    cfg = dataclasses.replace(_granite_attn(), d_model=128, num_heads=4,
                              num_kv_heads=2, head_dim=head_dim)
    p = attention.init(torch.Generator().manual_seed(seed), cfg)
    x = torch.randn(2, 24, 128, generator=torch.Generator().manual_seed(
        seed + 1)).to(torch.bfloat16)
    return cfg, p, x


def test_attend_under_grad_matches_the_plain_route():
    """A bf16 layer at head_dim 64 under grad runs the forward operator
    (no ``attention_plain``: that is K8's no-grad path); its output and
    gradients equal the plain ``_sdpa`` route's on the same bf16 inputs
    up to bf16 rounding (the plain route rounds P and dP to bf16, the
    operator computes in f32)."""
    cfg, p, x = _bf16_layer()
    leaves = {k: {kk: vv.clone().requires_grad_() for kk, vv in v.items()}
              for k, v in p.items()}
    tx = x.clone().requires_grad_()
    out, _ = attention.attend(leaves, tx, cfg)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    (out.float() * w).sum().backward()
    # the same layer on the plain route: positions given
    ref_leaves = {k: {kk: vv.clone().requires_grad_()
                      for kk, vv in v.items()} for k, v in p.items()}
    rx = x.clone().requires_grad_()
    ref, _ = attention.attend(ref_leaves, rx, cfg,
                              positions=torch.arange(24))
    (ref.float() * w).sum().backward()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    for got, want in ((tx.grad, rx.grad),
                      *[(leaves[k][kk].grad, ref_leaves[k][kk].grad)
                        for k in p for kk in p[k]]):
        err = (got.float() - want.float()).norm() / want.float().norm()
        assert float(err) < 2e-2


def test_flop_formulas_count_the_backward_at_twice_the_forward():
    """On meta tensors: the forward operator 4·B·H·T²·d, its backward
    8·B·H·T²·d (the scores' recompute uncounted), causal or not."""
    b, h, kv, t, d = 2, 8, 4, 96, 64
    q = torch.empty(b, h, t, d, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k = torch.empty(b, kv, t, d, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    for causal in (True, False):
        with FlopCounterMode(display=False) as fwd:
            out = fk.flash_attention_autograd(q, k, v, causal=causal,
                                              group=h // kv)
        with FlopCounterMode(display=False) as bwd:
            torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        assert fwd.get_total_flops() == 4 * b * h * t * t * d
        assert bwd.get_total_flops() == 2 * fwd.get_total_flops()


def test_train_forward_on_meta_runs_the_forward_operator():
    """The train cell's model (granite-moe at its published head size,
    bf16, two small layers) under grad on meta tensors: the forward
    operator once a layer, and no softmax but the router's (one a
    layer)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(
        get_config("granite-moe-1b-a400m"), num_layers=2, d_model=128,
        d_ff=64, d_expert=64, num_experts=8, vocab_size=500, remat="none")
    model = registry.build_model(cfg, "meta")
    params = model.init(layers.MetaGenerator())
    stack = [params]
    while stack:
        node = stack.pop()
        children = node.values() if isinstance(node, dict) else node
        for c in children:
            if isinstance(c, (dict, list)):
                stack.append(c)
            else:
                c.requires_grad_()
    tokens = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    with Count() as count:
        model.forward(params, tokens)
    assert count.ops["repro_torch.flash_attention_fwd"] == cfg.num_layers
    assert count.ops["repro_torch.flash_attention"] == 0
    assert count.ops["aten._softmax"] == cfg.num_layers

