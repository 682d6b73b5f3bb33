"""Grouped-query attention with the variants the assigned archs need.

Flags: QKV bias (qwen), attention-logit softcap (gemma2), sliding window
(gemma2 local layers / zamba2 long-context), cross-attention
(whisper/llama-vision), bidirectional (whisper encoder), no position
embeddings and a score scale of the config's (Granite 4.0-H), KV-cache
decode, and the reference's blockwise path (``kv_block``, ``q_block``:
an online softmax over key blocks, and over query blocks too) for long
prefill and training.

Shape conventions: activations (B, T, d); Q heads H, KV heads KV with
H % KV == 0; per-head dim ``head_dim``.

Routes.  Self-attention over a whole sequence without a cache, causal
(a prefill) or bidirectional (Whisper's encoder), runs the flash-attention
kernel K8 (``flash_route``), and so does a windowed layer's over a
sequence that fits inside its window (zamba2's shared attention), where
the band masks nothing; everything else — decode against the cache,
longer windows, softcaps, cross-attention — runs the plain ``_sdpa``, as
in the reference, and ``kv_block`` takes the blockwise path.  Where
autograd would differentiate through the attention (grad enabled and q,
k or v requiring it), K8 runs only where its bf16 Hopper route has a
backward (bf16 inputs, head_dim 64 or 128): its forward keeps each row's
log-sum-exp and a backward kernel recomputes the scores tile by tile
(``flash_attention_autograd``; the reference's kernel has no gradient,
so this route has no counterpart there).  Other dtypes and head sizes
under grad run the plain ``_sdpa``.  The route is decided from the
config and the arguments before K8 is launched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import layers
from repro_torch.obs import telemetry
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx as pctx

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    window: Optional[int] = None        # sliding-window size (None = full)
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    dtype: str = "bfloat16"
    scale: Optional[float] = None       # of the scores (None: hd ** -0.5)
    # Megatron-style GQA TP: under a mesh, repeat the KV heads across the
    # query groups so that K/V shard over the model axis with the query
    # heads.  It changes no result; without a mesh there is nothing to
    # shard and attend does not repeat them.
    tp_expand_heads: bool = False
    # round-trip the scores through bf16 after the f32 QK^T (a backward
    # lever of the reference; the forward keeps it)
    bf16_score_grad: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def init(gen: torch.Generator, cfg: AttnConfig) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    return {
        "wq": layers.dense_init(gen, cfg.d_model, cfg.q_dim, dt, cfg.qkv_bias),
        "wk": layers.dense_init(gen, cfg.d_model, cfg.kv_dim, dt,
                                cfg.qkv_bias),
        "wv": layers.dense_init(gen, cfg.d_model, cfg.kv_dim, dt,
                                cfg.qkv_bias),
        "wo": layers.dense_init(gen, cfg.q_dim, cfg.d_model, dt, False),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    # (B, n, T, hd); a DTensor's features gathered where n does not divide
    # over their shards
    return pctx.unflatten(x, -1, (n, hd)).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, n * hd)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int], kv_len: Optional[int] = None
               ) -> torch.Tensor:
    """(Tq, Tk) additive f32 mask from absolute positions."""
    ok = k_pos[None, :] >= 0  # ring-buffer slots never written are < 0
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    if kv_len is not None:
        ok = ok & (k_pos[None, :] < kv_len)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa(q, k, v, bias, softcap_val, scale, bf16_grad=False):
    """q (B,KV,G,Tq,hd), k/v (B,KV,Tk,hd), bias (Tq,Tk).

    The scores are f32 products of f32-cast inputs, as the reference's
    ``preferred_element_type=jnp.float32`` (a bf16 matmul in torch would
    round them to bf16); the probabilities go back to v's dtype for P V.
    """
    scores = torch.einsum("bkgqh,bkth->bkgqt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if bf16_grad:
        scores = scores.to(torch.bfloat16).to(torch.float32)
    scores = layers.softcap(scores, softcap_val)
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqt,bkth->bkgqh", probs.to(v.dtype), v)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window, softcap_val,
                    scale, kv_block: int, kv_len=None):
    """Online-softmax attention over key blocks of ``kv_block`` (a loop
    here, the reference's ``lax.scan``); q (B,KV,G,Tq,hd), k/v
    (B,KV,Tk,hd).  Peak memory (B,KV,G,Tq,kv_block) instead of (...,Tk);
    the running max, sum and output in f32."""
    b, kv_h, g, tq, hd = q.shape
    tk = k.shape[2]
    if tk % kv_block:
        raise ValueError(f"{tk} keys is not a whole number of "
                         f"{kv_block}-key blocks")
    qf = q.to(torch.float32)
    m = q.new_full((b, kv_h, g, tq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, kv_h, g, tq), dtype=torch.float32)
    acc = q.new_zeros((b, kv_h, g, tq, hd), dtype=torch.float32)
    for start in range(0, tk, kv_block):
        ks = k[:, :, start:start + kv_block]
        vs = v[:, :, start:start + kv_block]
        s = torch.einsum("bkgqh,bkth->bkgqt", qf,
                         ks.to(torch.float32)) * scale
        s = layers.softcap(s, softcap_val)
        s = s + _mask_bias(q_pos, k_pos[start:start + kv_block], causal,
                           window, kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,bkth->bkgqh", p.to(vs.dtype), vs).to(torch.float32)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _sdpa_blockwise_2d(q, k, v, q_pos, k_pos, causal, window, softcap_val,
                       scale, q_block: int, kv_block: int, kv_len=None):
    """``_sdpa_blockwise`` a block of ``q_block`` queries at a time: peak
    memory (B,KV,G,q_block,kv_block), whatever the sequence length (the
    reference's long-prefill / train path)."""
    tq = q.shape[3]
    if tq % q_block:
        raise ValueError(f"{tq} queries is not a whole number of "
                         f"{q_block}-query blocks")
    return torch.cat([
        _sdpa_blockwise(q[:, :, :, i:i + q_block], k, v,
                        q_pos[i:i + q_block], k_pos, causal, window,
                        softcap_val, scale, kv_block, kv_len)
        for i in range(0, tq, q_block)], dim=3)


def flash_route(cfg: AttnConfig, *, positions=None, kv_x=None,
                kv_positions=None, cache=None, kv_block=None,
                t: Optional[int] = None, grad: bool = False,
                dtype: Optional[torch.dtype] = None) -> bool:
    """True where ``attend`` runs K8: self-attention, causal or not, over
    positions 0..T-1 with no cache, softcap, bf16 score round trip or
    blockwise path, and no window unless the sequence length ``t`` fits
    inside it (causal over 0..T-1 with T <= window, the band ``k > q -
    window`` masks nothing).  Where autograd will differentiate through
    it (``grad``: grad enabled and q, k or v requiring it), only where
    the inputs' ``dtype`` is bf16 and ``head_dim`` 64 or 128, the Hopper
    route that has a backward.  A head size the kernel does not take
    raises there; it does not send the prefill to ``_sdpa``."""
    return (kv_x is None and cache is None and kv_block is None
            and positions is None and kv_positions is None
            and (cfg.window is None or (t is not None and t <= cfg.window))
            and cfg.logit_softcap is None and not cfg.bf16_score_grad
            and (not grad or (dtype == torch.bfloat16 and cfg.head_dim
                              in flash_kernel.GRAD_HEAD_DIMS)))


@telemetry.span("attention")
def attend(
    params: dict,
    x: torch.Tensor,
    cfg: AttnConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_x: Optional[torch.Tensor] = None,     # cross-attention source
    kv_positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,            # decode: {"k","v","pos"}
    kv_block: Optional[int] = None,          # blockwise path when set
    q_block: Optional[int] = None,           # + q-chunking when set
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (output (B,T,d), updated cache or None).

    ``positions=None`` means 0..T-1.  With a cache, the new K/V are written
    into the cache's buffers in place (the reference returns new ones);
    the returned cache holds the same buffers and the next position.
    ``kv_block`` takes the blockwise path, over query blocks too where
    ``q_block`` divides T and T > ``q_block``, as in the reference.
    """
    b, t, _ = x.shape
    g = cfg.num_heads // cfg.num_kv_heads
    scale = cfg.head_dim ** -0.5 if cfg.scale is None else cfg.scale
    src = x if kv_x is None else kv_x
    # autograd differentiates through q, k and v where any of their
    # sources requires grad: then K8 runs with its backward, where it has one
    grad = torch.is_grad_enabled() and any(
        z.requires_grad for z in (x, src, *params["wq"].values(),
                                  *params["wk"].values(),
                                  *params["wv"].values()))
    use_flash = flash_route(cfg, positions=positions, kv_x=kv_x,
                            kv_positions=kv_positions, cache=cache,
                            kv_block=kv_block, t=t, grad=grad, dtype=x.dtype)

    tp = pctx.shard_batch_tp
    q = _split_heads(tp(layers.dense(params["wq"], x)), cfg.num_heads,
                     cfg.head_dim)
    k = _split_heads(tp(layers.dense(params["wk"], src)), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(tp(layers.dense(params["wv"], src)), cfg.num_kv_heads,
                     cfg.head_dim)

    if positions is None:
        positions = torch.arange(t, device=x.device)
    if kv_positions is None:
        kv_positions = positions if kv_x is None else torch.arange(
            src.shape[1], device=x.device)

    if cfg.use_rope and kv_x is None:
        qc, qs = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = layers.apply_rope(q, qc, qs)
        kc, ks_ = layers.rope_angles(kv_positions, cfg.head_dim,
                                     cfg.rope_theta)
        k = layers.apply_rope(k, kc, ks_)

    new_cache = None
    kv_len = None
    if cache is not None:
        # Decode: write the new K/V into the cache ring and attend over the
        # buffer with a validity mask.  The buffer may be smaller than the
        # sequence (sliding-window cache): slot = pos % buf, and each slot's
        # absolute position is recovered for masking; unwritten slots get
        # negative positions and are masked out.
        pos = int(cache["pos"])
        ck, cv = cache["k"], cache["v"]
        buf = ck.shape[2]
        slot = pos % buf
        if slot + t > buf:
            # the reference's dynamic_update_slice would clamp the start
            raise ValueError(f"writing {t} tokens at slot {slot} overruns the "
                             f"{buf}-slot cache")
        # in place; a sharded cache on the ranks that hold the slots
        coll.write_slice(ck, k, slot, 2)
        coll.write_slice(cv, v, slot, 2)
        k, v = ck, cv
        slots = torch.arange(buf, device=x.device)
        last_write = pos + t - 1
        kv_positions = last_write - torch.remainder(last_write - slots, buf)
        kv_len = pos + t
        new_cache = {"k": ck, "v": cv, "pos": pos + t}

    if cfg.tp_expand_heads and g > 1 and pctx.current() is not None:
        k = torch.repeat_interleave(k, g, dim=1)        # (B, H, Tk, hd)
        v = torch.repeat_interleave(v, g, dim=1)
        k, v = pctx.shard_heads(k), pctx.shard_heads(v)
        kv_heads = cfg.num_heads
    else:
        kv_heads = cfg.num_kv_heads
    q = pctx.shard_heads(q)
    g = cfg.num_heads // kv_heads

    def core(q, k, v):
        if use_flash and grad:
            return flash_kernel.flash_attention_autograd(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=cfg.causal, group=g, scale=scale)
        if use_flash:
            # K8 at the real T: the kernel masks a ragged last tile itself
            return flash_kernel.flash_attention_launch(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=cfg.causal, group=g, scale=cfg.scale)
        bl, hl = q.shape[:2]
        qg = q.reshape(bl, hl // g, g, t, cfg.head_dim)
        causal = cfg.causal and kv_x is None
        if kv_block is not None and q_block is not None \
                and t % q_block == 0 and t > q_block:
            out = _sdpa_blockwise_2d(qg, k, v, positions, kv_positions,
                                     causal, cfg.window, cfg.logit_softcap,
                                     scale, q_block, kv_block, kv_len)
        elif kv_block is not None:
            out = _sdpa_blockwise(qg, k, v, positions, kv_positions, causal,
                                  cfg.window, cfg.logit_softcap, scale,
                                  kv_block, kv_len)
        else:
            bias = _mask_bias(positions, kv_positions, causal, cfg.window,
                              kv_len)
            out = _sdpa(qg, k, v, bias, cfg.logit_softcap, scale,
                        bf16_grad=cfg.bf16_score_grad)
        return out.reshape(bl, hl, t, cfg.head_dim)

    # under a mesh, on each rank's (batch, heads) shard
    out = coll.per_head(core, (q, k, v), [("act", 1)] * 3, 1)
    out = out.to(x.dtype).reshape(b, cfg.num_heads, t, cfg.head_dim)
    merged = pctx.shard_batch_tp(_merge_heads(out))
    return layers.dense(params["wo"], merged), new_cache


def cross_cached(params: dict, x: torch.Tensor, cfg: AttnConfig,
                 k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B, T, d) against K/V projected once
    (B, KV, Tk, hd): the reference's ``_cross_from_cache``
    (``transformer.py``) and ``_cross_cached`` (``whisper.py``), one
    function here.  No mask, softcap or RoPE; f32 scores, as ``_sdpa``."""
    t = x.shape[1]
    q = _split_heads(layers.dense(params["wq"], x), cfg.num_heads,
                     cfg.head_dim)

    def core(q, k, v):
        bl, hl = q.shape[:2]
        qg = q.reshape(bl, k.shape[1], hl // k.shape[1], t, cfg.head_dim)
        scores = torch.einsum("bkgqh,bkth->bkgqt", qg.to(torch.float32),
                              k.to(torch.float32)) * cfg.head_dim ** -0.5
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqt,bkth->bkgqh", probs.to(v.dtype), v)
        return out.reshape(bl, hl, t, cfg.head_dim)

    # under a mesh, on each rank's (batch, heads) shard
    out = coll.per_head(core, (q, k, v), [("act", 1)] * 3, 1)
    return layers.dense(params["wo"], _merge_heads(out))


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Decode KV cache buffers.  For windowed layers the buffer is the
    window size (sliding-window cache)."""
    buf = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, cfg.num_kv_heads, buf, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
