"""Grouped-query attention with the variants the assigned archs need.

Flags: QKV bias (qwen), attention-logit softcap (gemma2), sliding window
(gemma2 local layers / zamba2 long-context), cross-attention
(whisper/llama-vision), bidirectional (whisper encoder) and KV-cache
decode.  The blockwise path of the reference (``attn_impl="blockwise"``)
is not ported yet.

Shape conventions: activations (B, T, d); Q heads H, KV heads KV with
H % KV == 0; per-head dim ``head_dim``.

Routes.  Causal self-attention over a whole sequence without a cache (the
prefill) runs the flash-attention kernel K8 (``flash_route``); everything
else — decode against the cache, windows, softcaps, cross-attention —
runs the plain ``_sdpa``, as in the reference.  The route is decided from
the config and the arguments before anything is launched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import layers

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
    # Megatron-style GQA TP in the reference: replicate KV heads across the
    # query groups.  A sharding lever that changes no result; one card
    # has nothing to shard, so attend ignores it.
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
    b, t, _ = x.shape
    return x.reshape(b, t, n, hd).transpose(1, 2)  # (B, n, T, hd)


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


def flash_route(cfg: AttnConfig, *, positions=None, kv_x=None,
                kv_positions=None, cache=None, kv_block=None) -> bool:
    """True where ``attend`` runs K8: causal self-attention over positions
    0..T-1 with no cache, window, softcap, bf16 score round trip or
    blockwise path.  A head size the kernel does not take raises there;
    it does not send the prefill to ``_sdpa``."""
    return (cfg.causal and kv_x is None and cache is None and kv_block is None
            and positions is None and kv_positions is None
            and cfg.window is None and cfg.logit_softcap is None
            and not cfg.bf16_score_grad)


def attend(
    params: dict,
    x: torch.Tensor,
    cfg: AttnConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_x: Optional[torch.Tensor] = None,     # cross-attention source
    kv_positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,            # decode: {"k","v","pos"}
    kv_block: Optional[int] = None,          # blockwise path: raises
    q_block: Optional[int] = None,           # + q-chunking: raises
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (output (B,T,d), updated cache or None).

    ``positions=None`` means 0..T-1.  With a cache, the new K/V are written
    into the cache's buffers in place (the reference returns new ones);
    the returned cache holds the same buffers and the next position.
    """
    b, t, _ = x.shape
    g = cfg.num_heads // cfg.num_kv_heads
    scale = cfg.head_dim ** -0.5
    use_flash = flash_route(cfg, positions=positions, kv_x=kv_x,
                            kv_positions=kv_positions, cache=cache,
                            kv_block=kv_block)

    q = _split_heads(layers.dense(params["wq"], x), cfg.num_heads,
                     cfg.head_dim)
    src = x if kv_x is None else kv_x
    k = _split_heads(layers.dense(params["wk"], src), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(layers.dense(params["wv"], src), cfg.num_kv_heads,
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
        ck[:, :, slot:slot + t] = k
        cv[:, :, slot:slot + t] = v
        k, v = ck, cv
        slots = torch.arange(buf, device=x.device)
        last_write = pos + t - 1
        kv_positions = last_write - torch.remainder(last_write - slots, buf)
        kv_len = pos + t
        new_cache = {"k": ck, "v": cv, "pos": pos + t}

    if use_flash:
        # K8 at the real T: the kernel masks a ragged last tile itself
        out = flash_kernel.flash_attention_launch(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            group=g)
    else:
        if kv_block is not None:
            raise NotImplementedError(
                "blockwise attention (kv_block, q_block) is not ported yet: "
                "ROADMAP queue 1, \"Blockwise attention\"")
        qg = q.reshape(b, cfg.num_kv_heads, g, t, cfg.head_dim)
        causal = cfg.causal and kv_x is None
        bias = _mask_bias(positions, kv_positions, causal, cfg.window, kv_len)
        out = _sdpa(qg, k, v, bias, cfg.logit_softcap, scale,
                    bf16_grad=cfg.bf16_score_grad)
    out = out.to(x.dtype).reshape(b, cfg.num_heads, t, cfg.head_dim)
    return layers.dense(params["wo"], _merge_heads(out)), new_cache


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Decode KV cache buffers.  For windowed layers the buffer is the
    window size (sliding-window cache)."""
    buf = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, cfg.num_kv_heads, buf, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
