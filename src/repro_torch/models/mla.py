"""Multi-head latent attention (MLA), DeepSeek-V3's mixer.

For x (B, T, d), each norm an RMSNorm (``norm_eps``):

  q = wq_b(q_norm(wq_a(x)))            per head: q_nope (dn), q_pe (dr)
  [c_kv, k_pe] = wkv_a(x)              widths kv_lora_rank and dr; one k_pe
                                       for all heads
  c_kv = kv_norm(c_kv)                 the latent, which decode caches
  [k_nope, v] = wkv_b(c_kv)            per head dn and dv
  q_pe, k_pe rotated over adjacent pairs at YaRN's frequencies
  k = [k_nope, k_pe], q = [q_nope, q_pe]
  out = wo(causal softmax(q k^T · scale) v)

with scale = (dn + dr)^-0.5 · m², m = 0.1 · mscale_all_dim · ln(factor) + 1
(YaRN's temperature; DeepSeek-V3: 192^-0.5 · 1.3689² = 0.13523).  The
published YaRN also multiplies the rotation's cos and sin by the ratio of
the temperatures at ``rope_scaling.mscale`` and at ``mscale_all_dim``; the
port has no ``mscale`` and so takes that ratio as 1, as it is for
DeepSeek-V3 (both 1) and in DeepSeek's own inference code.

The prefill attends at q·k head size dn + dr and v head size dv through
K8 (``flash_attention_launch``, the bf16 Hopper route at (192, 128) on the
card, the plain version on the CPU) with one KV head a query head.  Under
autograd it runs the plain ``attention._sdpa``: K8 has no backward at
these head sizes.  The prefill returns no cache of its own; a decode
step's cache is the latent, ``{"c_kv": (B, max_len, kv_lora_rank),
"k_pe": (B, max_len, dr)}`` (576 values a token at DeepSeek-V3's sizes,
where per-head K and V would be 128 x 320), written in place at the
step's position.  A step attends in the latent: ``wkv_b``'s key half is
absorbed into q (q_nope wkv_b_k^T · c_kv = q_nope · k_nope) and its value
half applied after the weighted sum over the cached c_kv, in f32.

Spans: ``mla`` around the mixer, ``mla.attend`` around the attention core
(``attend_core``: K8 or ``_sdpa``; or a decode step's latent attention).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import attention, layers
from repro_torch.obs import telemetry


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float = 10000.0
    rope_factor: float = 1.0
    rope_original_max: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        """The softmax scale: qk_head_dim^-0.5, times YaRN's temperature
        squared where ``mscale_all_dim`` is set."""
        m = (layers.yarn_mscale(self.rope_factor, self.mscale_all_dim)
             if self.mscale_all_dim else 1.0)
        return self.qk_head_dim ** -0.5 * m * m


def init(gen: torch.Generator, cfg: MLAConfig) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    d, h = cfg.d_model, cfg.num_heads
    return {
        "wq_a": layers.dense_init(gen, d, cfg.q_lora_rank, dt),
        "q_norm": layers.rmsnorm_init(cfg.q_lora_rank, dt, gen.device),
        "wq_b": layers.dense_init(gen, cfg.q_lora_rank, h * cfg.qk_head_dim,
                                  dt),
        "wkv_a": layers.dense_init(
            gen, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dt),
        "kv_norm": layers.rmsnorm_init(cfg.kv_lora_rank, dt, gen.device),
        "wkv_b": layers.dense_init(
            gen, cfg.kv_lora_rank,
            h * (cfg.qk_nope_head_dim + cfg.v_head_dim), dt),
        "wo": layers.dense_init(gen, h * cfg.v_head_dim, d, dt),
    }


def init_cache(cfg: MLAConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The latent decode cache: normed c_kv and rotated k_pe of every
    position."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                dtype=dtype, device=device)}


@telemetry.span("mla.attend")
def attend_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Causal attention of (B, H, T, dqk) q and k over (B, H, T, dv) v:
    K8 without a gradient, ``_sdpa`` (f32 scores) under autograd."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        t = q.shape[2]
        pos = torch.arange(t, device=q.device)
        bias = attention._mask_bias(pos, pos, True, None)
        return attention._sdpa(q[:, :, None], k, v, bias, None,
                                scale)[:, :, 0].to(q.dtype)
    return flash_kernel.flash_attention_launch(q, k, v, causal=True, group=1,
                                               scale=scale)


@telemetry.span("mla.attend")
def _attend_latent(q_nope: torch.Tensor, q_pe: torch.Tensor, c_kv, k_pe,
                   w_kv: torch.Tensor, pos: int, cfg: MLAConfig
                   ) -> torch.Tensor:
    """A decode step's attention over the cached latent, in f32: q_nope
    (B, T, H, dn) and q_pe (B, T, H, dr) at positions pos..pos+T-1 against
    the first pos + T positions of c_kv (B, L, c) and k_pe (B, L, dr);
    ``w_kv`` is ``wkv_b`` as (c, H, dn + dv).  Returns (B, T, H, dv)."""
    dn = cfg.qk_nope_head_dim
    f32 = torch.float32
    t = q_nope.shape[1]
    w = w_kv.to(f32)
    lat = c_kv[:, :pos + t].to(f32)
    q_lat = torch.einsum("bthd,chd->bthc", q_nope.to(f32), w[..., :dn])
    s = (torch.einsum("bthc,bsc->bhts", q_lat, lat)
         + torch.einsum("bthr,bsr->bhts", q_pe.to(f32),
                        k_pe[:, :pos + t].to(f32))) * cfg.scale
    q_pos = pos + torch.arange(t, device=s.device)
    k_pos = torch.arange(pos + t, device=s.device)
    s = s + attention._mask_bias(q_pos, k_pos, True, None)
    o_lat = torch.einsum("bhts,bsc->bthc", torch.softmax(s, dim=-1), lat)
    return torch.einsum("bthc,chd->bthd", o_lat, w[..., dn:])


def _project(p: dict, x: torch.Tensor, cfg: MLAConfig, pos: int):
    """x (B, T, d) at positions pos..pos+T-1: (q (B, T, H, dn + dr) with
    its rotary part rotated, the normed latent c_kv (B, T, kv_lora_rank),
    the rotated k_pe (B, T, dr))."""
    b, t, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    eps = cfg.norm_eps
    q = layers.dense(p["wq_b"], layers.rmsnorm(
        p["q_norm"], layers.dense(p["wq_a"], x), eps)).view(
            b, t, cfg.num_heads, dn + dr)
    c_kv, k_pe = layers.dense(p["wkv_a"], x).split(
        [cfg.kv_lora_rank, dr], dim=-1)
    c_kv = layers.rmsnorm(p["kv_norm"], c_kv, eps)
    cos, sin = layers.yarn_angles(
        pos + torch.arange(t, device=x.device), dr, cfg.rope_theta,
        cfg.rope_factor, cfg.rope_original_max, cfg.beta_fast, cfg.beta_slow)
    q[..., dn:] = layers.apply_rope_pairs(q[..., dn:], cos[:, None],
                                          sin[:, None])
    return q, c_kv, layers.apply_rope_pairs(k_pe, cos, sin)


def heads(p: dict, x: torch.Tensor, cfg: MLAConfig):
    """The prefill's attention inputs over x (B, T, d) at positions
    0..T-1: q and k (B, H, T, dn + dr) and v (B, H, T, dv), contiguous."""
    b, t, _ = x.shape
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q, c_kv, k_pe = _project(p, x, cfg, 0)
    kv = layers.dense(p["wkv_b"], c_kv).view(b, t, h, dn + dv)
    k = q.new_empty((b, h, t, q.shape[-1]))
    k[..., :dn] = kv[..., :dn].transpose(1, 2)
    k[..., dn:] = k_pe[:, None]
    return (q.transpose(1, 2).contiguous(), k,
            kv[..., dn:].transpose(1, 2).contiguous())


@telemetry.span("mla")
def attend(p: dict, x: torch.Tensor, cfg: MLAConfig, *,
           cache: Optional[dict] = None) -> tuple[torch.Tensor,
                                                  Optional[dict]]:
    """Returns (output (B, T, d), the cache or None).  Without a cache
    (the prefill) over positions 0..T-1; with one (``{"c_kv", "k_pe",
    "pos"}``) at positions pos.., its buffers written in place."""
    b, t, _ = x.shape
    h, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    if cache is None:
        out = attend_core(*heads(p, x, cfg), cfg.scale)
        return layers.dense(p["wo"], out.transpose(1, 2).reshape(
            b, t, h * dv)), None
    pos = int(cache["pos"])
    cc, cp = cache["c_kv"], cache["k_pe"]
    if pos + t > cc.shape[1]:
        raise ValueError(f"writing {t} tokens at {pos} overruns the "
                         f"{cc.shape[1]}-position cache")
    q, c_kv, k_pe = _project(p, x, cfg, pos)
    cc[:, pos:pos + t] = c_kv
    cp[:, pos:pos + t] = k_pe
    out = _attend_latent(q[..., :dn], q[..., dn:], cc, cp,
                         p["wkv_b"]["w"].view(-1, h, dn + dv), pos, cfg)
    return (layers.dense(p["wo"], out.to(x.dtype).reshape(b, t, h * dv)),
            {"c_kv": cc, "k_pe": cp, "pos": pos + t})
