"""The causal LM for dense and MoE models: the reference's ``CausalLM`` on
one card.

The reference expresses every architecture as ``n_groups`` repetitions of
a small group of sub-blocks and scans over stacked parameters.  Here the
layers are a Python loop over per-layer parameter dicts
(``params["layers"][i]``, the same keys as one group slice of the
reference's ``params["groups"]["sub0"]``; ``convert.lm_params_from_numpy``
unstacks them).  The plan is kept, so that an architecture this slice
does not serve is refused by name:

  dense            group = ("attn",) x L                  ported
  moe              group = ("attn",) x L, expert FFN       ported
  gemma2           group = ("attn_local", "attn_global")   "gemma2"
  llama-vision     ("attn",)*5 + ("cross",)                "VLM and Whisper"
  rwkv6 / zamba2   ("rwkv",) / ("mamba",)*k + shared attn  "rwkv6 and mamba2"

(A refused plan names the ROADMAP queue 1 item that ports it, by title.)

Each layer's prefill attention runs K8 (``attention.flash_route``); the
decode step attends over the KV cache with the plain ``_sdpa``.  An MoE
layer's FFN is ``moe.apply_local`` in both: K7 counts its dispatch and K5
sums its combine.  Its capacity is reckoned from the tokens of the call,
as in the reference, so a decode step of a few tokens drops more rows
than the prefill of the same tokens does, and their logits differ by
design unless the capacity factor is large enough that nothing drops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mlp, moe

SERVED_KINDS = ("attn",)
# ROADMAP queue 1's item, by title, that ports each refused layer kind
PORTED_BY = {"attn_local": "gemma2", "attn_global": "gemma2",
             "cross": "VLM and Whisper", "audio": "VLM and Whisper",
             "rwkv": "rwkv6 and mamba2", "mamba": "rwkv6 and mamba2",
             "shared_attn": "rwkv6 and mamba2"}


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    group_kinds: tuple[str, ...]
    n_groups: int
    tail_kinds: tuple[str, ...] = ()


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    if cfg.rwkv:
        return LayerPlan(("rwkv",), cfg.num_layers)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_state:
        if cfg.attn_every:
            k = cfg.attn_every
            n = cfg.num_layers // k
            tail = cfg.num_layers - n * k
            return LayerPlan(("mamba",) * k + ("shared_attn",), n,
                             ("mamba",) * tail)
        return LayerPlan(("mamba",), cfg.num_layers)
    if cfg.cross_attn_every:
        k = cfg.cross_attn_every
        assert cfg.num_layers % k == 0
        return LayerPlan(("attn",) * k + ("cross",), cfg.num_layers // k)
    if cfg.attn_pattern == "local_global":
        assert cfg.num_layers % 2 == 0
        return LayerPlan(("attn_local", "attn_global"), cfg.num_layers // 2)
    return LayerPlan(("attn",), cfg.num_layers)


def check_served(cfg: ModelConfig) -> None:
    """Raise for what this slice does not serve: layer kinds other than
    attention (with a dense or an expert FFN), and the audio family."""
    plan = layer_plan(cfg)
    kinds = sorted(set(plan.group_kinds + plan.tail_kinds)
                   - set(SERVED_KINDS))
    if cfg.family == "audio":
        kinds.append("audio")
    if kinds:
        items = ", ".join(f'"{t}"' for t in
                          sorted({PORTED_BY[k] for k in kinds}))
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(kinds)} not ported yet (ROADMAP queue "
            f"1, {items})")


def _attn_cfg(cfg: ModelConfig, kind: str) -> attention.AttnConfig:
    window = cfg.window if kind == "attn_local" else None
    if kind == "shared_attn" and cfg.family == "hybrid":
        window = cfg.window
    return attention.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, logit_softcap=cfg.attn_softcap,
        window=window, causal=True, rope_theta=cfg.rope_theta,
        use_rope=kind != "cross", dtype=cfg.dtype,
        tp_expand_heads=cfg.attn_tp_expand,
        bf16_score_grad=cfg.attn_bf16_score_grad)


def _moe_cfg(cfg: ModelConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model, d_expert=cfg.d_expert,
        num_experts=cfg.num_experts, top_k=cfg.top_k,
        num_shared_experts=cfg.num_shared_experts,
        activation=cfg.activation, dtype=cfg.dtype,
        capacity_factor=cfg.moe_capacity_factor,
        bf16_combine=cfg.moe_bf16_combine)


def _norm_init(cfg: ModelConfig, device, d=None) -> dict:
    d = d or cfg.d_model
    dt = layers.torch_dtype(cfg.dtype)
    return (layers.rmsnorm_init(d, dt, device) if cfg.norm == "rmsnorm"
            else layers.layernorm_init(d, dt, device))


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return (layers.rmsnorm(p, x) if cfg.norm == "rmsnorm"
            else layers.layernorm(p, x))


# ---------------------------------------------------------------------------
# Sub-blocks: attention + gated MLP or experts
# ---------------------------------------------------------------------------


def _sub_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    p = {"norm1": _norm_init(cfg, gen.device),
         "attn": attention.init(gen, _attn_cfg(cfg, kind)),
         "norm2": _norm_init(cfg, gen.device)}
    p["ffn"] = (moe.init(gen, _moe_cfg(cfg)) if cfg.is_moe
                else mlp.init(gen, cfg.d_model, cfg.d_ff, dt, cfg.activation))
    return p


def _ffn_apply(cfg: ModelConfig, p: dict, h: torch.Tensor):
    """Returns (out, aux, dispatch ids or None)."""
    if not cfg.is_moe:
        return mlp.apply(p, h, cfg.activation), 0.0, None
    b, s, d = h.shape
    out, aux, disp = moe.apply_local(p, h.reshape(b * s, d), _moe_cfg(cfg))
    return out.reshape(b, s, d), aux, disp


def _sub_apply(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor, *,
               cache: Optional[dict], positions=None):
    """One pre-norm block.  Returns (h, aux, new_cache)."""
    attn_out, new_cache = attention.attend(
        p["attn"], _norm(cfg, p["norm1"], h), _attn_cfg(cfg, kind),
        positions=positions, cache=cache)
    h = h + attn_out
    ffn_out, aux, _ = _ffn_apply(cfg, p["ffn"], _norm(cfg, p["norm2"], h))
    return h + ffn_out, aux, new_cache


def _sub_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               device) -> dict:
    c = attention.init_cache(_attn_cfg(cfg, kind), batch, max_len,
                             layers.torch_dtype(cfg.dtype), device)
    return {"k": c["k"], "v": c["v"]}  # pos passed per step


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class CausalLM:
    """Dense or MoE causal LM on ``device`` (default the card)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        check_served(cfg)
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.device = torch.device(device)
        self.kinds = (self.plan.group_kinds * self.plan.n_groups
                      + self.plan.tail_kinds)

    # -- init ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen``, which must live on the
        model's device (the tensors are drawn there)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dt = layers.torch_dtype(cfg.dtype)
        params: dict[str, Any] = {
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
            "final_norm": _norm_init(cfg, gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                                  cfg.padded_vocab, dt)
        params["layers"] = [_sub_init(gen, cfg, kind) for kind in self.kinds]
        return params

    # -- forward ------------------------------------------------------------

    def hidden(self, params, tokens: torch.Tensor):
        """Final-norm hidden states (B, T, d) and the sum of the layers'
        MoE aux losses (0.0 for a dense model).

        The layers attend over positions 0..T-1, the route that runs K8.
        """
        h = layers.embed(params["embed"], tokens)
        aux = 0.0
        for kind, p in zip(self.kinds, params["layers"]):
            h, a, _ = _sub_apply(self.cfg, kind, p, h, cache=None)
            aux = aux + a
        return _norm(self.cfg, params["final_norm"], h), aux

    def unembed_logits(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = (layers.unembed(params["embed"], h) if cfg.tie_embeddings
                  else layers.dense(params["lm_head"], h))
        return layers.softcap(logits.to(torch.float32), cfg.final_softcap)

    def forward(self, params, tokens: torch.Tensor):
        h, aux = self.hidden(params, tokens)
        return self.unembed_logits(params, h), aux

    # -- serving ------------------------------------------------------------

    def init_cache(self, params, batch: int, max_len: int) -> dict:
        del params  # dense layers need none; the reference's cross layers do
        return {"layers": [_sub_cache(self.cfg, kind, batch, max_len,
                                      self.device) for kind in self.kinds]}

    def decode_step(self, params, tokens: torch.Tensor, cache: dict, *,
                    pos: int):
        """tokens (B, 1); pos: the absolute position of the token.

        Returns (logits (B, 1, V) f32, the cache).  The cache's buffers are
        written in place.
        """
        pos = int(pos)
        h = layers.embed(params["embed"], tokens)
        positions = pos + torch.arange(tokens.shape[1], device=h.device)
        new_layers = []
        for kind, p, c in zip(self.kinds, params["layers"], cache["layers"]):
            h, _, nc = _sub_apply(self.cfg, kind, p, h,
                                  cache=dict(c, pos=pos), positions=positions)
            new_layers.append({"k": nc["k"], "v": nc["v"]})
        h = _norm(self.cfg, params["final_norm"], h)
        return self.unembed_logits(params, h), {"layers": new_layers}
