"""The causal LM for the dense, MoE, gemma2, VLM, RWKV-6 and zamba2
families: the reference's ``CausalLM`` on one card.

The reference expresses every architecture as ``n_groups`` repetitions of
a small group of sub-blocks (and an optional ragged tail) and scans over
stacked parameters.  Here the layers are a Python loop over per-layer
parameter dicts (``params["layers"][i]``, the same keys as one group
slice of the reference's ``params["groups"][f"sub{i}"]``; layer
``g * k + i`` is group ``g``'s sub-block ``i`` of ``k``, the tail's
layers follow the groups, and ``convert.lm_params_from_numpy`` unstacks
them):

  dense            group = ("attn",) x L                  ported
  moe              group = ("attn",) x L, expert FFN       ported
  gemma2           group = ("attn_local", "attn_global")   ported
  llama-vision     ("attn",)*5 + ("cross",)                ported
  rwkv6            ("rwkv",) x L                           ported
  zamba2           ("mamba",)*k + ("shared_attn",) x L//k, ported
                   tail ("mamba",) x L%k

zamba2's ``shared_attn`` weights are held once, in
``params["shared_attn"]``, as in the reference; its entries in
``params["layers"]`` are empty dicts, so that a walk over the tree
counts those weights once.  Each invocation has its own KV cache (a
window ring).  The Whisper family is ``models/whisper.py``.

A plain ``attn`` layer's prefill attention runs K8
(``attention.flash_route``), and so does zamba2's shared attention while
the prompt fits inside its window; gemma2's layers, all softcapped (and
the local ones windowed), and the gated ``cross`` layers, which attend
to the image K/V, run the plain ``_sdpa``, as does every decode step.  A
cross layer's image K/V are projected once, into its cache.  An MoE
layer's FFN is ``moe.apply_local`` in both: K7 counts its dispatch and
K5 sums its combine.  Its capacity is reckoned from the tokens of the
call, as in the reference, so a decode step of a few tokens drops more
rows than the prefill of the same tokens does, and their logits differ
by design unless the capacity factor is large enough that nothing drops.
RWKV-6's WKV and Mamba-2's SSD and causal convolution are plain torch
(``models/rwkv6.py``, ``models/mamba2.py``); their decode caches carry
state, not keys: ``{"s", "last", "cm_last"}`` and ``{"h", "conv"}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (attention, layers, loops, mamba2, mlp,
                                moe, rwkv6)
from repro_torch.parallel import ctx as pctx

# the layer kinds whose decode cache is a KV buffer written at a position
ATTN_KINDS = ("attn", "attn_local", "attn_global", "shared_attn")


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
    """Raise for the audio family: it is ``whisper.WhisperModel``."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: use whisper.WhisperModel for audio")


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


def _rwkv_cfg(cfg: ModelConfig) -> rwkv6.RWKVConfig:
    return rwkv6.RWKVConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                            dtype=cfg.dtype)


def _mamba_cfg(cfg: ModelConfig) -> mamba2.Mamba2Config:
    return mamba2.Mamba2Config(d_model=cfg.d_model, state_dim=cfg.ssm_state,
                               head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                               dtype=cfg.dtype)


def _norm_init(cfg: ModelConfig, device, d=None) -> dict:
    d = d or cfg.d_model
    dt = layers.torch_dtype(cfg.dtype)
    return (layers.rmsnorm_init(d, dt, device) if cfg.norm == "rmsnorm"
            else layers.layernorm_init(d, dt, device))


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return (layers.rmsnorm(p, x) if cfg.norm == "rmsnorm"
            else layers.layernorm(p, x))


# ---------------------------------------------------------------------------
# Sub-blocks: attention + gated MLP or experts; gated cross-attention;
# RWKV-6 time and channel mix; Mamba-2
# ---------------------------------------------------------------------------


def _sub_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    if kind == "rwkv":
        return {"norm1": _norm_init(cfg, gen.device),
                "norm2": _norm_init(cfg, gen.device),
                "mix": rwkv6.init(gen, _rwkv_cfg(cfg))}
    if kind == "mamba":
        return {"norm": _norm_init(cfg, gen.device),
                "ssm": mamba2.init(gen, _mamba_cfg(cfg))}
    p = {"norm1": _norm_init(cfg, gen.device),
         "attn": attention.init(gen, _attn_cfg(cfg, kind)),
         "norm2": _norm_init(cfg, gen.device)}
    if cfg.is_moe and kind not in ("cross", "shared_attn"):
        p["ffn"] = moe.init(gen, _moe_cfg(cfg))
    else:
        p["ffn"] = mlp.init(gen, cfg.d_model, cfg.d_ff, dt, cfg.activation)
    if kind == "cross":  # tanh gates, closed at init as in the reference
        p["gate_attn"] = torch.zeros((), dtype=torch.float32,
                                     device=gen.device)
        p["gate_ffn"] = torch.zeros((), dtype=torch.float32,
                                    device=gen.device)
    return p


def _ffn_apply(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor):
    """Returns (out, aux, dispatch ids or None).  Under a mesh an MoE
    layer takes the reference's mesh paths: ``apply_ep`` (experts over
    the last data axis) where ``use_ep``, else ``apply_sharded``."""
    if kind in ("cross", "shared_attn") or not cfg.is_moe:
        return mlp.apply(p, h, cfg.activation), 0.0, None
    mesh_ctx = pctx.current()
    mcfg = _moe_cfg(cfg)
    if mesh_ctx is None:
        b, s, d = h.shape
        out, aux, disp = moe.apply_local(p, h.reshape(b * s, d), mcfg)
        return out.reshape(b, s, d), aux, disp
    if mcfg.use_ep:
        return moe.apply_ep(p, h, mcfg, mesh_ctx.mesh,
                            data_axes=mesh_ctx.data_axes,
                            tp_axis=mesh_ctx.tp_axis,
                            ep_axis=mesh_ctx.data_axes[-1])
    return moe.apply_sharded(p, h, mcfg, mesh_ctx.mesh,
                             data_axes=mesh_ctx.data_axes,
                             tp_axis=mesh_ctx.tp_axis)


def _rwkv_apply(cfg: ModelConfig, p: dict, h: torch.Tensor,
                cache: Optional[dict]):
    """Time mix then channel mix, each pre-norm with a residual.  With a
    cache (decode), each token shift reads its ``last`` from it: the
    time mix the previous step's normed block input, the channel mix its
    normed ``x2``."""
    rc = _rwkv_cfg(cfg)
    x1 = _norm(cfg, p["norm1"], h)
    if cache is None:
        h = h + rwkv6.time_mix(p["mix"], x1, rc, impl=cfg.rwkv_impl)
        x2 = _norm(cfg, p["norm2"], h)
        return h + rwkv6.channel_mix(p["mix"], x2), None
    tm, st = rwkv6.time_mix_decode(
        p["mix"], x1, {"s": cache["s"], "last": cache["last"]}, rc)
    h = h + tm
    x2 = _norm(cfg, p["norm2"], h)
    h = h + rwkv6.channel_mix(p["mix"], x2, last=cache["cm_last"])
    return h, {"s": st["s"], "last": st["last"], "cm_last": x2[:, 0, :]}


def _sub_apply(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor, *,
               cache: Optional[dict], positions=None, image_embeds=None,
               kv_block=None, q_block=None):
    """One pre-norm block.  Returns (h, aux, new_cache); ``cache=None``
    is the prefill.

    A cross layer attends to ``image_embeds`` (its cache: their K/V,
    projected once) and adds both branches through tanh gates; its cache
    comes back as it went in.  ``rwkv`` and ``mamba`` layers return their
    stepped state in decode.  ``kv_block``/``q_block`` (the blockwise
    path) reach every self-attention, not the cross layers', as in the
    reference."""
    if kind == "rwkv":
        h, new_cache = _rwkv_apply(cfg, p, h, cache)
        return h, 0.0, new_cache
    if kind == "mamba":
        xn = _norm(cfg, p["norm"], h)
        if cache is None:
            return h + mamba2.apply(p["ssm"], xn, _mamba_cfg(cfg)), 0.0, None
        out, st = mamba2.decode_step(p["ssm"], xn, cache, _mamba_cfg(cfg))
        return h + out, 0.0, st
    acfg = _attn_cfg(cfg, kind)
    xn = _norm(cfg, p["norm1"], h)
    if kind == "cross":
        if cache is not None:
            attn_out = attention.cross_cached(p["attn"], xn, acfg,
                                              cache["k"], cache["v"])
        else:
            attn_out, _ = attention.attend(p["attn"], xn, acfg,
                                           positions=positions,
                                           kv_x=image_embeds)
        h = h + torch.tanh(p["gate_attn"]).to(h.dtype) * attn_out
        ffn_out, aux, _ = _ffn_apply(cfg, kind, p["ffn"],
                                     _norm(cfg, p["norm2"], h))
        return (h + torch.tanh(p["gate_ffn"]).to(h.dtype) * ffn_out, aux,
                cache)
    attn_out, new_cache = attention.attend(p["attn"], xn, acfg,
                                           positions=positions, cache=cache,
                                           kv_block=kv_block, q_block=q_block)
    h = h + attn_out
    ffn_out, aux, _ = _ffn_apply(cfg, kind, p["ffn"],
                                 _norm(cfg, p["norm2"], h))
    return h + ffn_out, aux, new_cache


def _sub_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               device, p=None, image_embeds=None) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    if kind == "rwkv":
        st = rwkv6.init_state(_rwkv_cfg(cfg), batch, device)
        return {"s": st["s"], "last": st["last"].to(dt),
                "cm_last": st["cm_last"].to(dt)}
    if kind == "mamba":
        st = mamba2.init_state(_mamba_cfg(cfg), batch, device)
        return {"h": st["h"], "conv": st["conv"].to(dt)}
    acfg = _attn_cfg(cfg, kind)
    if kind == "cross":  # the image K/V, projected once
        def heads(w):
            return attention._split_heads(layers.dense(w, image_embeds),
                                          acfg.num_kv_heads, acfg.head_dim)
        return {"k": heads(p["attn"]["wk"]), "v": heads(p["attn"]["wv"])}
    c = attention.init_cache(acfg, batch, max_len, dt, device)
    return {"k": c["k"], "v": c["v"]}  # pos passed per step


def remat_layer(fn, h: torch.Tensor):
    """``fn(h)`` whose activations are recomputed in the backward pass
    (the reference's ``jax.checkpoint`` of its group body).  The layers
    draw no random numbers, so no RNG state is kept for the replay; a
    replayed MoE layer launches K7 and K5 again."""
    return torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False,
                                             preserve_rng_state=False)


def _chunked_xent(model, params, h: torch.Tensor, labels: torch.Tensor,
                  loss_chunk: int) -> torch.Tensor:
    """Next-token xent, f32: position t's logits against label t + 1.
    With ``loss_chunk``, a chunk of positions at a time, the last one
    padded and masked, so that the f32 (B, chunk, V) logits are never
    made at the full length, as in the reference."""
    h_in, gold = h[:, :-1], labels[:, 1:]
    t = h_in.shape[1]
    if not loss_chunk or t <= loss_chunk:
        return layers.softmax_xent(model.unembed_logits(params, h_in), gold)
    pad = (-t) % loss_chunk
    mask = torch.ones(gold.shape, dtype=torch.float32, device=gold.device)
    if pad:
        h_in = torch.nn.functional.pad(h_in, (0, 0, 0, pad))
        gold = torch.nn.functional.pad(gold, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, t + pad, loss_chunk):
        logits = model.unembed_logits(params, h_in[:, i:i + loss_chunk])
        nll = layers.nll(logits, gold[:, i:i + loss_chunk])
        total = total + torch.sum(nll * mask[:, i:i + loss_chunk])
    return total / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class CausalLM:
    """Dense, MoE, gemma2, VLM, RWKV-6 or zamba2 causal LM on ``device``
    (default the card)."""

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
        # a shared block's weights once; its layers' entries stay empty
        params["layers"] = [{} if kind == "shared_attn"
                            else _sub_init(gen, cfg, kind)
                            for kind in self.kinds]
        if "shared_attn" in self.kinds:
            params["shared_attn"] = _sub_init(gen, cfg, "shared_attn")
        return params

    def stacked(self, params) -> dict:
        """A tree of ``params``' structure: True for each leaf that the
        reference stacks over its groups (a group's sub-block: every
        layer but the tail's), False for the tail, the shared block, the
        embedding, the head and the final norm."""
        n = self.plan.n_groups * len(self.plan.group_kinds)
        out = tree.map(lambda _: False, params)
        out["layers"] = [tree.map(lambda _, i=i: i < n, p)
                         for i, p in enumerate(params["layers"])]
        return out

    def _marker(self, i: int):
        """Layer ``i``'s loop marker: group ``i // k`` of the reference's
        scan over ``n_groups``; the tail's layers are outside it."""
        k = len(self.plan.group_kinds)
        if i >= k * self.plan.n_groups:
            return contextlib.nullcontext()
        return loops.iteration("layers", i // k, self.plan.n_groups)

    def _layer_params(self, params) -> list:
        """Each layer's parameters, the shared block's where it runs."""
        return [params["shared_attn"] if kind == "shared_attn" else p
                for kind, p in zip(self.kinds, params["layers"])]

    # -- forward ------------------------------------------------------------

    def hidden(self, params, tokens: torch.Tensor, *, image_embeds=None):
        """Final-norm hidden states (B, T, d) and the sum of the layers'
        MoE aux losses (0.0 for a dense model).

        The layers attend over positions 0..T-1, the route that runs K8
        where the layer has no softcap and T fits its window, if any, and
        autograd is not recording through it; with ``attn_impl ==
        "blockwise"`` they take the blockwise path (``kv_block``,
        ``q_block``).  Cross layers attend to ``image_embeds`` (B, image
        tokens, d).  Under grad, ``remat == "block"`` recomputes each
        layer in the backward pass instead of keeping its activations
        (``remat_layer``).
        """
        cfg = self.cfg
        kv_block = cfg.kv_block if cfg.attn_impl == "blockwise" else None
        q_block = cfg.q_block or None
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        h = pctx.shard_batch(layers.embed(params["embed"], tokens))
        aux = 0.0
        for i, (kind, p) in enumerate(zip(self.kinds,
                                          self._layer_params(params))):
            def layer(h, kind=kind, p=p, i=i):
                with self._marker(i):
                    h, a = _sub_apply(cfg, kind, p, h, cache=None,
                                      image_embeds=image_embeds,
                                      kv_block=kv_block,
                                      q_block=q_block)[:2]
                return pctx.shard_batch(h), a
            h, a = remat_layer(layer, h) if remat else layer(h)
            aux = aux + a
        return _norm(cfg, params["final_norm"], h), aux

    def unembed_logits(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = (layers.unembed(params["embed"], h) if cfg.tie_embeddings
                  else layers.dense(params["lm_head"], h))
        logits = pctx.shard_batch_tp(logits)  # vocab TP-sharded
        logits = logits.to(torch.float32)  # frees the bf16 logits
        cap = cfg.final_softcap
        if cap is None or logits.requires_grad:
            return layers.softcap(logits, cap)
        # serving: the same ops in place on the f32 copy, which nothing else
        # holds (gemma2-27b's f32 logits of a 4 x 2048 prefill take 8.4 GB)
        return logits.div_(cap).tanh_().mul_(cap)

    def forward(self, params, tokens: torch.Tensor, *, image_embeds=None):
        h, aux = self.hidden(params, tokens, image_embeds=image_embeds)
        return self.unembed_logits(params, h), aux

    def loss(self, params, batch: dict, *, loss_chunk: int = 0):
        """Next-token xent of ``batch["tokens"]`` against
        ``batch["labels"]``, plus 0.001 x the MoE aux loss for an MoE
        model: (total, {"xent", "aux"}), f32 scalars."""
        h, aux = self.hidden(params, batch["tokens"],
                             image_embeds=batch.get("image_embeds"))
        xent = _chunked_xent(self, params, h, batch["labels"], loss_chunk)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=xent.device)
        total = xent + 0.001 * aux if self.cfg.is_moe else xent
        return total, {"xent": xent, "aux": aux}

    # -- serving ------------------------------------------------------------

    def init_cache(self, params, batch: int, max_len: int,
                   image_embeds=None) -> dict:
        """Empty KV buffers for the attention layers (a window ring for a
        windowed one), zero states for the RWKV and Mamba layers; a cross
        layer's cache is its projection of ``image_embeds``."""
        return {"layers": [
            _sub_cache(self.cfg, kind, batch, max_len, self.device, p,
                       image_embeds)
            for kind, p in zip(self.kinds, params["layers"])]}

    def decode_step(self, params, tokens: torch.Tensor, cache: dict, *,
                    pos: int):
        """tokens (B, 1); pos: the absolute position of the token.

        Returns (logits (B, 1, V) f32, the cache).  The attention layers'
        buffers are written in place; a cross layer's image K/V are kept
        as they are; the RWKV and Mamba layers' states come back stepped.
        """
        pos = int(pos)
        h = pctx.shard_batch(layers.embed(params["embed"], tokens))
        positions = pos + torch.arange(tokens.shape[1], device=h.device)
        new_layers = []
        for i, (kind, p, c) in enumerate(zip(
                self.kinds, self._layer_params(params), cache["layers"])):
            if kind in ATTN_KINDS:  # a KV cache written at the position
                c = dict(c, pos=pos)
            with self._marker(i):
                h, _, nc = _sub_apply(self.cfg, kind, p, h, cache=c,
                                      positions=positions)
            new_layers.append({k: v for k, v in nc.items() if k != "pos"})
        h = _norm(self.cfg, params["final_norm"], h)
        return self.unembed_logits(params, h), {"layers": new_layers}
