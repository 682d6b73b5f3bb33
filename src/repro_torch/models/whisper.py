"""Whisper-small backbone (arXiv:2212.04356): the reference's encoder-decoder
transformer on one card.

The conv frontend is a stub, as in the reference: the caller supplies
mel-frame embeddings (B, frames, d_model) (``registry.make_batch``).  The
encoder is a bidirectional stack over those frames, the decoder a causal
stack with cross-attention to the encoder's output; LayerNorm, the tanh
GELU of ``mlp.apply``, fixed sinusoidal positions and no RoPE.

The reference scans stacked blocks; here the blocks are per-layer lists,
``params["enc_blocks"][i]`` and ``params["dec_blocks"][i]``
(``convert.whisper_params_from_numpy`` unstacks the reference's).

Routes.  The encoder's self-attention runs K8 with ``causal=False`` and
the decoder's prefill self-attention runs K8 causally
(``attention.flash_route``); cross-attention (to the encoder's 1500
frames) and every decode step run the plain ``_sdpa``, as in the
reference.  ``init_cache`` encodes the frames again and projects each
decoder layer's cross K/V from that output once.  Under grad (``loss``)
no self-attention takes K8, which has no backward, and with ``remat ==
"block"`` each encoder and decoder layer is recomputed in the backward
pass, as the reference checkpoints its scan bodies.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, loops, mlp
from repro_torch.models.transformer import remat_layer
from repro_torch.parallel import ctx as pctx


def _acfg(cfg: ModelConfig, causal: bool) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        qkv_bias=True, causal=causal, use_rope=False, dtype=cfg.dtype)


def _block_init(gen: torch.Generator, cfg: ModelConfig, cross: bool) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    dev = gen.device
    p = {
        "norm1": layers.layernorm_init(cfg.d_model, dt, dev),
        "attn": attention.init(gen, _acfg(cfg, True)),
        "norm2": layers.layernorm_init(cfg.d_model, dt, dev),
        "ffn": mlp.init(gen, cfg.d_model, cfg.d_ff, dt, "gelu"),
    }
    if cross:
        p["norm_c"] = layers.layernorm_init(cfg.d_model, dt, dev)
        p["cross"] = attention.init(gen, _acfg(cfg, False))
    return p


def _sinusoid_at(pos: int, d: int, device) -> torch.Tensor:
    """The sinusoid of one absolute position, (1, 1, d) f32, computed in
    f32 as the reference's decode step does (its prefill's table,
    ``layers.sinusoidal_positions``, is computed in float64)."""
    half = d // 2
    freq = torch.as_tensor(
        np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1)),
        dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


class WhisperModel:
    """Whisper encoder-decoder on ``device`` (default the card)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen``, which must live on the
        model's device (the tensors are drawn there)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dt = layers.torch_dtype(cfg.dtype)
        dev = gen.device
        return {
            "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
            "enc_blocks": [_block_init(gen, cfg, cross=False)
                           for _ in range(cfg.encoder_layers)],
            "enc_norm": layers.layernorm_init(cfg.d_model, dt, dev),
            "dec_blocks": [_block_init(gen, cfg, cross=True)
                           for _ in range(cfg.num_layers)],
            "dec_norm": layers.layernorm_init(cfg.d_model, dt, dev),
        }

    def stacked(self, params) -> dict:
        """A tree of ``params``' structure: True for each leaf that the
        reference stacks over its layers (every encoder and decoder
        block's), False for the embedding and the two final norms."""
        out = tree.map(lambda _: False, params)
        for key in ("enc_blocks", "dec_blocks"):
            out[key] = tree.map(lambda _: True, params[key])
        return out

    # -- encoder ------------------------------------------------------------

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """(B, F, d) frame embeddings -> (B, F, d) encoder states; each
        layer's self-attention is one bidirectional K8 launch."""
        cfg = self.cfg
        h = frames + layers.sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
        h = pctx.shard_batch(h)
        acfg = _acfg(cfg, causal=False)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        n = len(params["enc_blocks"])
        for i, p in enumerate(params["enc_blocks"]):
            def body(h, p=p, i=i):
                with loops.iteration("enc", i, n):
                    a, _ = attention.attend(
                        p["attn"], layers.layernorm(p["norm1"], h), acfg)
                    h = h + a
                    return pctx.shard_batch(h + mlp.apply(
                        p["ffn"], layers.layernorm(p["norm2"], h), "gelu"))
            h = remat_layer(body, h) if remat else body(h)
        return layers.layernorm(params["enc_norm"], h)

    # -- decoder ------------------------------------------------------------

    def _dec_embed(self, params, tokens: torch.Tensor, pos=None):
        """Token embeddings plus positions: the table of 0..T-1 for a
        prefill (``pos`` None), the sinusoid at ``pos`` for a decode
        step."""
        h = layers.embed(params["embed"], tokens)
        if pos is None:
            tab = layers.sinusoidal_positions(tokens.shape[1],
                                              self.cfg.d_model, h.device)
            return h + tab.to(h.dtype)
        return h + _sinusoid_at(pos, self.cfg.d_model, h.device).to(h.dtype)

    def forward(self, params, tokens: torch.Tensor, frames: torch.Tensor):
        """Logits (B, T, V) of ``tokens`` given ``frames``, and 0.0 (no
        auxiliary loss)."""
        cfg = self.cfg
        enc = self.encode(params, frames)
        h = pctx.shard_batch(self._dec_embed(params, tokens))
        acfg = _acfg(cfg, causal=True)
        xcfg = _acfg(cfg, causal=False)
        kv_block = cfg.kv_block if cfg.attn_impl == "blockwise" else None
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        n = len(params["dec_blocks"])
        for i, p in enumerate(params["dec_blocks"]):
            def body(h, p=p, i=i):
                with loops.iteration("dec", i, n):
                    a, _ = attention.attend(
                        p["attn"], layers.layernorm(p["norm1"], h), acfg,
                        kv_block=kv_block)
                    h = h + a
                    a, _ = attention.attend(
                        p["cross"], layers.layernorm(p["norm_c"], h), xcfg,
                        kv_x=enc)
                    h = h + a
                    return pctx.shard_batch(h + mlp.apply(
                        p["ffn"], layers.layernorm(p["norm2"], h), "gelu"))
            h = remat_layer(body, h) if remat else body(h)
        h = layers.layernorm(params["dec_norm"], h)
        return layers.unembed(params["embed"], h), 0.0

    def loss(self, params, batch: dict, *, loss_chunk: int = 0):
        """Next-token xent of ``batch["tokens"]`` given
        ``batch["frames"]``: (xent, {"xent", "aux": 0}).  ``loss_chunk``
        is ignored: the 52k vocab's full logits are small, as in the
        reference."""
        del loss_chunk
        logits, _ = self.forward(params, batch["tokens"], batch["frames"])
        xent = layers.softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
        return xent, {"xent": xent,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=xent.device)}

    # -- serving ------------------------------------------------------------

    def init_cache(self, params, batch: int, max_len: int,
                   frames: torch.Tensor = None) -> dict:
        """Per decoder layer: empty self-attention KV buffers of
        ``max_len`` slots and the cross K/V of the encoded ``frames``."""
        cfg = self.cfg
        enc = self.encode(params, frames)
        acfg = _acfg(cfg, causal=True)
        dt = layers.torch_dtype(cfg.dtype)

        def heads(w):
            return attention._split_heads(layers.dense(w, enc),
                                          acfg.num_kv_heads, acfg.head_dim)

        out = []
        for p in params["dec_blocks"]:
            sc = attention.init_cache(acfg, batch, max_len, dt, self.device)
            out.append({"k": sc["k"], "v": sc["v"],
                        "xk": heads(p["cross"]["wk"]),
                        "xv": heads(p["cross"]["wv"])})
        return {"layers": out}

    def decode_step(self, params, tokens: torch.Tensor, cache: dict, *,
                    pos: int):
        """tokens (B, 1); pos: the absolute position of the token.

        Returns (logits (B, 1, V), the cache).  The self-attention
        buffers are written in place; the cross K/V are kept as they are.
        """
        cfg = self.cfg
        pos = int(pos)
        h = pctx.shard_batch(self._dec_embed(params, tokens, pos=pos))
        acfg = _acfg(cfg, causal=True)
        positions = pos + torch.arange(1, device=h.device)
        new_layers = []
        n = len(params["dec_blocks"])
        for i, (p, c) in enumerate(zip(params["dec_blocks"],
                                       cache["layers"])):
            with loops.iteration("dec", i, n):
                a, nc = attention.attend(
                    p["attn"], layers.layernorm(p["norm1"], h), acfg,
                    positions=positions,
                    cache={"k": c["k"], "v": c["v"], "pos": pos})
                h = h + a
                h = h + attention.cross_cached(
                    p["cross"], layers.layernorm(p["norm_c"], h), acfg,
                    c["xk"], c["xv"])
                h = h + mlp.apply(p["ffn"],
                                  layers.layernorm(p["norm2"], h), "gelu")
            new_layers.append({"k": nc["k"], "v": nc["v"], "xk": c["xk"],
                               "xv": c["xv"]})
        h = layers.layernorm(params["dec_norm"], h)
        return layers.unembed(params["embed"], h), {"layers": new_layers}
