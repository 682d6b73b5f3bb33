"""Serving steps: batched prefill and single-token decode.

The reference's semantics, on the model's device: ``prefill_step`` runs
the forward over the prompt (each K8-routed layer's attention through K8)
and returns its logits with a freshly initialised cache, as the
reference's does; ``generate`` teacher-forces the prompt through
``decode_step`` token by token and then samples.  Temperature sampling
draws from a ``torch.Generator``; greedy takes the argmax.

``extras`` carries a family's modality stub, by the keyword its model
takes (``registry.make_batch``): Whisper's ``frames``, llama-vision's
``image_embeds``; both the forward and the cache get it.  So a Whisper
prefill encodes the frames twice, in ``forward`` and in ``init_cache``,
as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import P


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0         # 0 = greedy
    max_len: int = 32768


def make_decode_step(model):
    def serve_step(params, cache, tokens, pos):
        """tokens (B,1) int32; pos: int -> (next_tokens (B,1), logits,
        new_cache)."""
        logits, new_cache = model.decode_step(params, tokens, cache, pos=pos)
        # under a mesh, over the whole vocabulary (DTensor's argmax of a
        # vocab-sharded batch of one fails)
        last = pctx.constrain(logits[:, -1:], P())
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return serve_step


def make_prefill(model, scfg: ServeConfig):
    """Prefill = forward over the prompt + cache construction."""

    def prefill_step(params, tokens: torch.Tensor,
                     extras: Optional[dict] = None):
        extras = extras or {}
        logits, _ = model.forward(params, tokens, **extras)
        cache = model.init_cache(params, tokens.shape[0], scfg.max_len,
                                 **extras)
        return logits, cache

    return prefill_step


def _sample(logits: torch.Tensor, scfg: ServeConfig,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 tokens."""
    if scfg.temperature > 0:
        probs = torch.softmax(logits / scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
    return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)


@torch.no_grad()
def generate(model, params, prompt: torch.Tensor, steps: int,
             scfg: ServeConfig, extras: Optional[dict] = None,
             gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy/temperature autoregressive generation: (B, T0) prompt ->
    (B, T0 + steps) tokens.  ``gen`` draws the temperature samples; it
    must live on the model's device."""
    b, t0 = prompt.shape
    cache = model.init_cache(params, b, scfg.max_len, **(extras or {}))
    # teacher-force the prompt token by token (robust across families)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(t0 + steps - 1):
        logits, cache = model.decode_step(params, tok, cache, pos=i)
        if i + 1 < t0:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = _sample(logits[:, -1], scfg, gen)
        out.append(tok)
    return torch.cat(out, dim=1)
