"""Plain-torch oracle for the flash-attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q/k/v: (H, T, d) — single example, multi-head.  f32 math."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("hqk,hkd->hqd", p,
                        v.to(torch.float32)).to(q.dtype)
