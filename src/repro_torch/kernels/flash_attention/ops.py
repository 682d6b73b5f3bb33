"""Public wrapper of the flash-attention kernel (K8).

``flash_attention`` takes the reference's (H, T, d) or batched
(B, H, T, d) layout.  ``torch_device`` (default ``"cuda"``) is where it
computes: the inputs are moved there, and ``torch_device="cpu"`` runs the
kernel's plain version; nothing picks the CPU by itself, so on a machine
without a card the default raises.

``bq`` and ``bkv`` are the reference's TPU blocking.  They change only
the order of the f32 sums, so the kernel tiles by its own sizes, but the
reference's rule on them holds: T must be a whole number of both.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as fk


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bkv: int = 128, group: int = 1,
                    torch_device="cuda") -> torch.Tensor:
    """(H, T, d) or batched (B, H, T, d) flash attention; k and v carry
    H / group heads."""
    q, k, v = (torch.as_tensor(x, device=torch_device).contiguous()
               for x in (q, k, v))
    if q.dim() not in (3, 4):
        raise ValueError(f"expected (H, T, d) or (B, H, T, d), got "
                         f"{tuple(q.shape)}")
    t = q.shape[-2]
    if bq < 1 or bkv < 1 or t % bq or t % bkv:  # the reference's assertion
        raise ValueError(f"sequence length {t} is not a whole number of "
                         f"bq={bq} and bkv={bkv} blocks")
    if q.dim() == 4:
        return fk.flash_attention_launch(q, k, v, causal=causal, group=group)
    return fk.flash_attention_launch(q[None], k[None], v[None], causal=causal,
                                     group=group)[0]
