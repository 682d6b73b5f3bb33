"""Plain-torch oracles for the scatter-add / segment-sum / bincount kernels.

They follow the Pallas kernels' drop rule, not an indexed add's: an id
outside ``[0, num_segments)``, negative ids included, contributes nothing.
"""

from __future__ import annotations

import torch


def scatter_add_ref(values: torch.Tensor, ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(N, D) values summed into (num_segments, D) f32 by ids (N,)."""
    segs = torch.arange(num_segments, device=ids.device)
    onehot = (ids.to(torch.int64)[:, None] == segs).to(torch.float32)
    return onehot.T @ values.to(torch.float32)


def bincount_ref(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments,) int32 occurrence counts."""
    segs = torch.arange(num_segments, device=ids.device)
    return (ids.to(torch.int64)[:, None] == segs).sum(dim=0).to(torch.int32)
