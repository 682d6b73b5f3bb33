"""Plain-torch oracle for the histogram kernels (paper §4 case study)."""

from __future__ import annotations

import torch


def histogram_ref(img: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """Per-channel histogram of an image.

    img: (num_pixels, channels) integer channel values in [0, num_bins).
    returns: (channels, num_bins) int32 counts.
    """
    flat = img.to(torch.int32).T  # (C, N)
    bins = torch.arange(num_bins, dtype=torch.int32, device=img.device)
    onehot = flat[:, :, None] == bins
    return onehot.sum(dim=1).to(torch.int32)


def histogram_weighted_ref(img: torch.Tensor, weights: torch.Tensor,
                           num_bins: int = 256) -> torch.Tensor:
    """Weighted per-channel histogram (f32 accumulate — the CAS-class path).

    weights: (num_pixels,) float32, applied to every channel's bin update.
    returns: (channels, num_bins) float32 sums.
    """
    flat = img.to(torch.int32).T  # (C, N)
    bins = torch.arange(num_bins, dtype=torch.int32, device=img.device)
    onehot = flat[:, :, None] == bins
    return (onehot * weights[None, :, None]).sum(dim=1).to(torch.float32)
