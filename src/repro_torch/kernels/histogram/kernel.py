"""Hopper histogram kernels (K2-K4) behind one launcher, with plain versions.

The paper's case-study kernel, back on the hardware it was written for.
``csrc/histogram.cu`` holds Listings 1-2 as CUDA kernels: a
shared-memory sub-histogram per block, one ``atomicAdd`` per pixel and
channel step, a flush of the non-zero bins to the global result.  Three
kernels, each the counterpart of a Pallas kernel of
``repro/kernels/histogram/kernel.py``:

  * K2 ``hist``: counts; ``reorder`` rotates the channel order by the
    pixel's row within the tile (``hist2``, Listing 2),
  * K3 ``hist_instrumented``: K2's counts plus the per-wave degrees of the
    step-major committed stream (K1, ``csrc/wave_degrees.cuh``), a warp
    per wave of that stream,
  * K4 ``hist_weighted``: f32 sums of a per-pixel weight (the CAS class),
    equal bins summed within a warp before they are added.

``histogram_launch`` runs the kernel for a CUDA tensor and the plain
torch version for a CPU tensor; it never falls back from one to the
other.  Unlike the Pallas launcher it takes the image unpadded: the kernels
mask the tail themselves, and K3's degrees cover the zero pixels of the
padded last tile exactly as the reference's do.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import instrumentation as instr

DEFAULT_TILE = 2048
# shared memory one block may opt into on Hopper (227 KB), static and
# dynamic together
MAX_SHARED_BYTES = 232448
# K4's static shared memory: 32 words of scratch for each warp of its
# 1024-thread block (csrc/histogram.cu: hist_weighted_kernel)
WEIGHTED_STATIC_BYTES = 4 * 1024

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"hist": 0, "hist_instrumented": 0, "hist_weighted": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "repro_hist": [_P, _P, _I, _I, _I, _I, _I, _P],
    "repro_hist_weighted": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_hist_instrumented": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind("histogram", _ARGTYPES)


def padded_length(n: int, tile: int) -> int:
    return n + (-n) % tile


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _flat_bins(img: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(N, C) flat bin index ``ch * num_bins + v`` with int32 wraparound."""
    c = img.shape[1]
    ch = torch.arange(c, dtype=torch.int32, device=img.device)
    return ch * num_bins + img


def histogram_plain(img: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(C, num_bins) int32 counts; flat indices outside the range drop.

    The channel rotation of ``hist2`` permutes each pixel's updates but
    not their set, so one plain version serves both variants.
    """
    c = img.shape[1]
    flat = _flat_bins(img, num_bins).reshape(-1)
    flat = flat[(flat >= 0) & (flat < c * num_bins)].to(torch.int64)
    counts = torch.bincount(flat, minlength=c * num_bins)
    return counts.to(torch.int32).reshape(c, num_bins)


def histogram_weighted_plain(img: torch.Tensor, weights: torch.Tensor,
                             num_bins: int) -> torch.Tensor:
    """(C, num_bins) sums of ``weights``, accumulated in f64, returned f32."""
    n, c = img.shape
    flat = _flat_bins(img, num_bins).reshape(-1)
    w = weights.to(torch.float64)[:, None].expand(n, c).reshape(-1)
    keep = (flat >= 0) & (flat < c * num_bins)
    sums = torch.zeros(c * num_bins, dtype=torch.float64, device=img.device)
    sums.index_add_(0, flat[keep].to(torch.int64), w[keep])
    return sums.to(torch.float32).reshape(c, num_bins)


def issue_ordered_bins_plain(img: torch.Tensor, num_bins: int,
                             reorder: bool,
                             tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Flat bin ids ``(T*C,)`` of a padded (T, C) image, in commit order.

    Channel step s of a 32-pixel group commits together (step-major
    within the group); ``reorder`` rotates pixel p's channel to
    ``(s + p % tile) % C``.  Mirrors the reference's
    ``_issue_ordered_bins`` and ``ops.committed_index_stream``.
    """
    t, c = img.shape
    g = instr.COMMIT_GROUP
    if t % g:
        raise ValueError(f"{t} pixels is not a whole number of "
                         f"{g}-pixel commit groups")
    step = torch.arange(c, dtype=torch.int32, device=img.device)[None, :]
    if reorder:
        row = torch.arange(t, dtype=torch.int32, device=img.device) % tile
        ch = (step + row[:, None]) % c
        vals = torch.gather(img, 1, ch.to(torch.int64))
    else:
        ch = step.expand(t, c)
        vals = img
    bins = ch * num_bins + vals                                 # pixel-major
    return bins.reshape(t // g, g, c).transpose(1, 2).reshape(t * c)


def histogram_instrumented_plain(img: torch.Tensor, num_bins: int,
                                 reorder: bool, tile: int = DEFAULT_TILE):
    """Plain K3: counts of the real pixels, degrees of the padded stream."""
    n, c = img.shape
    padded = F.pad(img, (0, 0, 0, padded_length(n, tile) - n))
    stream = issue_ordered_bins_plain(padded, num_bins, reorder, tile)
    degrees = instr.wave_degrees_plain(stream)
    return (histogram_plain(img, num_bins),
            degrees.reshape(-1, tile * c // instr.LANES))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _check_cuda(img: torch.Tensor, num_bins: int, tile: int,
                weights: torch.Tensor | None, instrumented: bool) -> None:
    if img.dtype != torch.int32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"image must be a contiguous (N, C) int32 tensor, "
                         f"got {tuple(img.shape)} {img.dtype}")
    n, c = img.shape
    if n == 0 or c == 0 or num_bins <= 0:
        raise ValueError(f"empty histogram launch: {n} px x {c} channels, "
                         f"{num_bins} bins")
    if padded_length(n, tile) * c >= 2 ** 31:
        raise ValueError(f"{n} px x {c} channels overflows int32 indexing")
    bins = c * num_bins
    smem = 4 * (bins + (c if instrumented else 0))
    if weights is not None:
        # K4 pads its copy with a word after each 32
        # (csrc/warp_aggregate.cuh: padded_slot), beside its scratch
        smem = 4 * (bins + bins // 32) + WEIGHTED_STATIC_BYTES
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{c} channels x {num_bins} bins needs {smem} B of "
                         f"shared memory; a block has {MAX_SHARED_BYTES}")
    if instrumented and tile % instr.LANES:
        raise ValueError(f"tile {tile} is not a multiple of {instr.LANES} "
                         f"pixels, which the instrumented kernel needs")
    if weights is not None and (
            weights.device != img.device or weights.dtype != torch.float32
            or weights.shape != (n,) or not weights.is_contiguous()):
        raise ValueError(f"weights must be a contiguous ({n},) float32 "
                         f"tensor on {img.device}")


def histogram_launch(
    img: torch.Tensor,
    *,
    num_bins: int = 256,
    reorder: bool = False,
    tile: int = DEFAULT_TILE,
    weights: torch.Tensor | None = None,
    instrumented: bool = False,
):
    """Run the histogram kernel on an (N, C) int32 image (any N).

    Returns (C, num_bins) counts — int32, or f32 when ``weights`` given.
    With ``instrumented=True`` additionally returns per-wave serialization
    degrees, shape (ceil(N / tile), tile * C / 1024), f32.
    """
    if img.device.type == "cpu":
        if weights is not None:
            return histogram_weighted_plain(img, weights, num_bins)
        if instrumented:
            return histogram_instrumented_plain(img, num_bins, reorder, tile)
        return histogram_plain(img, num_bins)
    if img.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {img.device}")
    _check_cuda(img, num_bins, tile, weights, instrumented)
    n, c = img.shape
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        if weights is not None:
            out = torch.zeros((c, num_bins), dtype=torch.float32,
                              device=img.device)
            _build.raise_on_error(lib.repro_hist_weighted(
                img.data_ptr(), weights.data_ptr(), out.data_ptr(), n, c,
                num_bins, tile, int(reorder), stream), "hist_weighted")
            LAUNCHES["hist_weighted"] += 1
            return out
        out = torch.zeros((c, num_bins), dtype=torch.int32, device=img.device)
        if instrumented:
            n_pad = padded_length(n, tile)
            deg = torch.empty(n_pad * c // instr.LANES, dtype=torch.float32,
                              device=img.device)
            _build.raise_on_error(lib.repro_hist_instrumented(
                img.data_ptr(), out.data_ptr(), deg.data_ptr(), n, n_pad, c,
                num_bins, tile, int(reorder), stream), "hist_instrumented")
            LAUNCHES["hist_instrumented"] += 1
            return out, deg.reshape(-1, tile * c // instr.LANES)
        _build.raise_on_error(lib.repro_hist(
            img.data_ptr(), out.data_ptr(), n, c, num_bins, tile,
            int(reorder), stream), "hist")
        LAUNCHES["hist"] += 1
        return out
