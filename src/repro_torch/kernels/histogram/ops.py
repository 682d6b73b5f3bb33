"""Public wrappers for the histogram kernels + profiler glue.

Instruction-class mapping (paper §2 / §4):

  * unweighted, result-unread  -> POPC class (``ATOMS.POPC.INC``: the
    compiler's cheap population-count increment),
  * unweighted, ``force_fao``  -> FAO class (the paper forces ``ATOMS.ADD``
    back with a dummy read of the atomic's result),
  * weighted (f32 accumulate)  -> CAS class (FP atomics lower to
    compare-and-swap loops on the GPU; the read-modify-verify analogue).

Every wrapper takes ``torch_device`` (default ``"cuda"``): the image is
moved there and the kernel runs there.  ``torch_device="cpu"`` runs the
kernels' plain versions instead; nothing picks the CPU by itself, so on a
machine without a card the default raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import counters as counters_mod
from repro_torch.core import timing
from repro_torch.kernels import instrumentation as instr
from repro_torch.kernels.histogram import kernel as hk

_REORDER = {"hist": False, "hist2": True}


def _image(img, torch_device) -> torch.Tensor:
    return torch.as_tensor(img, device=torch_device).to(
        torch.int32).contiguous()


def to_numpy(x) -> np.ndarray:
    """Host copy of an array or tensor (a CUDA tensor comes back first)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def histogram(img, *, num_bins: int = 256, variant: str = "hist",
              tile: int = hk.DEFAULT_TILE,
              torch_device="cuda") -> torch.Tensor:
    """(C, num_bins) int32 histogram; `variant` is 'hist' or 'hist2'."""
    return hk.histogram_launch(_image(img, torch_device), num_bins=num_bins,
                               reorder=_REORDER[variant], tile=tile)


def histogram_weighted(img, weights, *, num_bins: int = 256,
                       variant: str = "hist", tile: int = hk.DEFAULT_TILE,
                       torch_device="cuda") -> torch.Tensor:
    """(C, num_bins) f32 per-channel sums of a per-pixel weight."""
    w = torch.as_tensor(weights, device=torch_device).to(
        torch.float32).contiguous()
    return hk.histogram_launch(_image(img, torch_device), num_bins=num_bins,
                               reorder=_REORDER[variant], tile=tile,
                               weights=w)


def histogram_instrumented(
    img,
    *,
    num_bins: int = 256,
    variant: str = "hist",
    tile: int = hk.DEFAULT_TILE,
    force_fao: bool = False,
    weighted: bool = False,
    num_cores: int = 8,
    waves_per_tile: Optional[int] = None,
    pipeline_depth: int = 2,
    torch_device="cuda",
) -> tuple[torch.Tensor, counters_mod.WaveTrace]:
    """Histogram + the wave trace its instrumentation emits.

    The committed-index stream is identical for the weighted variant, so
    the integer instrumented kernel supplies the trace in both cases; only
    the job class differs (CAS for weighted f32 accumulation).

    ``waves_per_tile``/``pipeline_depth`` describe the launch geometry the
    occupancy model sees; ``waves_per_tile`` defaults to the kernel's own
    tiling (``tile * channels / LANES``) and, when overridden, also governs
    the round-robin core assignment — it *is* the scheduled tile size.
    """
    hist, degrees = hk.histogram_launch(
        _image(img, torch_device), num_bins=num_bins,
        reorder=_REORDER[variant], tile=tile, instrumented=True)
    deg = to_numpy(degrees).reshape(-1)
    num_waves = deg.shape[0]
    if waves_per_tile is None:
        waves_per_tile = default_waves_per_tile(img, tile)
    tiles = np.arange(num_waves) // max(waves_per_tile, 1)
    job_class = histogram_job_class(force_fao=force_fao, weighted=weighted)
    trace = counters_mod.WaveTrace(
        degree=deg,
        job_class=np.full(num_waves, job_class, np.int32),
        core=(tiles % num_cores).astype(np.int32),
        lanes_active=np.full(num_waves, float(instr.LANES)),
        waves_per_tile=waves_per_tile,
        pipeline_depth=pipeline_depth,
    )
    return hist, trace


def image_bytes(img) -> float:
    """Device-memory read traffic of the launch: 1 byte/channel as in the
    paper."""
    return float(img.shape[0] * img.shape[1])


def histogram_job_class(*, force_fao: bool, weighted: bool) -> int:
    """Instruction-class mapping (module docstring): CAS > FAO > POPC."""
    if weighted:
        return timing.CAS
    if force_fao:
        return timing.FAO
    return timing.POPC


def default_waves_per_tile(img, tile: int = hk.DEFAULT_TILE) -> int:
    """The kernel's own tiling: waves issued per grid tile."""
    return (tile * img.shape[1]) // instr.LANES


def committed_index_stream(img, *, num_bins: int = 256,
                           variant: str = "hist",
                           tile: int = hk.DEFAULT_TILE) -> np.ndarray:
    """The flat bin-index stream the kernel commits, synthesized in numpy.

    Mirrors ``kernel.issue_ordered_bins_plain`` (zero-padding to a tile
    multiple, channel-offset bins, per-pixel channel rotation for hist2,
    step-major ordering within each commit group) without launching
    anything — the modeled counter source the instrumented kernel
    cross-validates.  The per-commit-group transform never mixes rows
    across tiles, so it is applied to the whole padded image at once.
    """
    reorder = _REORDER[variant]
    a = to_numpy(img).astype(np.int32)
    pad = (-a.shape[0]) % tile
    if pad:
        a = np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)])
    t, c = a.shape
    g = instr.COMMIT_GROUP
    step = np.broadcast_to(np.arange(c, dtype=np.int32)[None, :], (t, c))
    if reorder:
        lane = ((np.arange(t, dtype=np.int32) % tile)[:, None]
                + np.zeros((1, c), np.int32))
        ch = (step + lane) % c
        vals = np.take_along_axis(a, ch, axis=1)
    else:
        ch = step
        vals = a
    bins = ch * num_bins + vals                           # (t, c) pixel-major
    bins = bins.reshape(t // g, g, c).transpose(0, 2, 1)  # step-major
    return bins.reshape(t * c)


def collect_counters(
    img,
    *,
    label: str = "",
    num_bins: int = 256,
    variant: str = "hist",
    tile: int = hk.DEFAULT_TILE,
    force_fao: bool = False,
    weighted: bool = False,
    num_cores: int = 8,
    waves_per_tile: Optional[int] = None,
    pipeline_depth: int = 2,
    bytes_read: Optional[float] = None,
    flops: float = 0.0,
    overhead_cycles: float = 500.0,
    torch_device="cuda",
) -> counters_mod.CounterSet:
    """Run the instrumented kernel and return its counters as a CounterSet.

    Every counter (``O``, ``N``, active lanes) is read back from the
    kernel's own instrumentation, not synthesized.
    """
    _, trace = histogram_instrumented(
        img, num_bins=num_bins, variant=variant, tile=tile,
        force_fao=force_fao, weighted=weighted, num_cores=num_cores,
        waves_per_tile=waves_per_tile, pipeline_depth=pipeline_depth,
        torch_device=torch_device)
    return counters_mod.CounterSet.from_trace(
        trace, label=label, num_cores=num_cores,
        bytes_read=image_bytes(img) if bytes_read is None else bytes_read,
        flops=flops, overhead_cycles=overhead_cycles,
        source="kernel", meta={"op": "histogram", "variant": variant})
