"""Public wrappers for scatter-add / bincount + instrumentation glue.

Every wrapper takes ``torch_device`` (default ``"cuda"``): the inputs are
moved there and the kernel runs there.  ``torch_device="cpu"`` runs the
kernels' plain versions instead; nothing picks the CPU by itself, so on a
machine without a card the default raises.

``tile`` and ``seg_block`` are the reference's TPU blocking.  Neither
changes a sum, so the kernels ignore them, but the reference's rules on
them hold: a segment axis wider than ``seg_block`` must be a whole number
of blocks, and the instrumented stream is padded to a whole ``tile``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import counters as counters_mod
from repro_torch.core import timing
from repro_torch.kernels import instrumentation as instr
from repro_torch.kernels.histogram.ops import to_numpy
from repro_torch.kernels.scatter_add import kernel as sk


def _ids(ids, torch_device) -> torch.Tensor:
    return torch.as_tensor(ids, device=torch_device).to(
        torch.int32).reshape(-1).contiguous()


def _values(values, torch_device, dtypes=sk.VALUE_DTYPES) -> torch.Tensor:
    v = torch.as_tensor(values, device=torch_device)
    if v.dtype not in dtypes:
        v = v.to(torch.float32)
    return v.contiguous()


def scatter_add(values, ids, *, num_segments: int,
                tile: int = sk.DEFAULT_TILE,
                seg_block: int = sk.DEFAULT_SEG_BLOCK,
                torch_device="cuda") -> torch.Tensor:
    """Segment-sum: (N, D) values + (N,) ids -> (num_segments, D) f32."""
    del tile  # padding rows carry zero values: no sum depends on it
    sk.check_segment_blocking(num_segments, seg_block)
    return sk.scatter_add_launch(_values(values, torch_device),
                                 _ids(ids, torch_device), num_segments)


def bincount(ids, *, num_segments: int, tile: int = sk.DEFAULT_TILE,
             torch_device="cuda") -> torch.Tensor:
    """(num_segments,) int32 counts (the MoE dispatch histogram)."""
    del tile  # the reference's id-0 padding is subtracted again
    return sk.bincount_launch(_ids(ids, torch_device), num_segments)


def committed_id_stream(ids, num_segments: int, *,
                        tile: int = sk.DEFAULT_TILE) -> np.ndarray:
    """The flat id stream the instrumented kernel commits (numpy).

    Pads to a tile multiple with *unique out-of-range* sentinel ids: they
    match no segment (contributing nothing) and add no artificial
    conflicts to the degree counters.  ``instrumented_scatter_add`` feeds
    this exact stream to the kernel, so trace-side synthesis and in-kernel
    instrumentation see identical commit groups.
    """
    ids = to_numpy(ids).astype(np.int32).reshape(-1)
    pad = (-ids.shape[0]) % tile
    if pad:
        block = min(sk.DEFAULT_SEG_BLOCK, num_segments)
        base = -(-num_segments // block) * block
        sentinel = base + np.arange(pad, dtype=np.int32)
        ids = np.concatenate([ids, sentinel]).astype(np.int32)
    return ids


def default_waves_per_tile(tile: int = sk.DEFAULT_TILE) -> int:
    """The kernel's own tiling: waves issued per grid tile."""
    return tile // instr.LANES


def collect_counters(
    ids,
    values,
    num_segments: int,
    *,
    label: str = "",
    tile: int = sk.DEFAULT_TILE,
    num_cores: int = 8,
    job_class: int = timing.FAO,
    waves_per_tile: int | None = None,
    pipeline_depth: int = 2,
    bytes_read: float | None = None,
    flops: float = 0.0,
    overhead_cycles: float = 500.0,
    torch_device="cuda",
) -> counters_mod.CounterSet:
    """Run the instrumented kernel and return its counters as a CounterSet.

    The provider hook: ``InstrumentedKernelProvider`` calls this for
    ``indices`` sources, so every counter is read back from the kernel.
    """
    _, counters = instrumented_scatter_add(
        ids, values, num_segments, tile=tile, num_cores=num_cores,
        job_class=job_class, waves_per_tile=waves_per_tile,
        pipeline_depth=pipeline_depth, torch_device=torch_device)
    if bytes_read is None:
        bytes_read = float(to_numpy(ids).size * 4)
    return counters_mod.CounterSet.from_trace(
        counters["trace"], label=label, num_cores=num_cores,
        bytes_read=bytes_read, flops=flops, overhead_cycles=overhead_cycles,
        source="kernel", meta={"op": "scatter_add"})


def instrumented_scatter_add(
    ids,
    values,
    num_segments: int,
    *,
    wave: int = instr.LANES,
    tile: int = sk.DEFAULT_TILE,
    num_cores: int = 8,
    job_class: int = timing.FAO,
    waves_per_tile: int | None = None,
    pipeline_depth: int = 2,
    torch_device="cuda",
):
    """Scatter-add + the paper-Table-1 counters its instrumentation emits.

    Returns (out, counters) where counters has the basic quantities
    ``N`` (wave jobs), ``O`` (serialization transactions), per-wave
    ``degree``, and a ready-to-profile ``trace``.

    ``waves_per_tile`` (default: the kernel tiling ``tile / LANES``) and
    ``pipeline_depth`` set the trace's launch geometry directly.
    """
    del wave  # fixed at instr.LANES inside the kernel
    if tile % instr.LANES:
        raise ValueError(f"tile {tile} is not a multiple of {instr.LANES} "
                         f"ids, which the instrumented kernel needs")
    sk.check_segment_blocking(num_segments, sk.DEFAULT_SEG_BLOCK)
    stream = committed_id_stream(ids, num_segments, tile=tile)
    vals = _values(values, torch_device, {torch.float32: 0})
    if vals.dim() == 1:
        vals = vals[:, None]
    n = to_numpy(ids).size
    if vals.shape[0] != n:
        raise ValueError(f"{vals.shape[0]} value rows for {n} ids")
    out, deg = sk.scatter_add_instrumented_launch(
        vals, _ids(stream, torch_device), num_segments)
    deg = to_numpy(deg)
    num_waves = deg.shape[0]
    if waves_per_tile is None:
        waves_per_tile = default_waves_per_tile(tile)
    tiles = np.arange(num_waves) // max(waves_per_tile, 1)
    trace = counters_mod.WaveTrace(
        degree=deg,
        job_class=np.full(num_waves, job_class, np.int32),
        core=(tiles % num_cores).astype(np.int32),
        lanes_active=np.full(num_waves, float(instr.LANES)),
        waves_per_tile=waves_per_tile,
        pipeline_depth=pipeline_depth,
    )
    counters = {
        "N": float(num_waves),
        "O": float(deg.sum()),
        "degree": deg,
        "trace": trace,
    }
    return out, counters
