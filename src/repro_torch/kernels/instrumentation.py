"""In-kernel conflict instrumentation (K1): the per-wave degree.

The counter source the paper wishes hardware provided (§4: "No GPU
performance counter directly measures n").  The instrumented kernels
compute, from the same index stream they commit, each wave's
serialization degree: the mean over its 32 commit groups of the largest
duplicate count in the group.  It feeds the paper's ``O`` counter
(``e = O / N``) and matches ``repro_torch.core.counters.wave_degree`` bit
for bit.

On the card K1 is not a kernel of its own: it is the warp-level device
function in ``csrc/wave_degrees.cuh`` (a ballot for a group of one value,
else a bitonic sort of the group across the warp and its longest run),
inlined into the instrumented kernels K3 and K6.  ``wave_degrees_plain`` is its plain version, which
the CPU path runs and against which the kernel's degrees are checked.
"""

from __future__ import annotations

import torch

LANES = 1024        # one wave: 32 commit groups of 32 lanes
COMMIT_GROUP = 32   # lanes retiring together (one warp); conflicts serialize


def wave_degrees_plain(flat_idx: torch.Tensor, lanes: int = LANES,
                       group: int = COMMIT_GROUP) -> torch.Tensor:
    """Per-wave degree of a flat index stream, ``(len // lanes,)`` f32.

    ``flat_idx`` length must be a multiple of ``lanes``.  Each group's
    maximum multiplicity comes from a pairwise equality test; the wave's
    32 maxima are summed as integers and divided once, so the result is
    exact in f32.
    """
    if flat_idx.numel() % lanes or lanes % group:
        raise ValueError(f"stream of {flat_idx.numel()} indices is not a "
                         f"whole number of {lanes}-lane waves")
    g = flat_idx.reshape(-1, group)
    mult = (g[:, :, None] == g[:, None, :]).sum(dim=2).amax(dim=1)
    per_wave = mult.reshape(-1, lanes // group).sum(dim=1)
    return per_wave.to(torch.float32) / (lanes // group)
