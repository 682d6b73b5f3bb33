"""Calibrated TPU v5e timing model for the VMEM scatter/accumulate unit.

This module is the *hardware* that ``core.microbench`` measures.  The paper
(Dong & Pai 2025) measures ``T(n, e, c)`` on a real Titan V / A6000 with a
wall-clock microbenchmark.  This module instead encodes a documented,
swap-in-replaceable latency model of the v5e vector-unit scatter
pipeline, the modeled device whose tables the port keeps as data so its
outputs compare with the reference's.  On real hardware, ``microbench.build_table(mode="hw")``
would time the same kernels and produce a table of identical shape; every
consumer downstream (qmodel, profiler, roofline) is agnostic to the source.

The model reproduces the three qualitative behaviours of paper Fig. 1:

  * ``S`` *decreases* with load ``n`` — pipelining amortizes the fill
    latency ``L`` across jobs (``S(n) = L/n + (n-1)/n * I`` falls from
    ``L`` at ``n=1`` to the issue interval ``I`` as ``n → n_max``),
  * ``S`` *increases* with serialization degree ``e`` — duplicate indices
    inside a vector wave must commit sequentially, like bank-conflicting
    lanes in a GPU shared-memory atomic unit,
  * job-class mix shifts ``S`` roughly linearly in ``c`` (paper §3.1), with
    RMW-class (CAS-analogue) jobs costing ~2x cheap-accumulate (FAO) jobs,
    and the POPC-class (Ampere ``ATOMS.POPC.INC`` analogue: one-hot
    row-sum increment, conflict-free by construction) costing the least.

Constants below are *calibration choices*, not measurements — they are
plausible for a ~940 MHz VPU with a VMEM round-trip of a few tens of
cycles, and they put the dynamic range of ``S`` above 10x, matching the
paper's observation that atomic cost "can vary more than ten times
depending on launch and access patterns".
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

Array = np.ndarray
FloatOrArray = Union[float, Array]

# Job classes (paper §2).
FAO = 0   # fetch-and-op analogue: cheap vector accumulate (add/min/max/...)
CAS = 1   # compare-and-swap analogue: read-modify-verify loop (e.g. exact
          # f32 accumulation or non-associative updates)
POPC = 2  # ATOMS.POPC.INC analogue: one-hot population-count increment


@dataclasses.dataclass(frozen=True)
class ScatterUnitParams:
    """Latency parameters of the modeled VMEM scatter pipeline (cycles)."""

    clock_hz: float = 0.94e9      # v5e TensorCore clock
    # Pipeline fill latency for the first job: L(e) = fill + fill_e * e.
    fill_cycles: float = 25.0
    fill_per_conflict: float = 0.5
    # Steady-state issue interval per job class: I(e) = base + slope * e.
    fao_base: float = 4.0
    fao_slope: float = 1.0
    cas_base: float = 8.0
    cas_slope: float = 2.0
    popc_base: float = 2.0
    popc_slope: float = 0.0       # conflict-free by construction
    # Maximum jobs in flight per core: Pallas double-buffered pipeline (2)
    # x 32 concurrent wave slots of the 8x128 VPU commit path.  Mirrors the
    # paper's n_max = 64 (Volta warps/SM); Ampere used 48.
    n_max: int = 64
    # Serialization-degree table axis: degrees are bucketed to [1, 32]
    # (a wave whose 1024 lanes all hit one bin has raw degree 1024; the
    # pipeline saturates well before that, like the paper's e > 32 case).
    e_max: int = 32


V5E_SCATTER = ScatterUnitParams()


def total_time_cycles(
    n: FloatOrArray,
    e: FloatOrArray,
    c: FloatOrArray,
    p: FloatOrArray = 0.0,
    params: ScatterUnitParams = V5E_SCATTER,
) -> FloatOrArray:
    """Modeled total time T(n, e, c) in cycles for a closed batch of jobs.

    ``n`` jobs arrive at once (the microbenchmark's controlled-arrival
    setup, paper §3.2), of which ``c`` are CAS-class, ``p`` are POPC-class
    and the remaining ``n - c - p`` are FAO-class, each with average
    serialization degree ``e``.  Job flow balance holds by construction
    (all ``n`` jobs complete inside the measurement window), so the
    operational law gives ``S = T / n``.
    """
    n = np.asarray(n, dtype=np.float64)
    e = np.clip(np.asarray(e, dtype=np.float64), 1.0, params.e_max)
    c = np.asarray(c, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    n_fao = np.maximum(n - c - p, 0.0)

    fill = params.fill_cycles + params.fill_per_conflict * e
    i_fao = params.fao_base + params.fao_slope * e
    i_cas = params.cas_base + params.cas_slope * e
    i_popc = params.popc_base + params.popc_slope * e
    # One pipeline: fill once, then one issue interval per job.  The first
    # job's issue overlaps the fill, hence the "- max interval" correction
    # is folded into using fill as latency-to-first-completion.
    t = fill + n_fao * i_fao + c * i_cas + p * i_popc
    return np.where(n > 0, t, 0.0)


def seconds_per_cycle(params: ScatterUnitParams = V5E_SCATTER) -> float:
    return 1.0 / params.clock_hz


# ---------------------------------------------------------------------------
# Timing for the *other* modeled servers (paper §6: "our method is also
# applicable to other GPU functional units").  These are simple throughput
# servers used by core.profiler to place the scatter unit's utilization in
# context; the load-dependent queue treatment is reserved for the scatter
# unit, which is the paper's subject.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipParams:
    """TPU v5e per-chip constants (from public docs)."""

    peak_bf16_flops: float = 197e12   # FLOP/s
    hbm_bw: float = 819e9             # bytes/s
    ici_bw_per_link: float = 50e9     # bytes/s/link
    clock_hz: float = 0.94e9
    vmem_bytes: int = 128 * 1024 * 1024
    hbm_bytes: int = 16 * 1024**3


V5E = ChipParams()


def mxu_busy_seconds(flops: float, chip: ChipParams = V5E) -> float:
    return flops / chip.peak_bf16_flops


def hbm_busy_seconds(bytes_moved: float, chip: ChipParams = V5E) -> float:
    return bytes_moved / chip.hbm_bw


def ici_busy_seconds(bytes_moved: float, chip: ChipParams = V5E) -> float:
    return bytes_moved / chip.ici_bw_per_link
