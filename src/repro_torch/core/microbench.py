"""Tool 1 (paper §3.4): build the once-per-chip ``S(n, e, c)`` table.

The paper's first tool runs a microbenchmark that issues ``A = n`` atomic
warp-instructions at once with controlled active-thread count ``e`` and CAS
count ``c``, measures total time ``T`` from first arrival to last
completion, and derives ``S = T / n`` by job flow balance.

Here the measurement has two modes:

* ``analytic`` (default): query the calibrated timing model of the modeled
  device directly on the full (n, e, c) grid.
* ``kernel``: additionally run the instrumented scatter-add kernel on
  synthetic index patterns with a designed (n, e, c) and check the counted
  degrees against the design.  That kernel (K6) arrives with the port's
  scatter slice; until then this mode raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core import qmodel, timing


def default_grids(params: timing.ScatterUnitParams = timing.V5E_SCATTER):
    n_grid = np.arange(0, params.n_max + 1, dtype=np.float64)  # all integral n
    e_grid = np.arange(1, params.e_max + 1, dtype=np.float64)  # all integral e
    cfrac_grid = np.linspace(0.0, 1.0, 17)
    return n_grid, e_grid, cfrac_grid


def build_table(
    params: timing.ScatterUnitParams = timing.V5E_SCATTER,
    mode: str = "analytic",
) -> qmodel.ServiceTimeTable:
    """Measure T(n, e, c) over the full grid; once per chip model."""
    if mode == "kernel":
        raise NotImplementedError(
            "build_table(mode='kernel') needs the instrumented scatter-add "
            "kernel (K6), which comes with the port's scatter slice; use "
            "mode='analytic'")
    if mode != "analytic":
        raise ValueError(f"unknown build_table mode {mode!r}")
    n_grid, e_grid, cfrac_grid = default_grids(params)
    nn, ee, cf = np.meshgrid(n_grid, e_grid, cfrac_grid, indexing="ij")
    cc = cf * nn  # integral-c design points rectangularized by fraction
    T = timing.total_time_cycles(nn, ee, cc, 0.0, params)
    popc = timing.total_time_cycles(nn[..., 0], ee[..., 0],
                                    0.0, nn[..., 0], params)
    meta = {"mode": mode, "params": dataclasses.asdict(params)}

    return qmodel.ServiceTimeTable(
        n_grid=n_grid, e_grid=e_grid, cfrac_grid=cfrac_grid, T=T,
        popc_T=popc, clock_hz=params.clock_hz, meta=meta,
    )


def make_pattern(n: int, e: int, num_bins: int, lanes: int = 1024,
                 seed: int = 0) -> np.ndarray:
    """Synthesize ``n`` waves of scatter indices with serialization degree e.

    Degree e means each wave's ``lanes`` updates hit ``lanes // e`` distinct
    bins (duplicate multiplicity e), the TPU analogue of ``e`` threads of a
    warp hitting one bank.  Used both by the microbenchmark and the kernel
    tests.
    """
    assert 1 <= e <= lanes
    rng = np.random.default_rng(seed)
    distinct = max(1, lanes // e)
    waves = []
    for _ in range(n):
        bins = rng.choice(num_bins, size=distinct, replace=False)
        idx = np.repeat(bins, e)[:lanes]
        if idx.size < lanes:  # pad with the first bin (raises degree slightly)
            idx = np.concatenate([idx, np.full(lanes - idx.size, bins[0])])
        waves.append(idx)
    return np.stack(waves).astype(np.int32)
