"""Tool 1 (paper §3.4): build the once-per-chip ``S(n, e, c)`` table.

The paper's first tool runs a microbenchmark that issues ``A = n`` atomic
warp-instructions at once with controlled active-thread count ``e`` and CAS
count ``c``, measures total time ``T`` from first arrival to last
completion, and derives ``S = T / n`` by job flow balance.

Here the measurement has two modes:

* ``analytic`` (default): query the calibrated timing model of the modeled
  device directly on the full (n, e, c) grid.
* ``kernel``: additionally *executes* the instrumented scatter-add kernel
  (K6, on ``torch_device``) on synthetic index patterns constructed to
  have a designed (n, e), recovers the counters from its instrumentation
  and checks them against the design (``meta["kernel_validation"]``),
  which validates the counter path end to end.  This mirrors the paper's
  point that ``T(n,e,c)`` "does not reveal any hardware implementation
  details": the check comes from running code, not from reading specs.
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
    kernel_validation_points: int = 8,
    seed: int = 0,
    torch_device="cuda",
) -> qmodel.ServiceTimeTable:
    """Measure T(n, e, c) over the full grid; once per chip model.

    ``torch_device`` is where ``mode="kernel"`` runs K6; the analytic
    mode launches nothing.
    """
    if mode not in ("analytic", "kernel"):
        raise ValueError(f"unknown build_table mode {mode!r}")
    n_grid, e_grid, cfrac_grid = default_grids(params)
    nn, ee, cf = np.meshgrid(n_grid, e_grid, cfrac_grid, indexing="ij")
    cc = cf * nn  # integral-c design points rectangularized by fraction
    T = timing.total_time_cycles(nn, ee, cc, 0.0, params)
    popc = timing.total_time_cycles(nn[..., 0], ee[..., 0],
                                    0.0, nn[..., 0], params)
    meta = {"mode": mode, "params": dataclasses.asdict(params)}

    if mode == "kernel":
        meta["kernel_validation"] = _validate_with_kernel(
            params, kernel_validation_points, seed, torch_device)

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


def _validate_with_kernel(params, num_points: int, seed: int,
                          torch_device) -> list[dict]:
    """Run the instrumented kernel on designed patterns; compare counters."""
    from repro_torch.kernels.scatter_add import ops as scatter_ops

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_points):
        n = int(rng.integers(1, params.n_max + 1))
        e = int(2 ** rng.integers(0, 6))  # 1..32
        num_bins = 4096
        idx = make_pattern(n, e, num_bins, seed=int(rng.integers(1 << 31)))
        values = np.ones(idx.shape, np.float32)
        _, counters = scatter_ops.instrumented_scatter_add(
            idx.reshape(-1), values.reshape(-1), num_bins, wave=idx.shape[1],
            torch_device=torch_device)
        measured_e = counters["O"] / counters["N"]
        out.append({
            "designed": {"n": n, "e": e},
            "counted": {"N": float(counters["N"]), "e": float(measured_e)},
            "e_rel_err": abs(measured_e - e) / e,
        })
    return out
