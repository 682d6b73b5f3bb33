"""Operational single-server queuing model (paper §3).

Implements, verbatim where possible:

  * the sampled total-time table ``T(n, e, c)`` and its linear
    interpolation with the ``T(0, ., .) = 0`` boundary (paper Eqs. 1-2),
  * the mean-service-time-between-completions law ``S = T / n``
    (paper Eq. 3, from Denning & Buzen's operational analysis: in the
    controlled microbenchmark all ``A`` arrivals are queued at once so the
    load is ``n = A``, and job flow balance gives completions ``C = A``),
  * the basic/derived operational quantities of paper Tables 1-2 and the
    utilization estimate ``U = B / T`` with ``B = N * S(n_hat, e, c)``.

The model is deliberately *operational*: it makes no stochastic
assumptions, only uses measured (here: instrumented/modeled) quantities,
and does not attempt to mirror the internal architecture of the unit
(paper §3: a load-dependent single server is sufficient).
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import timing

Array = np.ndarray


# ---------------------------------------------------------------------------
# Multilinear interpolation on a regular grid
# ---------------------------------------------------------------------------


def _interp_axis_weights(grid: Array, x: Array) -> tuple[Array, Array, Array]:
    """Return (lo_idx, hi_idx, hi_weight) for 1-D linear interpolation.

    Queries outside the grid clamp to the boundary (the paper's tables
    cover the full feasible range, so clamping only triggers on numerical
    noise or deliberately saturated queries such as e > e_max).
    """
    x = np.clip(x, grid[0], grid[-1])
    hi = np.searchsorted(grid, x, side="left")
    hi = np.clip(hi, 1, len(grid) - 1)
    lo = hi - 1
    span = grid[hi] - grid[lo]
    w = np.where(span > 0, (x - grid[lo]) / np.where(span > 0, span, 1.0), 0.0)
    return lo, hi, w


def trilinear(
    values: Array,
    grids: Sequence[Array],
    query: Sequence[Array],
) -> Array:
    """Multilinear interpolation of ``values`` (shape = grid lens) at query."""
    assert len(grids) == values.ndim == len(query)
    los, his, ws = [], [], []
    for g, q in zip(grids, query):
        lo, hi, w = _interp_axis_weights(np.asarray(g, np.float64), np.asarray(q, np.float64))
        los.append(lo)
        his.append(hi)
        ws.append(w)
    out = 0.0
    ndim = values.ndim
    for corner in range(1 << ndim):
        idx = []
        weight = 1.0
        for d in range(ndim):
            if corner >> d & 1:
                idx.append(his[d])
                weight = weight * ws[d]
            else:
                idx.append(los[d])
                weight = weight * (1.0 - ws[d])
        out = out + weight * values[tuple(idx)]
    return out


class TableInterpolator:
    """Precompiled multilinear interpolation on a regular grid.

    ``trilinear`` re-derives everything per call; this factors the lookup
    into (1) per-axis clamp/searchsorted weights and (2) ONE flat gather
    over all ``2^ndim`` corner values, everything vectorized over the
    query batch.  Numerically it is *bit-identical* to ``trilinear`` —
    same clamping, same corner enumeration order, same weight-product
    order, same accumulation order — but a sweep's thousands of
    ``S(n, e, c)`` lookups become a single fused numpy pass instead of
    thousands of Python calls (see ``profiler.profile_batch``).
    """

    def __init__(self, values: Array, grids: Sequence[Array]) -> None:
        self.values = np.ascontiguousarray(values, np.float64)
        self.grids = [np.ascontiguousarray(g, np.float64) for g in grids]
        if len(self.grids) != self.values.ndim:
            raise ValueError(
                f"need one grid per value axis: {len(self.grids)} grids "
                f"for a {self.values.ndim}-d table")
        for g, size in zip(self.grids, self.values.shape):
            if len(g) != size:
                raise ValueError(
                    f"grid length {len(g)} does not match axis size {size}")
        self._flat = self.values.reshape(-1)
        # element strides of the (C-contiguous) value array, per axis
        self._strides = [
            int(np.prod(self.values.shape[d + 1:], dtype=np.int64))
            for d in range(self.values.ndim)
        ]

    def __call__(self, *query) -> Array:
        """Interpolate at ``query`` (one array per axis, broadcastable)."""
        if len(query) != len(self.grids):
            raise ValueError(f"expected {len(self.grids)} query arrays, "
                             f"got {len(query)}")
        qs = [np.asarray(q, np.float64) for q in query]
        if len(qs) > 1:
            qs = list(np.broadcast_arrays(*qs))
        los, his, ws = [], [], []
        for g, q in zip(self.grids, qs):
            lo, hi, w = _interp_axis_weights(g, q)
            # a single-point axis yields hi == 0, lo == -1: trilinear's
            # tuple indexing wraps -1 to that same single element, but a
            # *flat* index must not go negative — clamp to the identical
            # element explicitly (w == 0 there, so the value is unchanged)
            los.append(np.maximum(lo, 0))
            his.append(hi)
            ws.append(w)
        ndim = len(self.grids)
        shape = np.shape(qs[0])
        ncorners = 1 << ndim
        idx = np.empty((ncorners,) + shape, np.intp)
        for corner in range(ncorners):
            flat = np.zeros(shape, np.intp)
            for d in range(ndim):
                pick = his[d] if corner >> d & 1 else los[d]
                flat += pick * self._strides[d]
            idx[corner] = flat
        vals = self._flat.take(idx)          # one gather for all corners
        out = 0.0
        for corner in range(ncorners):
            weight = 1.0
            for d in range(ndim):
                if corner >> d & 1:
                    weight = weight * ws[d]
                else:
                    weight = weight * (1.0 - ws[d])
            out = out + weight * vals[corner]
        return out


# ---------------------------------------------------------------------------
# Service-time table (paper §3.2, Fig. 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServiceTimeTable:
    """Sampled ``T(n, e, c)`` with interpolated lookup (paper Eqs. 1-3).

    Sampled on a rectangular grid (n, e, c/n): the paper samples integral
    ``c <= n``, which is a ragged grid; storing the class-mix axis as the
    CAS *fraction* ``c/n`` is an equivalent rectangularization (linear in
    ``c`` at fixed ``n``, per the paper's observed roughly-linear class-mix
    behaviour) that keeps Eq. 2's linear interpolation well-defined
    everywhere.  ``n_grid`` includes 0 with ``T = 0`` (Eq. 1).

    ``popc_T`` is the companion 2-D table ``T_popc(n, e)`` for the
    POPC-class pipeline (Ampere ``ATOMS.POPC.INC`` analogue, paper §2);
    the paper treats POPC kernels as a separate instruction class.
    """

    n_grid: Array           # (Nn,) including 0
    e_grid: Array           # (Ne,)
    cfrac_grid: Array       # (Nc,) in [0, 1]
    T: Array                # (Nn, Ne, Nc) cycles, T[0] == 0
    popc_T: Optional[Array] = None  # (Nn, Ne) cycles
    clock_hz: float = timing.V5E_SCATTER.clock_hz
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.n_grid = np.asarray(self.n_grid, np.float64)
        self.e_grid = np.asarray(self.e_grid, np.float64)
        self.cfrac_grid = np.asarray(self.cfrac_grid, np.float64)
        self.T = np.asarray(self.T, np.float64)
        if self.n_grid[0] != 0.0:
            raise ValueError("n_grid must start at 0 (paper Eq. 1 boundary)")
        if not np.allclose(self.T[0], 0.0):
            raise ValueError("T(0, ., .) must be 0 (paper Eq. 1)")

    # -- lookups ----------------------------------------------------------

    def total_time(self, n, e, c) -> Array:
        """Interpolated T(n, e, c) in cycles (paper Eq. 2)."""
        n = np.asarray(n, np.float64)
        e = np.asarray(e, np.float64)
        c = np.asarray(c, np.float64)
        cfrac = np.where(n > 0, c / np.where(n > 0, n, 1.0), 0.0)
        return trilinear(self.T, (self.n_grid, self.e_grid, self.cfrac_grid),
                         (n, e, cfrac))

    def service_time(self, n, e, c) -> Array:
        """S(n, e, c) = T(n, e, c) / n in cycles (paper Eq. 3); S := 0 at n=0."""
        n = np.asarray(n, np.float64)
        t = self.total_time(n, e, c)
        return np.where(n > 0, t / np.where(n > 0, n, 1.0), 0.0)

    def popc_service_time(self, n, e) -> Array:
        if self.popc_T is None:
            raise ValueError("table has no POPC-class samples")
        n = np.asarray(n, np.float64)
        t = trilinear(self.popc_T, (self.n_grid, self.e_grid),
                      (n, np.asarray(e, np.float64)))
        return np.where(n > 0, t / np.where(n > 0, n, 1.0), 0.0)

    def service_seconds(self, n, e, c) -> Array:
        return self.service_time(n, e, c) / self.clock_hz

    # -- precompiled batch lookups ----------------------------------------

    def interpolator(self) -> TableInterpolator:
        """Precompiled ``T(n, e, cfrac)`` interpolator, built once per table.

        The table is immutable in practice (built by Tool 1, then only
        read), so the compiled axis data is cached on first use.
        """
        interp = getattr(self, "_interp", None)
        if interp is None:
            interp = TableInterpolator(
                self.T, (self.n_grid, self.e_grid, self.cfrac_grid))
            self._interp = interp
        return interp

    def popc_interpolator(self) -> TableInterpolator:
        """Precompiled ``T_popc(n, e)`` interpolator (2-D companion table)."""
        if self.popc_T is None:
            raise ValueError("table has no POPC-class samples")
        interp = getattr(self, "_popc_interp", None)
        if interp is None:
            interp = TableInterpolator(self.popc_T,
                                       (self.n_grid, self.e_grid))
            self._popc_interp = interp
        return interp

    def service_time_batch(self, n, e, c) -> Array:
        """Vectorized ``service_time`` over whole query arrays.

        Bit-identical to calling ``service_time`` elementwise (same cfrac
        rectangularization, same clamping, same corner arithmetic via
        ``TableInterpolator``), but one fused pass — the batch profiler's
        hot lookup.
        """
        n = np.asarray(n, np.float64)
        e = np.asarray(e, np.float64)
        c = np.asarray(c, np.float64)
        cfrac = np.where(n > 0, c / np.where(n > 0, n, 1.0), 0.0)
        t = self.interpolator()(n, e, cfrac)
        return np.where(n > 0, t / np.where(n > 0, n, 1.0), 0.0)

    def popc_service_time_batch(self, n, e) -> Array:
        """Vectorized ``popc_service_time`` (see ``service_time_batch``)."""
        n = np.asarray(n, np.float64)
        t = self.popc_interpolator()(n, np.asarray(e, np.float64))
        return np.where(n > 0, t / np.where(n > 0, n, 1.0), 0.0)

    # -- (de)serialization -------------------------------------------------

    def save(self, path: str) -> None:
        # compressed (the grid is highly regular, ~6x smaller);
        # ``load`` reads both this and the uncompressed .npz artifacts
        # written by earlier revisions (np.load is format-agnostic)
        np.savez_compressed(
            path,
            n_grid=self.n_grid,
            e_grid=self.e_grid,
            cfrac_grid=self.cfrac_grid,
            T=self.T,
            popc_T=self.popc_T if self.popc_T is not None else np.zeros(0),
            clock_hz=np.float64(self.clock_hz),
            meta=np.str_(json.dumps(self.meta, default=float)),
        )

    @classmethod
    def load(cls, path: str) -> "ServiceTimeTable":
        z = np.load(path)
        popc = z["popc_T"]
        meta = json.loads(str(z["meta"])) if "meta" in z.files else {}
        return cls(
            n_grid=z["n_grid"],
            e_grid=z["e_grid"],
            cfrac_grid=z["cfrac_grid"],
            T=z["T"],
            popc_T=popc if popc.size else None,
            clock_hz=float(z["clock_hz"]),
            meta=meta,
        )


# ---------------------------------------------------------------------------
# Basic operational quantities (paper Table 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BasicCounters:
    """Per-core basic quantities (paper Table 1, superscript (i)).

    On GPU these come from NVProf/NCU; here they come from in-kernel Pallas
    instrumentation and the compiled artifact (see core.counters for the
    mapping table).  ``n_true`` is our extension: the paper notes "No GPU
    performance counter directly measures n and we recommend GPU
    manufacturers add one" — Pallas instrumentation lets us emit it.
    """

    O: float                 # total serialization transactions (global)
    N_f: float               # FAO-class wave jobs on this core
    N_c: float               # CAS-class wave jobs on this core
    T_cycles: float          # active cycles on this core
    occupancy: float         # achieved fraction of max in-flight jobs [0,1]
    N_p: float = 0.0         # POPC-class wave jobs on this core
    n_true: Optional[float] = None  # instrumented time-avg queue length
    core_id: int = 0


@dataclasses.dataclass
class CoreUtilization:
    """Derived quantities (paper Table 2) + utilization for one core."""

    core_id: int
    N: float          # total jobs
    n_hat: float      # average parallelism estimate
    e: float          # average serialization degree per job
    c: float          # average queued CAS-class jobs
    S_cycles: float   # interpolated service time
    B_cycles: float   # busy time  B = N * S
    T_cycles: float   # measurement window
    U: float          # utilization B / T


def derive_core_utilization(
    counters: Sequence[BasicCounters],
    table: ServiceTimeTable,
    n_max: Optional[float] = None,
    use_true_n: bool = False,
) -> list[CoreUtilization]:
    """Paper Table 2, applied per core.

    ``e`` is computed globally (``e = O / sum_i N^(i)``) because the paper's
    O-counter analogue aggregates across cores; per-core quantities use the
    per-core counters.  With ``use_true_n`` the instrumented queue length
    replaces the occupancy-based estimate ``n_hat = o * n_max`` — the paper
    identifies the occupancy estimate as the cause of >100% utilization
    readings.  ``n_max`` defaults to the table's own load axis upper bound
    (the table is built once per device, so its grid *is* the device's
    maximum in-flight job count).
    """
    if n_max is None:
        n_max = float(table.n_grid[-1])
    total_jobs = sum(cc.N_f + cc.N_c + cc.N_p for cc in counters)
    e_global = (sum(cc.O for cc in counters) / total_jobs) if total_jobs else 1.0
    out = []
    for cc in counters:
        n_jobs = cc.N_f + cc.N_c + cc.N_p
        if use_true_n and cc.n_true is not None:
            n_hat = cc.n_true
        else:
            n_hat = cc.occupancy * n_max
        n_faocas = cc.N_f + cc.N_c
        c_avg = n_hat * (cc.N_c / n_faocas) if n_faocas > 0 else 0.0
        s = float(table.service_time(n_hat, e_global, c_avg)) if n_faocas else 0.0
        busy = n_faocas * s
        if cc.N_p > 0 and table.popc_T is not None:
            s_p = float(table.popc_service_time(n_hat, e_global))
            busy += cc.N_p * s_p
        u = busy / cc.T_cycles if cc.T_cycles > 0 else 0.0
        out.append(CoreUtilization(
            core_id=cc.core_id, N=n_jobs, n_hat=n_hat, e=e_global, c=c_avg,
            S_cycles=s, B_cycles=busy, T_cycles=cc.T_cycles, U=u,
        ))
    return out


# ---------------------------------------------------------------------------
# Operational laws (Denning & Buzen 1978) — used by property tests and the
# straggler detector; kept standalone so other servers (MXU/HBM/ICI) reuse
# them.
# ---------------------------------------------------------------------------


def throughput(completions: float, window: float) -> float:
    """X = C / T."""
    return completions / window if window > 0 else 0.0


def utilization_law(x: float, s: float) -> float:
    """U = X * S."""
    return x * s


def littles_law_queue(x: float, response_time: float) -> float:
    """n = X * R."""
    return x * response_time


def flow_balanced(arrivals: float, completions: float, tol: float = 0.0) -> bool:
    """Job flow balance |A - C| <= tol (paper §3.2 requires C = A)."""
    return abs(arrivals - completions) <= tol


# ---------------------------------------------------------------------------
# Report rendering
# ---------------------------------------------------------------------------


def render_utilization_report(
    rows: Sequence[CoreUtilization],
    title: str = "shared-scatter unit utilization",
) -> str:
    buf = io.StringIO()
    buf.write(f"== {title} ==\n")
    buf.write(f"{'core':>5} {'N':>12} {'n_hat':>8} {'e':>7} {'c':>8} "
              f"{'S(cyc)':>9} {'B(cyc)':>12} {'T(cyc)':>12} {'U':>7}\n")
    for r in rows:
        buf.write(f"{r.core_id:>5} {r.N:>12.0f} {r.n_hat:>8.2f} {r.e:>7.2f} "
                  f"{r.c:>8.2f} {r.S_cycles:>9.2f} {r.B_cycles:>12.0f} "
                  f"{r.T_cycles:>12.0f} {r.U:>7.2%}\n")
    if rows:
        mean_u = float(np.mean([r.U for r in rows]))
        buf.write(f"mean utilization: {mean_u:.2%}\n")
    return buf.getvalue()
