"""Tool 2 (paper §3.4): profile a workload and report per-unit utilization.

Mirrors the paper's second tool: collect the Table-1 counters from a run,
instantiate the single-server model, and emit per-core utilization of the
scatter ("shared-memory atomic") unit — together with the companion
throughput servers (HBM, MXU, ICI) so bottleneck *shifts* are visible
(paper §4.1: at ~2^20 pixels the histogram bottleneck shifts from the
atomic unit to global memory).

Kernel-time model
-----------------
The paper measures T (active cycles) with a counter.  Without hardware we
model a kernel launch's active cycles per core as

    T = overhead + max(B_scatter, T_mem_effective) + issue_tail

where B_scatter is the queue model's busy time and T_mem_effective is the
HBM stream time inflated by latency exposure when the working set spills
the last-level cache and concurrency is too low to hide the miss latency —
the mechanism behind the paper's observed bottleneck shift.  The cache
constants are documented emulation knobs (`CacheModel`), not TPU specs.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import counters as counters_mod
from repro_torch.core import qmodel, timing


@dataclasses.dataclass(frozen=True)
class CacheModel:
    """Last-level-cache emulation for latency-exposure effects."""

    llc_bytes: float = 4 * 1024**2
    miss_latency_cycles: float = 500.0
    hide_concurrency: float = 8.0   # in-flight requests that fully hide misses


@dataclasses.dataclass
class UnitUtilization:
    name: str
    busy_cycles: float
    window_cycles: float

    @property
    def utilization(self) -> float:
        return self.busy_cycles / self.window_cycles if self.window_cycles else 0.0


@dataclasses.dataclass
class WorkloadProfile:
    """Per-launch profile: the paper's report, plus companion units."""

    label: str
    per_core: list[qmodel.CoreUtilization]
    units: list[UnitUtilization]
    T_cycles: np.ndarray          # per core
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def scatter_utilization(self) -> float:
        return float(np.mean([c.U for c in self.per_core])) if self.per_core else 0.0

    @property
    def e(self) -> float:
        """Job-weighted serialization degree across cores (= global O/N)."""
        jobs = float(sum(c.N for c in self.per_core))
        return (float(sum(c.e * c.N for c in self.per_core)) / jobs
                if jobs else 0.0)

    @property
    def n_hat(self) -> float:
        """Peak per-core concurrency estimate across cores."""
        return (float(max(c.n_hat for c in self.per_core))
                if self.per_core else 0.0)

    @property
    def bottleneck(self) -> str:
        best, best_u = "none", 0.0
        for u in self.units:
            if u.utilization > best_u:
                best, best_u = u.name, u.utilization
        return best

    def unit(self, name: str) -> UnitUtilization:
        for u in self.units:
            if u.name == name:
                return u
        raise KeyError(name)

    def render(self) -> str:
        buf = io.StringIO()
        buf.write(f"== profile: {self.label} ==\n")
        buf.write(qmodel.render_utilization_report(self.per_core))
        for u in self.units:
            buf.write(f"unit {u.name:>12}: busy={u.busy_cycles:>12.0f} cyc  "
                      f"U={u.utilization:6.2%}\n")
        buf.write(f"bottleneck: {self.bottleneck}\n")
        return buf.getvalue()


def profile_counters(
    cset: counters_mod.CounterSet,
    table: qmodel.ServiceTimeTable,
    *,
    params: Optional[timing.ScatterUnitParams] = None,
    chip: Optional[timing.ChipParams] = None,
    cache: Optional[CacheModel] = None,
    use_true_n: bool = False,
) -> WorkloadProfile:
    """Profile one launch from a uniform ``CounterSet`` (any provider).

    This is the single entry every counter source funnels into: the
    legacy trace path (``profile_scatter_workload``) and all
    ``repro_torch.analysis.providers`` backends build a ``CounterSet`` and
    delegate here.  Two-phase, like the paper: (1) the queue model's busy
    time B from the counters (B needs no T); (2) model the measurement
    window T per core from all units and overheads; (3) derive U = B / T.

    ``params``/``chip``/``cache`` default to the v5e model; pass a
    ``repro_torch.analysis.Device``'s bundle (or use ``Session.profile``) to
    target other hardware.
    """
    if params is None:
        params = timing.V5E_SCATTER
    if chip is None:
        chip = timing.V5E
    if cache is None:
        cache = CacheModel()
    num_cores = cset.num_cores
    # Phase 1: scatter busy time per core (empty-counter sources skip it).
    # B = N * S depends only on the counters, never on the window T, so
    # this single model pass serves phase 3 too — the placeholder window
    # (ones) only touches the U column, which phase 3 overwrites.
    if cset.total_jobs > 0:
        basic = cset.to_basic_counters(np.ones(num_cores), params.n_max)
        prelim = qmodel.derive_core_utilization(
            basic, table, n_max=params.n_max, use_true_n=use_true_n)
        scatter_busy = np.array([c.B_cycles for c in prelim])
        n_hat = prelim[0].n_hat if prelim else 1.0
    else:
        prelim = []
        scatter_busy = np.zeros(num_cores)
        n_hat = 1.0

    # Phase 2: companion units and the kernel-time model.
    bytes_per_cycle = chip.hbm_bw / chip.clock_hz
    mem_ideal = (cset.bytes_read / num_cores) / bytes_per_cycle
    # Latency exposure: when the working set spills the LLC, each tile's
    # leading access exposes miss latency unless concurrency hides it.
    # Scatter-visible sources only: the heuristic reads the launch
    # geometry, which an HLO-only CounterSet doesn't have.
    if cset.total_jobs > 0 and cset.bytes_read > cache.llc_bytes:
        hide = min(1.0, n_hat / cache.hide_concurrency)
        tiles = max(1.0, cset.num_waves / max(cset.waves_per_tile, 1))
        exposure = (tiles / num_cores) * cache.miss_latency_cycles * (1.0 - hide)
    else:
        exposure = 0.0
    mem_eff = mem_ideal + exposure
    compute_cycles = (cset.flops / num_cores) / (chip.peak_bf16_flops
                                                 / chip.clock_hz)
    ici_cycles = cset.ici_bytes / (chip.ici_bw_per_link / chip.clock_hz)

    T = cset.overhead_cycles + np.maximum(
        scatter_busy,
        np.maximum(mem_eff, np.maximum(compute_cycles, ici_cycles)))

    # Phase 3: utilization against the modeled window.  B and S are
    # T-independent, so reuse phase 1's rows verbatim (no second
    # derive_core_utilization pass, no re-interpolation) and only swap in
    # the modeled window and the resulting U = B / T.
    per_core = [
        dataclasses.replace(
            row, T_cycles=float(T[i]),
            U=row.B_cycles / float(T[i]) if T[i] > 0 else 0.0)
        for i, row in enumerate(prelim)
    ]

    window = float(np.max(T))
    # One fixed unit set for every source: sweeps stack unit names across
    # points, so membership must not depend on a point's values (an
    # ici-less point in a collective sweep would otherwise crash the
    # stacking), and a server missing from the report could never be
    # named as the bottleneck it is.
    units = [
        UnitUtilization("scatter", float(np.mean(scatter_busy)), window),
        UnitUtilization("hbm", float(mem_eff), window),
        UnitUtilization("mxu", float(compute_cycles), window),
        UnitUtilization("ici", float(ici_cycles), window),
    ]
    return WorkloadProfile(
        label=cset.label, per_core=per_core, units=units, T_cycles=T,
        params={"bytes_read": cset.bytes_read, "flops": cset.flops,
                "overhead_cycles": cset.overhead_cycles,
                "use_true_n": use_true_n, "source": cset.source,
                "wall_time_s": cset.wall_time_s,
                "meta": dict(cset.meta)},
    )


def profile_batch(
    frame: counters_mod.CounterFrame,
    table: qmodel.ServiceTimeTable,
    *,
    params: Optional[timing.ScatterUnitParams] = None,
    chip: Optional[timing.ChipParams] = None,
    cache: Optional[CacheModel] = None,
    use_true_n: bool = False,
) -> list[WorkloadProfile]:
    """Profile a whole ``CounterFrame`` in one columnar model pass.

    Point-for-point equivalent to calling ``profile_counters`` on each
    row (same U, n-hat, e, busy times, windows, unit set — verified by
    the batch-equivalence test suite), but the entire §3 pipeline —
    occupancy geometry, the global e, c per core, ``S(n, e, c)`` via the
    precompiled ``TableInterpolator``, busy time B, the kernel-time
    window T, the four companion units — runs as whole-(P, C)-array
    numpy ops.  A sweep's thousands of service-time lookups collapse
    into one fused gather instead of thousands of Python ``trilinear``
    calls; only the final (cheap) ``WorkloadProfile`` assembly loops.

    Bottleneck argmax and the shift-hysteresis tolerance live on the
    returned ``WorkloadProfile``/``bottleneck.detect_shifts`` exactly as
    for the scalar path, so verdicts and shift events are identical by
    construction once the arrays match.
    """
    if params is None:
        params = timing.V5E_SCATTER
    if chip is None:
        chip = timing.V5E
    if cache is None:
        cache = CacheModel()
    P, C = frame.num_points, frame.num_cores
    if P == 0:
        return []
    n_max = params.n_max

    # -- phase 1: scatter busy time, all points x cores at once ----------
    total_jobs = frame.total_jobs                       # (P,)
    has_jobs = total_jobs > 0
    e_global = frame.e                                  # (P,)
    n_hat_pt = (frame.true_n(n_max) if use_true_n
                else frame.occupancy(n_max) * n_max)    # (P,)
    n_hat_b = np.broadcast_to(n_hat_pt[:, None], (P, C))
    e_b = np.broadcast_to(e_global[:, None], (P, C))
    n_faocas = frame.N_f + frame.N_c                    # (P, C)
    has_fc = n_faocas > 0
    c_avg = np.where(
        has_fc, n_hat_b * (frame.N_c / np.where(has_fc, n_faocas, 1.0)), 0.0)
    S = np.where(has_fc, table.service_time_batch(n_hat_b, e_b, c_avg), 0.0)
    busy = n_faocas * S
    if table.popc_T is not None and np.any(frame.N_p > 0):
        S_p = table.popc_service_time_batch(n_hat_b, e_b)
        busy = busy + np.where(frame.N_p > 0, frame.N_p * S_p, 0.0)
    scatter_busy = np.where(has_jobs[:, None], busy, 0.0)

    # -- phase 2: companion units and the kernel-time window -------------
    num_cores_f = float(C)
    bytes_per_cycle = chip.hbm_bw / chip.clock_hz
    mem_ideal = (frame.bytes_read / num_cores_f) / bytes_per_cycle  # (P,)
    exp_cond = has_jobs & (frame.bytes_read > cache.llc_bytes)
    hide = np.minimum(1.0, n_hat_pt / cache.hide_concurrency)
    tiles = np.maximum(1.0,
                       frame.num_waves / np.maximum(frame.waves_per_tile, 1))
    exposure = np.where(
        exp_cond,
        (tiles / num_cores_f) * cache.miss_latency_cycles * (1.0 - hide),
        0.0)
    mem_eff = mem_ideal + exposure
    compute_cycles = (frame.flops / num_cores_f) / (chip.peak_bf16_flops
                                                    / chip.clock_hz)
    ici_cycles = frame.ici_bytes / (chip.ici_bw_per_link / chip.clock_hz)
    T = frame.overhead_cycles[:, None] + np.maximum(
        scatter_busy,
        np.maximum(mem_eff[:, None],
                   np.maximum(compute_cycles[:, None], ici_cycles[:, None])))

    # -- phase 3: utilization + per-point assembly -----------------------
    U = np.where(T > 0, scatter_busy / np.where(T > 0, T, 1.0), 0.0)
    scatter_mean = np.mean(scatter_busy, axis=1)        # (P,)
    window = np.max(T, axis=1)                          # (P,)
    N_pc = frame.N
    profiles = []
    for i in range(P):
        if has_jobs[i]:
            per_core = [
                qmodel.CoreUtilization(
                    core_id=core, N=float(N_pc[i, core]),
                    n_hat=float(n_hat_pt[i]), e=float(e_global[i]),
                    c=float(c_avg[i, core]), S_cycles=float(S[i, core]),
                    B_cycles=float(scatter_busy[i, core]),
                    T_cycles=float(T[i, core]), U=float(U[i, core]))
                for core in range(C)
            ]
        else:
            per_core = []
        w = float(window[i])
        units = [
            UnitUtilization("scatter", float(scatter_mean[i]), w),
            UnitUtilization("hbm", float(mem_eff[i]), w),
            UnitUtilization("mxu", float(compute_cycles[i]), w),
            UnitUtilization("ici", float(ici_cycles[i]), w),
        ]
        profiles.append(WorkloadProfile(
            label=frame.labels[i], per_core=per_core, units=units,
            T_cycles=T[i].copy(),
            params={"bytes_read": float(frame.bytes_read[i]),
                    "flops": float(frame.flops[i]),
                    "overhead_cycles": float(frame.overhead_cycles[i]),
                    "use_true_n": use_true_n, "source": frame.sources[i],
                    "wall_time_s": frame.wall_time_s[i],
                    "meta": dict(frame.meta[i] or {})},
        ))
    return profiles


def profile_scatter_workload(
    trace: counters_mod.WaveTrace,
    table: qmodel.ServiceTimeTable,
    *,
    label: str = "",
    bytes_read: float = 0.0,
    flops: float = 0.0,
    num_cores: int = 8,
    overhead_cycles: float = 2000.0,
    params: Optional[timing.ScatterUnitParams] = None,
    chip: Optional[timing.ChipParams] = None,
    cache: Optional[CacheModel] = None,
    use_true_n: bool = False,
) -> WorkloadProfile:
    """Profile one scatter-heavy launch from its wave trace (legacy entry).

    Aggregates the trace into a ``CounterSet`` and delegates to
    ``profile_counters`` — kept for the pre-provider call sites; new code
    should go through ``repro_torch.analysis.Session`` / a provider.
    """
    cset = counters_mod.CounterSet.from_trace(
        trace, label=label, num_cores=num_cores, bytes_read=bytes_read,
        flops=flops, overhead_cycles=overhead_cycles)
    return profile_counters(cset, table, params=params, chip=chip,
                            cache=cache, use_true_n=use_true_n)


def profile_compiled_step(
    capture,
    *,
    label: str,
    chips: int,
    hlo_text: Optional[str] = None,
    chip: timing.ChipParams = timing.V5E,
) -> WorkloadProfile:
    """Whole-step profile from a captured step (dry-run path): the
    reference's from its compiled object.

    The scatter unit needs runtime data (it is data-dependent — that is
    the paper's point), so this path reports the three static units; the
    scatter report is attached by the caller when an instrumented run (or
    synthetic trace) is available.  ``hlo_text``, where given, supplies
    the collectives instead of the capture's own.
    """
    from repro_torch.core import hlo as hlo_mod
    flops, nbytes = hlo_mod.flops_and_bytes(capture)
    coll = (hlo_mod.parse_collectives(hlo_text, chips) if hlo_text is not None
            else hlo_mod.capture_collectives(capture))
    mxu = flops / (chip.peak_bf16_flops / chip.clock_hz)
    hbm = nbytes / (chip.hbm_bw / chip.clock_hz)
    ici = coll.total_wire_bytes / (chip.ici_bw_per_link / chip.clock_hz)
    window = max(mxu, hbm, ici, 1.0)
    units = [
        UnitUtilization("mxu", mxu, window),
        UnitUtilization("hbm", hbm, window),
        UnitUtilization("ici", ici, window),
    ]
    return WorkloadProfile(label=label, per_core=[], units=units,
                           T_cycles=np.array([window]))


def utilization_sweep(
    profiles: Sequence[WorkloadProfile],
) -> dict[str, np.ndarray]:
    """Stack unit utilizations across a parameter sweep (for Figs. 3-4).

    Unit membership is the *union* across all points, in first-appearance
    order, with 0.0 filled where a point lacks the unit — heterogeneous
    sweeps (e.g. mixing an HLO-only point into a scatter sweep, or custom
    profiles with extra servers) must not KeyError on names the first
    profile happens to miss.  An empty sweep has no axes to stack: ``{}``.
    """
    if not profiles:
        return {}
    names: list[str] = []
    for p in profiles:
        for u in p.units:
            if u.name not in names:
                names.append(u.name)

    def util(p: WorkloadProfile, name: str) -> float:
        try:
            return p.unit(name).utilization
        except KeyError:
            return 0.0

    out = {n: np.array([util(p, n) for p in profiles]) for n in names}
    out["scatter_model"] = np.array([p.scatter_utilization for p in profiles])
    return out
