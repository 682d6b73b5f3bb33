"""Basic operational quantities (paper Table 1) from kernel instrumentation.

The GPU paper reads NVProf/NCU counters; our counters come from the
instrumented Pallas kernels, which emit a *wave trace*: one record per
scatter wave job with its serialization degree, job class, and the core it
was scheduled on.  This module aggregates a trace into per-core
``BasicCounters``:

    O      <- sum of per-wave serialization degrees (total transactions;
              the analogue of smsp__l1tex_mem_shared_op_atom.sum, which
              counts bank-conflict replays)
    N_f/N_c/N_p <- per-class wave job counts per core
    T      <- modeled active cycles per core (from the kernel-time model
              in core.profiler, which includes the non-scatter work)
    o      <- achieved occupancy: avg in-flight waves / n_max

It also reproduces the paper's estimation gap: ``n_hat = o * n_max``
(their only option) versus the instrumented true queue length ``n_true``
(our addition; the paper explicitly recommends hardware add this counter).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import timing
from repro_torch.core.qmodel import BasicCounters

LANES = 1024        # 8 x 128 VPU lane group = one wave
COMMIT_GROUP = 32   # lanes that commit to VMEM together; conflicts
                    # serialize within a group (GPU warp/bank analogue)


def wave_degree(indices: np.ndarray, lanes: int = LANES,
                group: int = COMMIT_GROUP) -> float:
    """Serialization degree of one wave of scatter indices.

    The VPU commit path retires ``group`` lanes per pass; duplicate
    destination indices within a commit group must serialize (the analogue
    of same-address shared-memory atomic replays in a 32-thread warp).
    The wave's degree is the mean over commit groups of the max duplicate
    multiplicity — exactly the quantity the paper's ``O`` counter
    (replay count) divided by ``N`` (warp-instructions) measures:
    solid-color histograms give 32, uniform-random ~2-3, conflict-free 1.
    """
    idx = np.asarray(indices).reshape(-1)
    if idx.size == 0:
        return 1.0
    pad = (-idx.size) % group
    if pad:
        # pad with unique sentinels so padding never adds conflicts
        sentinel = idx.max(initial=0) + 1 + np.arange(pad)
        idx = np.concatenate([idx, sentinel])
    g = idx.reshape(-1, group)
    eq = g[:, :, None] == g[:, None, :]          # (G, group, group)
    mult = eq.sum(axis=2)                        # duplicate multiplicity
    return float(np.mean(mult.max(axis=1)))


def geometry_occupancy(num_waves: int, waves_per_tile: int,
                       pipeline_depth: int, n_max: int) -> float:
    """Achieved concurrency fraction from launch geometry.

    In-flight jobs = waves per tile x pipeline depth, capped by n_max and
    by the total work available.
    """
    inflight = min(waves_per_tile * pipeline_depth, n_max, max(num_waves, 1))
    return inflight / n_max


def geometry_true_n(num_waves: int, waves_per_tile: int,
                    pipeline_depth: int, n_max: int) -> float:
    """Instrumented time-average queue length from launch geometry.

    All waves of a tile are issued together; with double buffering the
    queue holds up to waves_per_tile * depth jobs while the tail drains to
    0.  The time-average over a long launch sits near the issued
    concurrency, degraded by the drain fraction.
    """
    if num_waves == 0:
        return 0.0
    burst = min(waves_per_tile * pipeline_depth, n_max)
    full_bursts = num_waves // max(burst, 1)
    tail = num_waves - full_bursts * burst
    # time-weighted average of a sawtooth: mean of (burst .. 1)
    avg_full = (burst + 1) / 2.0
    avg_tail = (tail + 1) / 2.0 if tail else 0.0
    w_full = full_bursts * burst
    w_tail = tail
    denom = w_full + w_tail
    return (avg_full * w_full + avg_tail * w_tail) / denom if denom else 0.0


@dataclasses.dataclass
class WaveTrace:
    """Per-wave instrumentation records for one kernel launch."""

    degree: np.ndarray          # (W,) serialization degree per wave (>= 1)
    job_class: np.ndarray       # (W,) timing.FAO / timing.CAS / timing.POPC
    core: np.ndarray            # (W,) core the wave's tile was scheduled on
    lanes_active: np.ndarray    # (W,) active lanes (<= LANES)
    waves_per_tile: int = 1     # launch geometry: waves issued per grid tile
    pipeline_depth: int = 2     # Pallas double buffering

    def __post_init__(self) -> None:
        self.degree = np.asarray(self.degree, np.float64)
        self.job_class = np.asarray(self.job_class, np.int32)
        self.core = np.asarray(self.core, np.int32)
        self.lanes_active = np.asarray(self.lanes_active, np.float64)

    @property
    def num_waves(self) -> int:
        return int(self.degree.shape[0])

    def with_geometry(self, waves_per_tile: Optional[int] = None,
                      pipeline_depth: Optional[int] = None) -> "WaveTrace":
        """Copy of this trace with a different launch geometry.

        The per-wave records are shared (they are measurement, not
        geometry); only the occupancy-defining launch parameters change.
        Prefer this over mutating ``waves_per_tile`` in place.
        """
        return dataclasses.replace(
            self,
            waves_per_tile=self.waves_per_tile if waves_per_tile is None
            else int(waves_per_tile),
            pipeline_depth=self.pipeline_depth if pipeline_depth is None
            else int(pipeline_depth),
        )

    def occupancy(self, n_max: int) -> float:
        """Achieved concurrency fraction (see ``geometry_occupancy``)."""
        return geometry_occupancy(self.num_waves, self.waves_per_tile,
                                  self.pipeline_depth, n_max)

    def true_n(self, n_max: int) -> float:
        """Instrumented time-avg queue length (see ``geometry_true_n``)."""
        return geometry_true_n(self.num_waves, self.waves_per_tile,
                               self.pipeline_depth, n_max)


def concat_traces(traces: Sequence[WaveTrace]) -> WaveTrace:
    return WaveTrace(
        degree=np.concatenate([t.degree for t in traces]),
        job_class=np.concatenate([t.job_class for t in traces]),
        core=np.concatenate([t.core for t in traces]),
        lanes_active=np.concatenate([t.lanes_active for t in traces]),
        waves_per_tile=traces[0].waves_per_tile,
        pipeline_depth=traces[0].pipeline_depth,
    )  # geometry from the first trace: concat is per-launch, not cross-launch


def _degrees_full_waves(idx: np.ndarray, group: int,
                        chunk: int = 2048) -> np.ndarray:
    """``wave_degree`` for a (..., wave) block of *complete* waves at once.

    The trailing axis is the wave; any leading axes — a single launch's
    (W,) wave list, or a whole sweep's (P, W) points-by-waves grid — are
    flattened, processed in chunks, and restored on the way out.
    Bit-identical to calling ``wave_degree`` per row: the maximum
    multiplicity within a commit group equals the longest run of equal
    values once the group is sorted, so the O(group^2) pairwise-equality
    tensor collapses to a sort plus O(group) run-length passes — exact
    integer counts either way, fed through the same int64 ``mean`` over
    the same group axis (the per-row result never depends on which chunk
    a row lands in).  The big ops release the GIL — which is what lets
    ``Session.sweep``'s thread pool actually overlap points — and the
    chunking bounds the sorted copy's working set.
    """
    idx = np.asarray(idx)
    lead = idx.shape[:-1]
    wave = idx.shape[-1]
    flat = idx.reshape(-1, wave)
    W = flat.shape[0]
    out = np.empty(W, np.float64)
    G = wave // group
    ar = np.arange(group, dtype=np.int64)
    for st in range(0, W, chunk):
        g = flat[st:st + chunk].reshape(-1, G, group)
        s = np.sort(g, axis=-1)
        start = np.empty(s.shape, bool)     # True where a new run begins
        start[..., 0] = True
        start[..., 1:] = s[..., 1:] != s[..., :-1]
        first = np.maximum.accumulate(np.where(start, ar, 0), axis=-1)
        mult = (ar - first).max(axis=-1) + 1    # (n, G) max multiplicity
        out[st:st + chunk] = mult.mean(axis=1)
    return out.reshape(lead)


def trace_from_indices(
    indices: np.ndarray,
    num_bins: int,
    *,
    num_cores: int = 1,
    wave: int = LANES,
    job_class: int = timing.FAO,
    waves_per_tile: int = 1,
    pipeline_depth: int = 2,
) -> WaveTrace:
    """Build the wave trace a kernel's instrumentation would emit.

    ``indices`` is the flat stream of scatter destinations; waves are
    consecutive ``wave``-sized groups; tiles round-robin across cores the
    way a Pallas grid schedules across TensorCores.  The per-wave degree is
    ceil(active / distinct): a wave whose lanes all hit one bin serializes
    fully; all-distinct commits in one pass.  This mirrors what
    ``kernels/instrumentation.py`` computes inside the kernel.
    """
    idx = np.asarray(indices).reshape(-1)
    n = idx.shape[0]
    num_waves = max(1, -(-n // wave))
    degree = np.empty(num_waves, np.float64)
    active = np.empty(num_waves, np.float64)
    # complete waves go through the vectorized bulk path; at most one
    # trailing partial wave (sentinel-padded) keeps the scalar one
    full = n // wave if wave % COMMIT_GROUP == 0 else 0
    if full:
        degree[:full] = _degrees_full_waves(
            idx[:full * wave].reshape(full, wave), COMMIT_GROUP)
        active[:full] = wave
    for w in range(full, num_waves):
        part = idx[w * wave:(w + 1) * wave]
        active[w] = part.shape[0]
        degree[w] = wave_degree(part)
    tiles = np.arange(num_waves) // max(waves_per_tile, 1)
    cores = (tiles % num_cores).astype(np.int32)
    return WaveTrace(
        degree=degree,
        job_class=np.full(num_waves, job_class, np.int32),
        core=cores,
        lanes_active=active,
        waves_per_tile=waves_per_tile,
        pipeline_depth=pipeline_depth,
    )


def _per_point(value, num_points: int, name: str) -> list:
    """Broadcast a scalar parameter to P points (sequences pass through)."""
    if isinstance(value, (list, tuple, np.ndarray)):
        out = list(value)
        if len(out) != num_points:
            raise ValueError(f"{name} has {len(out)} entries for "
                             f"{num_points} index streams")
        return out
    return [value] * num_points


def traces_from_index_batch(
    index_streams: Sequence[np.ndarray],
    *,
    num_cores=1,
    wave: int = LANES,
    job_class=timing.FAO,
    waves_per_tile=1,
    pipeline_depth=2,
) -> list[WaveTrace]:
    """Batch ``trace_from_indices``: P index streams -> P wave traces.

    The whole grid's complete waves go through ``_degrees_full_waves`` as
    one stacked (P', W, wave) tensor per stream-length group, instead of
    one call per point — this is what makes a cold sweep's collection
    cost a handful of large numpy ops.  Each per-point parameter accepts
    either a scalar (shared by all points) or a length-P sequence.

    Bit-for-bit equal to calling ``trace_from_indices`` per stream: the
    degree math is row-independent (stacking only adds a leading axis the
    kernel never mixes across), trailing partial waves keep the scalar
    sentinel-padded path, and the tile/core round-robin is computed per
    point exactly as before.
    """
    streams = [np.asarray(s).reshape(-1) for s in index_streams]
    P = len(streams)
    cores_l = _per_point(num_cores, P, "num_cores")
    class_l = _per_point(job_class, P, "job_class")
    wpt_l = _per_point(waves_per_tile, P, "waves_per_tile")
    depth_l = _per_point(pipeline_depth, P, "pipeline_depth")
    degrees: list = [None] * P
    actives: list = [None] * P
    by_length: dict = {}
    for i, s in enumerate(streams):
        by_length.setdefault(s.shape[0], []).append(i)
    for n, members in by_length.items():
        num_waves = max(1, -(-n // wave))
        full = n // wave if wave % COMMIT_GROUP == 0 else 0
        deg = np.empty((len(members), num_waves), np.float64)
        act = np.empty((len(members), num_waves), np.float64)
        if full:
            stacked = np.stack(
                [streams[i][:full * wave].reshape(full, wave)
                 for i in members])
            deg[:, :full] = _degrees_full_waves(stacked, COMMIT_GROUP)
            act[:, :full] = wave
        for row, i in enumerate(members):
            s = streams[i]
            for w in range(full, num_waves):
                part = s[w * wave:(w + 1) * wave]
                act[row, w] = part.shape[0]
                deg[row, w] = wave_degree(part)
            degrees[i] = deg[row].copy()
            actives[i] = act[row].copy()
    out = []
    for i in range(P):
        num_waves = degrees[i].shape[0]
        tiles = np.arange(num_waves) // max(wpt_l[i], 1)
        out.append(WaveTrace(
            degree=degrees[i],
            job_class=np.full(num_waves, class_l[i], np.int32),
            core=(tiles % cores_l[i]).astype(np.int32),
            lanes_active=actives[i],
            waves_per_tile=wpt_l[i],
            pipeline_depth=depth_l[i],
        ))
    return out


# ---------------------------------------------------------------------------
# CounterSet: the uniform counter bundle every acquisition backend returns
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CounterSet:
    """Uniform paper-Table-1 counter bundle, independent of its source.

    Every ``repro_torch.analysis.providers`` backend — synthetic trace,
    instrumented Pallas kernel, HLO cost analysis, microbenchmark timing —
    returns one of these, and ``core.profiler.profile_counters`` consumes
    it.  The scatter-unit counters are per-core arrays (length
    ``num_cores``); a source with no scatter visibility (HLO) leaves them
    zero and only fills the roofline side (``bytes_read``/``flops``/
    ``ici_bytes``).  ``wall_time_s`` is filled when the source actually
    timed something (microbench path); ``None`` means modeled-only.
    """

    label: str
    source: str = "trace"
    num_cores: int = 1
    # scatter-unit counters, one entry per core ((num_cores,) arrays):
    O: np.ndarray = None            # serialization transactions per core
    N_f: np.ndarray = None          # FAO-class wave jobs per core
    N_c: np.ndarray = None          # CAS-class wave jobs per core
    N_p: np.ndarray = None          # POPC-class wave jobs per core
    lanes_active: float = float(LANES)  # mean active lanes per wave
    # launch geometry (defines the occupancy estimate n_hat):
    num_waves: int = 0
    waves_per_tile: int = 1
    pipeline_depth: int = 2
    # roofline-side counters:
    bytes_read: float = 0.0
    flops: float = 0.0
    ici_bytes: float = 0.0          # per-link collective wire traffic
    overhead_cycles: float = 500.0
    wall_time_s: Optional[float] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for name in ("O", "N_f", "N_c", "N_p"):
            v = getattr(self, name)
            if v is None:
                v = np.zeros(self.num_cores)
            setattr(self, name, np.asarray(v, np.float64))

    # -- derived (paper Table 2 inputs) -----------------------------------

    @property
    def N(self) -> np.ndarray:
        """Total wave jobs per core."""
        return self.N_f + self.N_c + self.N_p

    @property
    def total_jobs(self) -> float:
        return float(np.sum(self.N))

    @property
    def total_O(self) -> float:
        return float(np.sum(self.O))

    @property
    def e(self) -> float:
        """Global average serialization degree e = O / N (paper Table 2)."""
        n = self.total_jobs
        return self.total_O / n if n else 1.0

    def occupancy(self, n_max: int) -> float:
        return geometry_occupancy(self.num_waves, self.waves_per_tile,
                                  self.pipeline_depth, n_max)

    def true_n(self, n_max: int) -> float:
        return geometry_true_n(self.num_waves, self.waves_per_tile,
                               self.pipeline_depth, n_max)

    # -- construction / conversion ----------------------------------------

    @classmethod
    def from_trace(cls, trace: "WaveTrace", *, label: str = "",
                   num_cores: int = 1, bytes_read: float = 0.0,
                   flops: float = 0.0, overhead_cycles: float = 500.0,
                   source: str = "trace", wall_time_s: Optional[float] = None,
                   meta: Optional[dict] = None) -> "CounterSet":
        """Aggregate a wave trace into the per-core counter bundle."""
        O = np.zeros(num_cores)
        n_f = np.zeros(num_cores)
        n_c = np.zeros(num_cores)
        n_p = np.zeros(num_cores)
        for core in range(num_cores):
            sel = trace.core == core
            O[core] = float(np.sum(trace.degree[sel]))
            cls_sel = trace.job_class[sel]
            n_f[core] = float(np.sum(cls_sel == timing.FAO))
            n_c[core] = float(np.sum(cls_sel == timing.CAS))
            n_p[core] = float(np.sum(cls_sel == timing.POPC))
        lanes = (float(np.mean(trace.lanes_active))
                 if trace.num_waves else float(LANES))
        return cls(
            label=label, source=source, num_cores=num_cores,
            O=O, N_f=n_f, N_c=n_c, N_p=n_p, lanes_active=lanes,
            num_waves=trace.num_waves, waves_per_tile=trace.waves_per_tile,
            pipeline_depth=trace.pipeline_depth,
            bytes_read=bytes_read, flops=flops,
            overhead_cycles=overhead_cycles, wall_time_s=wall_time_s,
            meta=dict(meta or {}),
        )

    def to_basic_counters(self, T_cycles_per_core: np.ndarray,
                          n_max: int) -> list[BasicCounters]:
        """Per-core ``BasicCounters`` against a given measurement window."""
        occ = self.occupancy(n_max)
        n_true = self.true_n(n_max)
        return [
            BasicCounters(
                O=float(self.O[core]), N_f=float(self.N_f[core]),
                N_c=float(self.N_c[core]), N_p=float(self.N_p[core]),
                T_cycles=float(T_cycles_per_core[core]),
                occupancy=occ, n_true=n_true, core_id=core)
            for core in range(self.num_cores)
        ]


def bitwise_equal(a: CounterSet, b: CounterSet,
                  ignore: Sequence[str] = ()) -> bool:
    """Exact field-by-field equality of two counter bundles.

    Arrays must match in dtype, shape, and every bit; floats compare with
    ``==`` (no tolerance).  This is the acceptance check for the batch
    collection path: ``collect_batch(specs).row(i)`` must pass against
    ``collect(specs[i])`` for every provider.  ``ignore`` names fields to
    skip — callers comparing providers that *measure* (microbench) pass
    ``("wall_time_s", "meta")``, since two wall-clock readings never
    agree bit for bit even on the scalar path.
    """
    for field in dataclasses.fields(CounterSet):
        if field.name in ignore:
            continue
        va = getattr(a, field.name)
        vb = getattr(b, field.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not (isinstance(va, np.ndarray) and isinstance(vb, np.ndarray)):
                return False
            if va.dtype != vb.dtype or va.shape != vb.shape:
                return False
            if not np.array_equal(va, vb):
                return False
        elif va != vb:
            return False
    return True


def countersets_from_traces(
    traces: Sequence["WaveTrace"],
    *,
    labels: Sequence[str],
    num_cores=1,
    bytes_read=0.0,
    flops=0.0,
    overhead_cycles=500.0,
    source: str = "trace",
) -> list["CounterSet"]:
    """Batch ``CounterSet.from_trace``: P wave traces -> P counter bundles.

    Traces sharing a core-assignment pattern are aggregated as stacked
    (P', W) columns — one masked row-sum per core for the whole group
    instead of per-trace numpy calls, which is where a large sweep's
    aggregation time actually goes.  Bit-identical to per-trace
    ``from_trace``: rows with the same core pattern select the same wave
    columns, and a row of the stacked masked sum / mean reduces the same
    contiguous values in the same order as the scalar call.  Per-trace
    parameters accept a scalar or a length-P sequence, as in
    ``traces_from_index_batch``.
    """
    traces = list(traces)
    P = len(traces)
    labels = list(labels)
    if len(labels) != P:
        raise ValueError(f"{len(labels)} labels for {P} traces")
    cores_l = _per_point(num_cores, P, "num_cores")
    bytes_l = _per_point(bytes_read, P, "bytes_read")
    flops_l = _per_point(flops, P, "flops")
    ovh_l = _per_point(overhead_cycles, P, "overhead_cycles")
    out: list = [None] * P
    groups: dict = {}
    for i, tr in enumerate(traces):
        if tr.num_waves == 0:       # degenerate: keep the scalar reference
            out[i] = CounterSet.from_trace(
                traces[i], label=labels[i], num_cores=cores_l[i],
                bytes_read=bytes_l[i], flops=flops_l[i],
                overhead_cycles=ovh_l[i], source=source)
            continue
        key = (tr.num_waves, cores_l[i], tr.core.tobytes())
        groups.setdefault(key, []).append(i)
    for (num_waves, C, _), members in groups.items():
        deg = np.stack([traces[i].degree for i in members])         # (P', W)
        cls = np.stack([traces[i].job_class for i in members])
        lanes = np.stack([traces[i].lanes_active for i in members])
        core_pattern = traces[members[0]].core
        O = np.zeros((len(members), C))
        n_f = np.zeros((len(members), C))
        n_c = np.zeros((len(members), C))
        n_p = np.zeros((len(members), C))
        for c in range(C):
            sel = core_pattern == c
            O[:, c] = np.sum(deg[:, sel], axis=1)
            cls_sel = cls[:, sel]
            n_f[:, c] = np.sum(cls_sel == timing.FAO, axis=1)
            n_c[:, c] = np.sum(cls_sel == timing.CAS, axis=1)
            n_p[:, c] = np.sum(cls_sel == timing.POPC, axis=1)
        lanes_mean = np.mean(lanes, axis=1)
        for row, i in enumerate(members):
            tr = traces[i]
            out[i] = CounterSet(
                label=labels[i], source=source, num_cores=C,
                O=O[row].copy(), N_f=n_f[row].copy(),
                N_c=n_c[row].copy(), N_p=n_p[row].copy(),
                lanes_active=float(lanes_mean[row]),
                num_waves=tr.num_waves, waves_per_tile=tr.waves_per_tile,
                pipeline_depth=tr.pipeline_depth,
                bytes_read=bytes_l[i], flops=flops_l[i],
                overhead_cycles=ovh_l[i],
            )
    return out


# ---------------------------------------------------------------------------
# CounterFrame: a columnar (struct-of-arrays) stack of CounterSets
# ---------------------------------------------------------------------------


def _occupancy_batch(num_waves: np.ndarray, waves_per_tile: np.ndarray,
                     pipeline_depth: np.ndarray, n_max: int) -> np.ndarray:
    """Vectorized ``geometry_occupancy`` (identical min-chain, per point)."""
    inflight = np.minimum(np.minimum(waves_per_tile * pipeline_depth, n_max),
                          np.maximum(num_waves, 1))
    return inflight / float(n_max)


def _true_n_batch(num_waves: np.ndarray, waves_per_tile: np.ndarray,
                  pipeline_depth: np.ndarray, n_max: int) -> np.ndarray:
    """Vectorized ``geometry_true_n`` (same sawtooth algebra, per point)."""
    burst = np.minimum(waves_per_tile * pipeline_depth, n_max)
    safe_burst = np.maximum(burst, 1)
    full_bursts = num_waves // safe_burst
    tail = num_waves - full_bursts * burst
    avg_full = (burst + 1) / 2.0
    avg_tail = np.where(tail > 0, (tail + 1) / 2.0, 0.0)
    w_full = full_bursts * burst
    denom = w_full + tail
    num = avg_full * w_full + avg_tail * tail
    return np.where(denom > 0, num / np.where(denom > 0, denom, 1), 0.0)


def _sequential_row_sum(arr: np.ndarray) -> np.ndarray:
    """Left-to-right row sums of a (P, C) array.

    Matches the accumulation order of a Python ``sum`` over per-core
    scalars (the scalar model path), which numpy's pairwise ``np.sum``
    does not guarantee — keeping the batch profiler bit-identical to the
    per-point reference.  C is the core count (<= a few dozen), so the
    Python loop is over columns only.
    """
    out = np.zeros(arr.shape[0], np.float64)
    for col in range(arr.shape[1]):
        out = out + arr[:, col]
    return out


@dataclasses.dataclass
class CounterFrame:
    """Struct-of-arrays stack of ``CounterSet``s: shape = points x cores.

    The batch-profiling engine's input: where a ``CounterSet`` holds one
    launch's per-core counters, a ``CounterFrame`` holds a whole sweep's
    as (P, C) columns, so the §3 queueing model evaluates in whole-array
    numpy ops (``profiler.profile_batch``) instead of a per-point Python
    loop.  The stack is rectangular — every row must share ``num_cores``
    (``Session`` groups heterogeneous sweeps before framing).
    """

    labels: list                    # (P,) point labels
    sources: list                   # (P,) provider names
    num_cores: int                  # C, uniform across rows
    O: np.ndarray                   # (P, C) serialization transactions
    N_f: np.ndarray                 # (P, C) FAO-class wave jobs
    N_c: np.ndarray                 # (P, C) CAS-class wave jobs
    N_p: np.ndarray                 # (P, C) POPC-class wave jobs
    lanes_active: np.ndarray        # (P,) mean active lanes per wave
    num_waves: np.ndarray           # (P,) launch geometry
    waves_per_tile: np.ndarray      # (P,)
    pipeline_depth: np.ndarray      # (P,)
    bytes_read: np.ndarray          # (P,) roofline side
    flops: np.ndarray               # (P,)
    ici_bytes: np.ndarray           # (P,)
    overhead_cycles: np.ndarray     # (P,)
    wall_time_s: list               # (P,) Optional[float] per point
    meta: list                      # (P,) per-point meta dicts

    @classmethod
    def from_sets(cls, csets: Sequence["CounterSet"]) -> "CounterFrame":
        """Stack CounterSets column-wise; rejects ragged core counts."""
        csets = list(csets)
        if not csets:
            raise ValueError("CounterFrame needs at least one CounterSet")
        cores = {cs.num_cores for cs in csets}
        if len(cores) != 1:
            raise ValueError(
                f"CounterFrame rows must share num_cores, got {sorted(cores)}"
                f" — group the sweep by core count first")
        return cls(
            labels=[cs.label for cs in csets],
            sources=[cs.source for cs in csets],
            num_cores=csets[0].num_cores,
            O=np.stack([cs.O for cs in csets]),
            N_f=np.stack([cs.N_f for cs in csets]),
            N_c=np.stack([cs.N_c for cs in csets]),
            N_p=np.stack([cs.N_p for cs in csets]),
            lanes_active=np.array([cs.lanes_active for cs in csets]),
            num_waves=np.array([cs.num_waves for cs in csets], np.int64),
            waves_per_tile=np.array([cs.waves_per_tile for cs in csets],
                                    np.int64),
            pipeline_depth=np.array([cs.pipeline_depth for cs in csets],
                                    np.int64),
            bytes_read=np.array([cs.bytes_read for cs in csets], np.float64),
            flops=np.array([cs.flops for cs in csets], np.float64),
            ici_bytes=np.array([cs.ici_bytes for cs in csets], np.float64),
            overhead_cycles=np.array([cs.overhead_cycles for cs in csets],
                                     np.float64),
            wall_time_s=[cs.wall_time_s for cs in csets],
            meta=[cs.meta for cs in csets],
        )

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def num_points(self) -> int:
        return len(self.labels)

    def row(self, i: int) -> "CounterSet":
        """Reconstruct row ``i`` as a standalone ``CounterSet``."""
        return CounterSet(
            label=self.labels[i], source=self.sources[i],
            num_cores=self.num_cores,
            O=self.O[i].copy(), N_f=self.N_f[i].copy(),
            N_c=self.N_c[i].copy(), N_p=self.N_p[i].copy(),
            lanes_active=float(self.lanes_active[i]),
            num_waves=int(self.num_waves[i]),
            waves_per_tile=int(self.waves_per_tile[i]),
            pipeline_depth=int(self.pipeline_depth[i]),
            bytes_read=float(self.bytes_read[i]),
            flops=float(self.flops[i]),
            ici_bytes=float(self.ici_bytes[i]),
            overhead_cycles=float(self.overhead_cycles[i]),
            wall_time_s=self.wall_time_s[i],
            meta=dict(self.meta[i]),
        )

    # -- derived columns (vectorized paper-Table-2 inputs) -----------------

    @property
    def N(self) -> np.ndarray:
        """Total wave jobs per (point, core) — (N_f + N_c) + N_p, the
        scalar path's addition order."""
        return (self.N_f + self.N_c) + self.N_p

    @property
    def total_jobs(self) -> np.ndarray:
        """(P,) total jobs per point (sequential core sum, see above)."""
        return _sequential_row_sum(self.N)

    @property
    def total_O(self) -> np.ndarray:
        """(P,) total transactions per point (sequential core sum)."""
        return _sequential_row_sum(self.O)

    @property
    def e(self) -> np.ndarray:
        """(P,) global serialization degree e = O / N (1.0 where idle)."""
        jobs = self.total_jobs
        return np.where(jobs > 0, self.total_O / np.where(jobs > 0, jobs, 1.0),
                        1.0)

    def occupancy(self, n_max: int) -> np.ndarray:
        return _occupancy_batch(self.num_waves, self.waves_per_tile,
                                self.pipeline_depth, n_max)

    def true_n(self, n_max: int) -> np.ndarray:
        return _true_n_batch(self.num_waves, self.waves_per_tile,
                             self.pipeline_depth, n_max)


def collect_basic_counters(
    trace: WaveTrace,
    *,
    num_cores: int,
    T_cycles_per_core: Optional[np.ndarray] = None,
    params: Optional[timing.ScatterUnitParams] = None,
) -> list[BasicCounters]:
    """Aggregate a wave trace into per-core paper-Table-1 counters.

    ``T_cycles_per_core`` is filled in by the kernel-time model (it
    includes non-scatter work and overheads); when omitted it defaults to
    the scatter busy time itself (utilization 1.0), which is only useful
    for unit tests.
    """
    if params is None:
        params = timing.V5E_SCATTER
    out: list[BasicCounters] = []
    occupancy = trace.occupancy(params.n_max)
    n_true = trace.true_n(params.n_max)
    for core in range(num_cores):
        sel = trace.core == core
        deg = trace.degree[sel]
        cls = trace.job_class[sel]
        o_count = float(np.sum(deg))  # transactions, incl. conflict replays
        n_f = float(np.sum(cls == timing.FAO))
        n_c = float(np.sum(cls == timing.CAS))
        n_p = float(np.sum(cls == timing.POPC))
        if T_cycles_per_core is not None:
            t = float(T_cycles_per_core[core])
        else:
            t = float(timing.total_time_cycles(
                n_f + n_c + n_p, max(1.0, o_count / max(deg.size, 1)),
                n_c, n_p, params))
        out.append(BasicCounters(
            O=o_count, N_f=n_f, N_c=n_c, N_p=n_p,
            T_cycles=t, occupancy=occupancy, n_true=n_true, core_id=core))
    return out
