"""Per-bin contention attribution from a committed index stream.

The paper's verdict ("the shared-memory atomic unit is the bottleneck")
is a scalar; this module answers *which bins* carry the contention and
*when*.  From the same committed index stream the trace provider feeds
``trace_from_indices`` it computes, fully columnar:

* per-bin **hits** — committed updates per destination bin
  (``np.bincount`` over the stream; sums to the stream length);
* per-bin **replays** — serialized commits: hits minus the number of
  distinct commit groups the bin appears in, i.e. every committed
  update beyond the first to a bin inside one commit group had to
  replay behind it.  This is the measure that separates §5's ``hist``
  from ``hist2``: identical per-bin hit totals, but the per-lane
  channel rotation spreads each commit group over more distinct bins,
  so the hottest bin's replay share drops strictly;
* per-bin **max wave degree** — the worst serialization degree of any
  wave that touches the bin;
* the per-wave **contention series** — degree over wave time, taken
  verbatim from the same ``WaveTrace`` the provider aggregates, so
  "the skew peaks in waves 40-60" reads straight off the array.

Bit-consistency: ``Heatmap.counters`` is built from the identical
stream via the identical ``trace_from_indices`` /
``CounterSet.from_trace`` calls ``TraceProvider.collect`` makes, so it
is bitwise-equal to what ``Session.profile`` reports for the same spec
(asserted by ``tests/test_torch_obs.py``), and ``hits.sum()`` equals the
committed stream length exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import counters as counters_mod
from repro_torch.core.counters import COMMIT_GROUP, LANES, CounterSet

__all__ = ["Heatmap", "heatmap_from_stream", "heatmap_for_spec",
           "DEFAULT_HOT_DEGREE"]

#: a bin is "hot" when some wave touching it serialized at least this much
DEFAULT_HOT_DEGREE = 2.0


@dataclasses.dataclass(frozen=True)
class Heatmap:
    """Per-bin/per-wave contention attribution for one workload point."""

    label: str
    num_slots: int              # addressable destination bins (max id + 1)
    bins: np.ndarray            # (K,) touched bin ids, ascending
    hits: np.ndarray            # (K,) committed updates per bin
    replays: np.ndarray         # (K,) serialized replays per bin
    max_wave_degree: np.ndarray  # (K,) worst degree of any wave hitting bin
    wave_degree: np.ndarray     # (W,) contention series over wave time
    counters: CounterSet        # bitwise-equal to TraceProvider.collect
    hot_degree: float = DEFAULT_HOT_DEGREE
    lanes: int = LANES
    commit_group: int = COMMIT_GROUP
    meta: dict = dataclasses.field(default_factory=dict)

    # -- derived ----------------------------------------------------------

    @property
    def total_hits(self) -> int:
        """Committed stream length; equals ``int(hits.sum())`` exactly."""
        return int(self.hits.sum()) if self.hits.size else 0

    @property
    def num_waves(self) -> int:
        return int(self.wave_degree.shape[0])

    @property
    def hot_mask(self) -> np.ndarray:
        """Bins that ever serialized: wave degree over threshold + replays."""
        return (self.max_wave_degree >= self.hot_degree) & (self.replays > 0)

    @property
    def hot_bins(self) -> np.ndarray:
        return self.bins[self.hot_mask]

    @property
    def top_bin(self) -> Optional[int]:
        """Bin carrying the most serialized replays (lowest id on ties)."""
        if not self.bins.size or not self.replays.any():
            return None
        return int(self.bins[int(np.argmax(self.replays))])

    @property
    def top_bin_share(self) -> float:
        """Fraction of ALL committed updates that are replays behind the
        single hottest bin — the §5 localization metric (hist > hist2)."""
        total = self.total_hits
        if not total or not self.replays.size:
            return 0.0
        return float(self.replays.max()) / float(total)

    @property
    def peak_wave(self) -> Optional[int]:
        return int(np.argmax(self.wave_degree)) if self.num_waves else None

    @property
    def peak_degree(self) -> float:
        return float(self.wave_degree.max()) if self.num_waves else 0.0

    def top(self, k: int = 16) -> np.ndarray:
        """Indices into the bin arrays of the k highest-replay bins."""
        if not self.bins.size:
            return np.empty(0, np.intp)
        order = np.lexsort((self.bins, -self.hits, -self.replays))
        return order[:max(int(k), 0)]

    def render(self, fmt: str = "text", top_k: int = 16) -> str:
        from repro_torch.obs import report  # lazy: keep dataclass import-light
        return report.render(self, fmt, top_k=top_k)


def heatmap_from_stream(stream, *, label: str = "",
                        num_cores: int = 1,
                        job_class: Optional[int] = None,
                        waves_per_tile: int = 1,
                        pipeline_depth: int = 2,
                        bytes_read: float = 0.0,
                        flops: float = 0.0,
                        overhead_cycles: float = 500.0,
                        hot_degree: float = DEFAULT_HOT_DEGREE,
                        source: str = "trace",
                        meta: Optional[dict] = None) -> Heatmap:
    """Attribution from a raw committed index stream.

    Mirrors ``TraceProvider``: the trace comes from the exact
    ``trace_from_indices`` call the provider makes, so the embedded
    ``CounterSet`` and the ``wave_degree`` series are bit-identical to
    the profile path for the same stream and geometry.
    """
    stream = np.asarray(stream).reshape(-1)
    if stream.size and stream.min() < 0:
        raise ValueError("committed index stream has negative bin ids")
    if job_class is None:
        from repro_torch.core import timing
        job_class = timing.FAO
    tr = counters_mod.trace_from_indices(
        stream, int(stream.max()) + 1 if stream.size else 1,
        num_cores=num_cores, job_class=job_class,
        waves_per_tile=waves_per_tile, pipeline_depth=pipeline_depth)
    cset = CounterSet.from_trace(
        tr, label=label, num_cores=num_cores, bytes_read=bytes_read,
        flops=flops, overhead_cycles=overhead_cycles, source=source)

    num_slots = int(stream.max()) + 1 if stream.size else 0
    if stream.size:
        idx = stream.astype(np.int64, copy=False)
        counts = np.bincount(idx, minlength=num_slots)
        bins = np.flatnonzero(counts)
        hits = counts[bins]
        # distinct (commit group, bin) pairs: every hit beyond the first
        # in its group is a serialized replay behind that bin
        group_id = np.arange(idx.size, dtype=np.int64) // COMMIT_GROUP
        uniq = np.unique(group_id * num_slots + idx)
        distinct = np.bincount(uniq % num_slots, minlength=num_slots)[bins]
        replays = hits - distinct
        # worst wave degree per bin: segment-max of each element's wave
        # degree, grouped by bin via one sort (columnar, no python loop)
        wave_id = np.minimum(np.arange(idx.size, dtype=np.int64) // LANES,
                             tr.num_waves - 1)
        elem_degree = tr.degree[wave_id]
        order = np.argsort(idx, kind="stable")
        starts = np.flatnonzero(np.diff(idx[order], prepend=-1))
        max_deg = np.maximum.reduceat(elem_degree[order], starts)
    else:
        bins = np.empty(0, np.int64)
        hits = np.empty(0, np.int64)
        replays = np.empty(0, np.int64)
        max_deg = np.empty(0, np.float64)

    return Heatmap(label=label, num_slots=num_slots, bins=bins,
                   hits=hits, replays=replays, max_wave_degree=max_deg,
                   wave_degree=np.asarray(tr.degree, np.float64),
                   counters=cset, hot_degree=float(hot_degree),
                   meta=dict(meta or {}))


def heatmap_for_spec(spec, *, hot_degree: float = DEFAULT_HOT_DEGREE) -> Heatmap:
    """Attribution for a workload spec (kernel or indices source).

    Uses ``TraceProvider.committed_stream`` so the stream, geometry, and
    counter aggregation match ``Session.profile`` on the same spec bit
    for bit.  Pre-recorded ``trace``/``run``/``hlo`` sources carry no
    index stream to attribute and raise ``ValueError``.
    """
    # lazy: the analysis layer sits above this one
    from repro_torch.analysis.providers.trace import TraceProvider
    prov = TraceProvider()
    stream, job_class, wpt = prov.committed_stream(spec)
    meta = {}
    if spec.kernel is not None:
        meta = {"op": spec.kernel.op,
                "variant": spec.kernel.params.get("variant")}
    return heatmap_from_stream(
        stream, label=spec.label, num_cores=spec.num_cores,
        job_class=job_class, waves_per_tile=wpt,
        pipeline_depth=spec.pipeline_depth or 2,
        bytes_read=spec.bytes_read, flops=spec.flops,
        overhead_cycles=spec.overhead_cycles, hot_degree=hot_degree,
        source=prov.name, meta=meta)
