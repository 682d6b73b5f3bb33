"""Declarative workload-transform catalog for the optimization advisor.

Each ``Transform`` rewrites a ``WorkloadSpec`` into a semantically
equivalent launch with different contention/occupancy characteristics —
*without touching any kernel code*.  The catalog covers the
contention-reducing families Schweizer et al. measure as having large,
predictable effects, mapped onto this repo's workload sources:

    rotation      per-lane channel rotation (the paper-§5 ``hist2``
                  trick: commit-group lanes hit different bins) — for
                  histogram kernel specs
    replication   bin privatization: each destination splits into R
                  replicas picked round-robin by stream position, at the
                  cost of R× scratch and a final cross-replica reduce —
                  for raw index streams
    substitution  CAS-class read-modify-verify loops replaced by
                  FAO-class accumulate (job-class substitution)
    geometry      launch-shape changes (``waves_per_tile`` /
                  ``pipeline_depth``) that move the occupancy estimate
                  the queue model runs at
    remap         strided interleave of the index stream so clustered
                  duplicates spread across commit groups

A transform is three judgements plus bookkeeping: ``legal(spec)`` (can
this rewrite apply, judged from the spec alone), ``apply(spec)`` (the
rewritten, relabeled spec), and ``cost(spec)`` (what the rewrite spends:
extra scratch bytes, extra reduce work).  ``apply`` never mutates —
specs are frozen, so every rewrite derives via ``with_``.

A deliberate omission: FAO→POPC substitution (dropping the atomic's
result read) predicts the largest speedups of all, but its legality —
"no later instruction reads the accumulated value" — is a property of
the surrounding program, not of the ``WorkloadSpec``, so the default
catalog does not offer it.  Register a custom transform if your kernel
qualifies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis.workload import KernelSource, WorkloadSpec
from repro_torch.core import timing
from repro_torch.core.counters import COMMIT_GROUP


@dataclasses.dataclass(frozen=True)
class TransformCost:
    """What a rewrite spends to buy its contention reduction."""

    scratch_bytes: float = 0.0     # extra shared-memory scratch (bin replicas)
    reduce_flops: float = 0.0      # extra post-pass reduction work
    note: str = ""                 # human-readable caveat

    @staticmethod
    def merge(costs: Sequence["TransformCost"]) -> "TransformCost":
        notes = [c.note for c in costs if c.note]
        return TransformCost(
            scratch_bytes=float(sum(c.scratch_bytes for c in costs)),
            reduce_flops=float(sum(c.reduce_flops for c in costs)),
            note="; ".join(notes))


class Transform:
    """One declarative spec rewrite (see module docstring).

    Subclasses set ``name`` (unique within a catalog; shows up in
    candidate labels) and ``family`` (the search composes at most one
    transform per family), and implement ``legal``/``apply``; ``cost``
    and ``params`` default to free/empty.
    """

    name: str = ""
    family: str = ""

    def legal(self, spec: WorkloadSpec) -> bool:
        raise NotImplementedError

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        raise NotImplementedError

    def cost(self, spec: WorkloadSpec) -> TransformCost:
        del spec
        return TransformCost()

    def params(self) -> dict:
        """The transform's own parameters (flat, report-friendly)."""
        return {}

    def _relabel(self, spec: WorkloadSpec) -> str:
        return f"{spec.label}+{self.name}"

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


class ChannelRotation(Transform):
    """The paper-§5 ``hist2`` rewrite: per-lane channel rotation.

    Lanes of one commit group read *different* channels, so a
    monochromatic tile's 32 identical bin updates become updates to (up
    to) ``channels`` distinct padded bins — the bin/channel-padding
    family.  Pure index arithmetic inside the kernel: no scratch, no
    extra reduce (the per-channel sub-histograms already exist).
    """

    name = "rotate-channels"
    family = "rotation"

    def legal(self, spec: WorkloadSpec) -> bool:
        return (spec.kernel is not None
                and spec.kernel.op == "histogram"
                and spec.kernel.params.get("variant") == "hist")

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        params = dict(spec.kernel.params, variant="hist2")
        return spec.with_(kernel=KernelSource(op="histogram", params=params),
                          label=self._relabel(spec))

    def cost(self, spec: WorkloadSpec) -> TransformCost:
        return TransformCost(
            note="per-lane channel rotation (hist2): index arithmetic only")


class Replicate(Transform):
    """Bin privatization: split each destination into ``factor`` replicas.

    Stream position picks the replica round-robin, so duplicates inside
    a commit group spread across ``factor`` distinct bins (e drops by up
    to ``factor``).  Costs ``factor``× the bin storage and a final
    reduce across replicas.
    """

    family = "replication"

    def __init__(self, factor: int) -> None:
        if factor < 2:
            raise ValueError(f"replication factor must be >= 2, got {factor}")
        self.factor = int(factor)
        self.name = f"replicate-x{self.factor}"

    def legal(self, spec: WorkloadSpec) -> bool:
        return spec.indices is not None

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        idx = np.asarray(spec.indices).reshape(-1)
        replica = np.arange(idx.size, dtype=idx.dtype) % self.factor
        return spec.with_(indices=idx * self.factor + replica,
                          num_bins=spec.num_bins * self.factor,
                          label=self._relabel(spec))

    def cost(self, spec: WorkloadSpec) -> TransformCost:
        return TransformCost(
            scratch_bytes=float(spec.num_bins * (self.factor - 1) * 4),
            reduce_flops=float(spec.num_bins * self.factor),
            note=f"{self.factor} bin replicas need a final cross-replica "
                 f"reduce")

    def params(self) -> dict:
        return {"factor": self.factor}


class CasToFao(Transform):
    """Job-class substitution: CAS-class retry loops become FAO jobs.

    Schweizer et al.'s op substitution: a read-modify-verify loop (f32
    accumulate lowered to compare-and-swap) replaced by a plain
    fetch-and-op, legal when the accumulation can be reassociated or
    carried in fixed point.  Applies to raw index streams tagged CAS, to
    scatter-add kernel launches with a CAS job class, and to *weighted*
    histograms (whose f32 weight accumulation is the CAS case).
    """

    name = "cas-to-fao"
    family = "substitution"

    def legal(self, spec: WorkloadSpec) -> bool:
        if spec.indices is not None:
            return spec.job_class == timing.CAS
        if spec.kernel is not None:
            if spec.kernel.op == "scatter_add":
                return spec.kernel.params.get("job_class") == timing.CAS
            if spec.kernel.op == "histogram":
                return bool(spec.kernel.params.get("weighted"))
        return False

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        label = self._relabel(spec)
        if spec.indices is not None:
            return spec.with_(job_class=timing.FAO, label=label)
        if spec.kernel.op == "scatter_add":
            params = dict(spec.kernel.params, job_class=timing.FAO)
            return spec.with_(
                kernel=KernelSource(op="scatter_add", params=params),
                label=label)
        params = dict(spec.kernel.params, weighted=False, force_fao=True)
        return spec.with_(kernel=KernelSource(op="histogram", params=params),
                          label=label)

    def cost(self, spec: WorkloadSpec) -> TransformCost:
        return TransformCost(
            note="needs a reassociable / fixed-point accumulation in place "
                 "of the CAS retry loop")


def _effective_waves_per_tile(spec: WorkloadSpec) -> Optional[int]:
    """What the acquisition path will resolve an unset geometry to.

    Mirrors the providers' defaulting per source family; ``None`` means
    "not resolvable from the spec" (opaque ``run`` callables).
    """
    if spec.waves_per_tile is not None:
        return spec.waves_per_tile
    if spec.trace is not None:
        return spec.trace.waves_per_tile
    if spec.kernel is not None:
        if spec.kernel.op == "histogram":
            from repro_torch.kernels.histogram import ops as hist_ops
            return hist_ops.default_waves_per_tile(
                spec.kernel.params["img"])
        if spec.kernel.op == "scatter_add":
            from repro_torch.kernels.scatter_add import ops as scat_ops
            return scat_ops.default_waves_per_tile()
    if spec.indices is not None:
        return 1     # trace_from_indices' ``waves_per_tile or 1``
    return None


class SetWavesPerTile(Transform):
    """Launch-geometry rewrite: ``waves_per_tile`` waves per tile."""

    family = "geometry"

    def __init__(self, waves_per_tile: int) -> None:
        self.waves_per_tile = int(waves_per_tile)
        self.name = f"wpt={self.waves_per_tile}"

    def legal(self, spec: WorkloadSpec) -> bool:
        # compare the *effective* value (like SetPipelineDepth): an unset
        # field resolves to a source-family default at collection time,
        # and re-stating that default would enumerate a no-op candidate
        # whose fingerprint (None vs N) even defeats dedup
        if spec.hlo_text is not None:
            return False
        return _effective_waves_per_tile(spec) != self.waves_per_tile

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        return spec.with_(waves_per_tile=self.waves_per_tile,
                          label=self._relabel(spec))

    def params(self) -> dict:
        return {"waves_per_tile": self.waves_per_tile}


class SetPipelineDepth(Transform):
    """Launch-geometry rewrite: change the double-buffering depth."""

    family = "geometry"

    def __init__(self, pipeline_depth: int) -> None:
        self.pipeline_depth = int(pipeline_depth)
        self.name = f"depth={self.pipeline_depth}"

    def legal(self, spec: WorkloadSpec) -> bool:
        # every acquisition path resolves an unset depth to 2
        # (``pipeline_depth or 2``), so compare the *effective* value —
        # "set depth to 2" on a default spec is a no-op, not a candidate
        return (spec.hlo_text is None
                and (spec.pipeline_depth or 2) != self.pipeline_depth)

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        return spec.with_(pipeline_depth=self.pipeline_depth,
                          label=self._relabel(spec))

    def params(self) -> dict:
        return {"pipeline_depth": self.pipeline_depth}


class LaneInterleave(Transform):
    """Strided remap of the index stream across commit groups.

    Run-clustered duplicates (sorted or tiled streams) land in one
    commit group and serialize; reading the stream with a stride of
    ``size / COMMIT_GROUP`` interleaves distant elements into each
    group.  A pure gather — no scratch, no reduce — but the gather pass
    itself is the (stream-sized) cost.
    """

    name = "interleave-lanes"
    family = "remap"

    def legal(self, spec: WorkloadSpec) -> bool:
        if spec.indices is None:
            return False
        return np.asarray(spec.indices).size >= 2 * COMMIT_GROUP

    def apply(self, spec: WorkloadSpec) -> WorkloadSpec:
        idx = np.asarray(spec.indices).reshape(-1)
        n = (idx.size // COMMIT_GROUP) * COMMIT_GROUP
        head = idx[:n].reshape(COMMIT_GROUP, -1).T.reshape(-1)
        return spec.with_(indices=np.concatenate([head, idx[n:]]),
                          label=self._relabel(spec))

    def cost(self, spec: WorkloadSpec) -> TransformCost:
        return TransformCost(
            note="adds a strided gather pass over the index stream")


def default_catalog(
    *,
    waves_per_tile: Sequence[int] = (4, 8, 16, 32, 64),
    pipeline_depths: Sequence[int] = (2, 4),
    replication_factors: Sequence[int] = (2, 4, 8),
) -> list[Transform]:
    """The shipped catalog: every family, parameterized axes expanded.

    The cartesian half of "cartesian + beam": parameterized transforms
    (replication factor, geometry values) enter the catalog once per
    parameter value, so a search frontier enumerates the full parameter
    grid while the beam composes across *families*.  Illegal entries
    cost nothing — ``legal`` prunes them per spec at enumeration time.
    """
    catalog: list[Transform] = [ChannelRotation(), CasToFao(),
                                LaneInterleave()]
    catalog.extend(Replicate(f) for f in replication_factors)
    catalog.extend(SetWavesPerTile(w) for w in waves_per_tile)
    catalog.extend(SetPipelineDepth(d) for d in pipeline_depths)
    return catalog
