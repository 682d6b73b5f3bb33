"""Declarative rule catalog rating scanned atomic sites with the model.

Each rule matches a class of :class:`~repro_torch.audit.scanner.AtomicSite`,
derives a candidate :class:`~repro_torch.analysis.workload.WorkloadSpec` (the
provenance record a user can re-profile or hand to the advisor), and
synthesizes a deterministic worst-plausible index stream for the site's
access pattern.  ``evaluate`` turns the synthesized streams into
``CounterSet``s directly (``trace_from_indices`` — pure numpy, NO
provider collection, NO kernel execution) and scores every finding in
one columnar ``Session.profile_sets`` pass, so each diagnostic carries
the model-predicted utilization and the bottleneck verdict's advisor
transform as its fix-it hint.

Severity model: every hazard stream is synthesized at one fixed
steady-state length and profiled next to a shared conflict-free
baseline stream of the same length/core count.  The *contention ratio*
— hazard scatter-unit utilization over baseline — isolates the cost of
the access pattern from launch size: ratios >= ~1.35 mean the modeled
atomic unit spends a third more cycles than conflict-free traffic
(``error``), >= ~1.10 a measurable excess (``warning``), anything less
reports as a ``note``.  Each rule caps how high its findings may
escalate (``max_severity``): bank-stride and geometry rules are
advisory and never gate a build on their own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis.workload import WorkloadSpec
from repro_torch.audit.scanner import AtomicSite, ScanResult
from repro_torch.core import bottleneck, timing
from repro_torch.core import counters as counters_mod

SEVERITIES = ("note", "warning", "error")

# Every synthesized stream uses one fixed steady-state length: long
# enough that per-launch overhead is amortized and degree statistics
# dominate, and identical to the baseline stream so the contention
# ratio compares like with like.  Real site sizes (trip_count x
# num_updates) only gate *whether* a rule fires, never the score.
STREAM_LEN = 1 << 17

# contention-ratio thresholds (hazard U / conflict-free baseline U)
ERROR_RATIO = 1.35
WARN_RATIO = 1.10
# Destinations at or under this bin count guarantee intra-commit-group
# duplicates even under a perfectly balanced router (pigeonhole on the
# 32-lane commit group).
HOT_BIN_MAX = counters_mod.COMMIT_GROUP // 2

# verdict hint family -> shipped advisor transform (fix-it hint text).
FAMILY_TRANSFORMS = {
    "rotation": "ChannelRotation",
    "replication": "Replicate",
    "substitution": "CasToFao",
    "geometry": "SetWavesPerTile/SetPipelineDepth",
    "remap": "LaneInterleave",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One (rule, site) diagnostic with its model-predicted severity."""

    rule_id: str
    rule_slug: str
    severity: str                       # note | warning | error
    message: str
    label: str                          # spec label (config/step/site)
    site: Optional[AtomicSite] = None   # None for module-level findings
    utilization: Optional[float] = None  # predicted scatter-unit U
    bottleneck: str = ""
    hint: str = ""                      # compact action:family@unit
    fixit: str = ""                     # advisor transform suggestion
    suppressed: bool = False
    hlo_uri: str = ""                   # artifact the hlo_line refers to
    hlo_line: int = 0
    spec: Optional[WorkloadSpec] = None  # candidate workload (provenance)
    baseline_utilization: Optional[float] = None
    contention: Optional[float] = None  # utilization / baseline ratio
    advice: Optional[dict] = None       # attach_advice: top-ranked transform

    def gate_rank(self) -> int:
        return SEVERITIES.index(self.severity)


def _uniform_stream(site: AtomicSite, n: int) -> np.ndarray:
    # deterministic uniform draw seeded by the site geometry, so audits
    # are reproducible run to run
    rng = np.random.default_rng(abs(hash((site.num_bins, site.num_updates,
                                          site.row_elems))) % (2 ** 32))
    return rng.integers(0, max(1, site.num_bins), size=n).astype(np.int64)


class Rule:
    """Base rule: subclasses set ids and override matches/synthesize."""

    id = "RULE000"
    slug = "base"
    base_severity = "warning"
    max_severity = "error"   # ceiling the contention ratio may escalate to
    summary = ""
    description = ""
    job_class = timing.FAO

    def matches(self, site: AtomicSite) -> bool:
        raise NotImplementedError

    def synthesize(self, site: AtomicSite) -> np.ndarray:
        """Worst-plausible index stream for this hazard class."""
        return _uniform_stream(site, STREAM_LEN)

    def spec(self, site: AtomicSite, label: str,
             indices: Optional[np.ndarray] = None) -> WorkloadSpec:
        """Candidate WorkloadSpec a user can re-profile / hand to advise."""
        idx = self.synthesize(site) if indices is None else indices
        values = np.ones(idx.shape, dtype=np.float32)
        return WorkloadSpec.from_scatter_add(
            idx, values, max(2, site.num_bins), label=label,
            job_class=self.job_class)


class SameAddressHotBin(Rule):
    id = "ATOM001"
    slug = "same-address-hot-bin"
    base_severity = "warning"
    summary = "scatter destination has so few bins that every commit group serializes"
    description = (
        "The scatter writes into a destination with <= "
        f"{HOT_BIN_MAX} addressable bins (e.g. a per-expert counter for a "
        "small expert pool). By pigeonhole, every 32-lane commit group "
        "carries duplicate addresses even under a perfectly balanced "
        "router, so the atomic unit serializes each group; the modeled "
        "degree floor is ceil(32 / bins).")

    def matches(self, site: AtomicSite) -> bool:
        return (site.kind in ("histogram_scatter", "one_hot_histogram")
                and not site.unique_indices
                and site.num_bins <= HOT_BIN_MAX)

    def synthesize(self, site: AtomicSite) -> np.ndarray:
        # perfectly balanced round-robin: the FLOOR of the hazard — real
        # routers are more skewed, never less.
        return np.arange(STREAM_LEN, dtype=np.int64) % max(1, site.num_bins)


class CasRetryLoop(Rule):
    id = "ATOM002"
    slug = "cas-retry-loop"
    base_severity = "warning"
    summary = "scatter combiner needs compare-and-swap retries, not fetch-and-op"
    description = (
        "The scatter's combiner region is not a plain accumulate "
        "(add/min/max), so the lowering must use a read-modify-verify "
        "(CAS) loop; colliding lanes retry instead of queueing one "
        "atomic op each, amplifying contention. The CasToFao transform "
        "(or an order-insensitive combiner) removes the retry loop.")
    job_class = timing.CAS

    def matches(self, site: AtomicSite) -> bool:
        return (site.opcode in ("scatter", "select-and-scatter")
                and site.combiner == "cas" and not site.unique_indices)


class UnreplicatedHistogram(Rule):
    id = "ATOM003"
    slug = "unreplicated-histogram"
    base_severity = "warning"
    max_severity = "warning"   # replication advice is advisory
    summary = "many-bin histogram accumulates into one shared destination"
    description = (
        "A scalar-update accumulate scatter (histogram / expert-count / "
        "segment-sum) lands every lane's traffic on a single shared "
        "buffer. Uniform traffic still collides inside commit groups; "
        "skewed traffic serializes. Replicate the destination per core "
        "(Replicate transform) and reduce at the end.")

    def matches(self, site: AtomicSite) -> bool:
        return (site.kind in ("histogram_scatter", "one_hot_histogram")
                and not site.unique_indices
                and site.num_bins > HOT_BIN_MAX)


class StrideConflict(Rule):
    id = "BANK001"
    slug = "stride-conflict"
    base_severity = "warning"
    max_severity = "warning"   # banks are modeled, not measured: advisory
    summary = "row-granular writes stride commit-group-aligned banks"
    description = (
        "Row updates whose width is a multiple of the 32-lane commit "
        "group map successive rows onto the same bank offsets (MoE token "
        "dispatch rows, KV-cache lines). Colliding rows serialize at "
        "gcd(row_elems, 32) degree; the LaneInterleave remap (or padding "
        "the row) breaks the alignment.")

    def matches(self, site: AtomicSite) -> bool:
        return (site.kind in ("dispatch_scatter", "kv_cache_write")
                and not site.unique_indices
                and site.row_elems >= counters_mod.COMMIT_GROUP
                and site.row_elems % counters_mod.COMMIT_GROUP == 0)

    def synthesize(self, site: AtomicSite) -> np.ndarray:
        # conflict degree of commit-group-aligned rows
        d = math.gcd(site.row_elems, counters_mod.COMMIT_GROUP)
        return np.arange(STREAM_LEN, dtype=np.int64) // max(1, d)


class WavesExceedPipeline(Rule):
    id = "GEOM001"
    slug = "waves-exceed-pipeline"
    base_severity = "note"
    max_severity = "note"      # pure geometry: informational only
    summary = "launch enqueues far more waves than the pipeline can hold"
    description = (
        "The site's update stream spans orders of magnitude more waves "
        "than waves_per_tile x pipeline_depth can keep in flight, so "
        "issue overhead and drain bubbles dominate even without "
        "contention. Raise waves_per_tile / pipeline_depth "
        "(SetWavesPerTile / SetPipelineDepth).")

    # capacity of the default launch geometry across 8 cores
    _CAPACITY = 8 * 8 * 2 * 16

    def matches(self, site: AtomicSite) -> bool:
        if site.kind not in ("dispatch_scatter", "histogram_scatter",
                             "scatter", "sort_segment"):
            return False
        lanes = max(1, counters_mod.LANES // max(1, min(site.row_elems,
                                                        counters_mod.LANES)))
        waves = math.ceil(site.num_updates * max(1, site.trip_count) / lanes)
        return waves > self._CAPACITY

    def synthesize(self, site: AtomicSite) -> np.ndarray:
        # conflict-free stream: isolates the geometry (occupancy) effect
        return np.arange(STREAM_LEN, dtype=np.int64) % max(2, site.num_bins)

    def spec(self, site: AtomicSite, label: str,
             indices: Optional[np.ndarray] = None) -> WorkloadSpec:
        idx = self.synthesize(site) if indices is None else indices
        return WorkloadSpec.from_indices(
            idx, max(2, site.num_bins), label=label,
            job_class=self.job_class, waves_per_tile=1, pipeline_depth=2)


# AUDIT000 is module-level (no site match); emitted directly by evaluate().
AUDIT000 = ("AUDIT000", "unresolved-trip-count")

CATALOG: tuple[Rule, ...] = (
    SameAddressHotBin(), CasRetryLoop(), UnreplicatedHistogram(),
    StrideConflict(), WavesExceedPipeline(),
)


def rule_by_id(rule_id: str) -> Optional[Rule]:
    for r in CATALOG:
        if r.id == rule_id:
            return r
    return None


def _finding_severity(rule: Rule, contention: float) -> str:
    if contention >= ERROR_RATIO:
        sev = "error"
    elif contention >= WARN_RATIO:
        sev = "warning"
    else:
        sev = "note"
    # cap at the rule's ceiling (advisory rules never gate on their own)
    cap = SEVERITIES.index(rule.max_severity)
    return SEVERITIES[min(SEVERITIES.index(sev), cap)]


def _fixit(verdict) -> str:
    if verdict.hint is None:
        return ""
    transform = FAMILY_TRANSFORMS.get(verdict.hint.family,
                                      verdict.hint.family)
    return (f"{verdict.hint.action} on {verdict.hint.unit} via advisor "
            f"transform {transform}")


def evaluate(scan: ScanResult, session, *, label: str = "module",
             rules: Sequence[Rule] = CATALOG,
             suppress: Sequence[str] = (),
             hlo_uri: str = "", num_cores: int = 8) -> list[Finding]:
    """Match rules against a scan and score all candidates in one pass.

    Builds every candidate's CounterSet from its synthesized stream
    (pure numpy) and evaluates them in a single columnar
    ``session.profile_sets`` call — the session's trace/kernel providers
    are never invoked (``session.stats`` stays untouched).
    """
    suppress = set(suppress)
    candidates: list[tuple[Rule, AtomicSite]] = []
    for site in scan.sites:
        for rule in rules:
            if rule.matches(site):
                candidates.append((rule, site))

    # every candidate's stream (plus the shared baseline) goes through
    # one batched trace synthesis — the whole audit's wave degrees are a
    # few large numpy ops instead of one trace_from_indices per finding
    streams, classes, labels, specs = [], [], [], []
    for rule, site in candidates:
        idx = rule.synthesize(site)
        point_label = f"{label}/{site.op_name}"
        specs.append(rule.spec(site, point_label, indices=idx))
        streams.append(idx)
        classes.append(rule.job_class)
        labels.append(point_label)
    csets = []
    if streams:
        # shared conflict-free baseline: unique addresses, same length,
        # same core count — the denominator of every contention ratio
        streams.append(np.arange(STREAM_LEN, dtype=np.int64))
        classes.append(counters_mod.timing.FAO)
        labels.append(f"{label}/__baseline__")
        traces = counters_mod.traces_from_index_batch(
            streams, num_cores=num_cores, job_class=classes)
        csets = [counters_mod.CounterSet.from_trace(
            tr, label=lab, num_cores=num_cores,
            bytes_read=float(stream.size * 4), source="audit")
            for tr, lab, stream in zip(traces, labels, streams)]
    profiles = session.profile_sets(csets) if csets else []
    u_base = float(profiles[-1].scatter_utilization) if profiles else 1.0
    u_base = max(u_base, 1e-9)

    findings: list[Finding] = []
    for (rule, site), spec, prof in zip(candidates, specs, profiles):
        verdict = bottleneck.classify(prof)
        u = float(prof.scatter_utilization)
        contention = u / u_base
        severity = _finding_severity(rule, contention)
        msg = (f"{rule.summary}: {site.describe()}; predicted scatter "
               f"U={u:.0%}, {contention:.2f}x conflict-free baseline "
               f"({verdict.bottleneck}"
               f"{' saturated' if verdict.saturated else ''})")
        findings.append(Finding(
            rule_id=rule.id, rule_slug=rule.slug, severity=severity,
            message=msg, label=f"{label}/{site.op_name}", site=site,
            utilization=u, bottleneck=verdict.bottleneck,
            hint=verdict.hint.compact() if verdict.hint else "",
            fixit=_fixit(verdict), suppressed=rule.id in suppress,
            hlo_uri=hlo_uri, hlo_line=site.hlo_line, spec=spec,
            baseline_utilization=u_base, contention=contention))

    if scan.unresolved_loops:
        rid, slug = AUDIT000
        findings.append(Finding(
            rule_id=rid, rule_slug=slug, severity="note",
            message=(f"{scan.unresolved_loops} while loop(s) with "
                     "unresolved trip counts — per-site traffic estimates "
                     "are lower bounds"),
            label=label, suppressed=rid in suppress, hlo_uri=hlo_uri))

    order = {"error": 0, "warning": 1, "note": 2}
    findings.sort(key=lambda f: (order[f.severity],
                                 -(f.utilization or 0.0), f.label))
    return findings
