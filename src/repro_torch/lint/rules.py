"""KERN rule family: findings over the models of the port's CUDA kernels.

Counterpart of :mod:`repro_torch.audit.rules`, one layer deeper: where
the audit rules pattern-match a step's shapes and synthesize
*worst-plausible* streams, these rules run on
:class:`~repro_torch.lint.tracing.KernelModel`s whose index streams were
derived **exactly** — so KERN001's degree is a proof, not a guess, and
conflict-freedom is certified by absence:

    KERN001  affine-hot-bin          static degree above the reorder floor
    KERN002  bank-stride-conflict    commit-group-aligned row updates
    KERN003  unsynchronized-rmw-race accumulate into a shared block with
                                     no init guard on the sharing axis
    KERN004  cas-retry-loop          CAS-class combiner or swap-in-loop
    KERN005  data-dependent-index    needs dynamic audit (carries a
                                     WorkloadSpec for the sweep path)

Findings are the same :class:`~repro_torch.audit.rules.Finding` dataclass
the audit emits, scored through the same one-pass
``session.profile_sets`` columnar evaluation and rendered by the same
report/SARIF machinery — ``python -m repro_torch lint`` and ``... audit``
merge into one log.  KERN003 is a correctness finding (fixed ``error``);
KERN005 is informational (fixed ``note``) so ``--advise`` and
``--fail-on warning`` skip it.  The rule texts and messages are the
reference's, word for word.

Two rules read what the declaration says of the CUDA kernel: KERN002
fires only on an unpadded shared-memory accumulator (a row added at L2,
or into a copy padded a word each 32, has no bank stride), and KERN004
also fires where the accumulator's combine is a CAS loop on Hopper (a
shared ``atomicAdd(float)``), scored at the CAS class whatever the
workload's class.

Import-light by design (numpy only): the SARIF renderer pulls this
catalog in for rule descriptors; the analysis (and torch) load when a
target is evaluated.
"""

from __future__ import annotations

import dataclasses
import math
import os
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np

from repro_torch.audit import rules as audit_rules
from repro_torch.audit.rules import Finding
from repro_torch.core import bottleneck, timing
from repro_torch.core import counters as counters_mod


@dataclasses.dataclass(frozen=True)
class KernelSite:
    """Lint-side site record, row/report-compatible with ``AtomicSite``."""

    op_name: str
    kind: str                    # one_hot_popcount | one_hot_matmul | rmw
    num_bins: int
    num_updates: int             # total updates across the whole launch
    row_elems: int
    combiner: str                # add | cas | popc
    trip_count: int              # grid steps
    hlo_line: int = 0            # kernel source line (the CUDA function)
    classification: str = ""     # static | data-dependent | opaque

    def describe(self) -> str:
        return (f"{self.op_name} ({self.kind}, {self.classification}): "
                f"{self.num_updates} updates over {self.trip_count} grid "
                f"step(s) into {self.num_bins} bin(s), "
                f"row width {self.row_elems}")


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """Catalog metadata; matching logic lives in ``evaluate_target``."""

    id: str
    slug: str
    summary: str
    description: str
    base_severity: str = "warning"
    max_severity: str = "error"


KERN001 = KernelRule(
    id="KERN001", slug="affine-hot-bin",
    summary="statically proven commit-group serialization above the "
            "reorder-achievable floor",
    description=(
        "The kernel's scatter index stream is affine in grid/lane "
        "variables (or reads provably constant operands), so its exact "
        "per-wave serialization degree distribution was derived without "
        "running the kernel. The mean degree exceeds the floor a lane "
        "remap could achieve given each wave's distinct destinations — "
        "the paper's Listing-1 hazard: hist commits a solid tile at "
        "degree 32 where channel rotation (hist2) reaches the floor of "
        "8. The ChannelRotation transform family closes the gap."))

KERN002 = KernelRule(
    id="KERN002", slug="bank-stride-conflict",
    summary="row-granular scatter updates stride commit-group-aligned "
            "banks",
    description=(
        "A one-hot matmul scatter updates rows whose element width is a "
        "multiple of the 32-lane commit group, so successive rows land "
        "on the same bank offsets and colliding rows serialize at "
        "gcd(row_elems, 32) degree. Pad the row or apply the "
        "LaneInterleave remap."),
    base_severity="note", max_severity="warning")

KERN003 = KernelRule(
    id="KERN003", slug="unsynchronized-rmw-race",
    summary="read-modify-write accumulation into a block shared across "
            "a grid axis with no init guard on that axis",
    description=(
        "The kernel accumulates into an output ref whose block index "
        "map does not depend on some grid axis (the block is shared "
        "across that axis), but no `pl.when(pl.program_id(axis) == 0)` "
        "zero-initialization guards it. On any backend that may "
        "parallelize or reorder that axis this is a non-atomic RMW "
        "race; even sequentially the first step accumulates into "
        "uninitialized memory."),
    base_severity="error", max_severity="error")

KERN004 = KernelRule(
    id="KERN004", slug="cas-retry-loop",
    summary="scatter combiner is CAS-class: colliding lanes retry "
            "instead of queueing one atomic each",
    description=(
        "The accumulation is not a plain integer fetch-and-op (a "
        "weighted/float combiner, or a swap inside a retry loop), so "
        "the modeled scatter unit services it at CAS cost — each "
        "conflicting lane re-reads, recombines and re-verifies. The "
        "CasToFao transform (integer re-quantization or an "
        "order-insensitive combiner) removes the retry loop."))

KERN005 = KernelRule(
    id="KERN005", slug="data-dependent-index",
    summary="scatter index stream reads runtime data — needs dynamic "
            "audit",
    description=(
        "The site's index expression depends on non-constant operand "
        "values, so its degree distribution cannot be proved "
        "statically. The finding carries the probe WorkloadSpec; run "
        "it through the dynamic sweep path (`repro sweep` / "
        "`Session.profile`) to measure the contention this lint cannot "
        "derive."),
    base_severity="note", max_severity="note")

KERN_CATALOG: tuple[KernelRule, ...] = (
    KERN001, KERN002, KERN003, KERN004, KERN005)


def kern_rule_by_id(rule_id: str) -> Optional[KernelRule]:
    for r in KERN_CATALOG:
        if r.id == rule_id:
            return r
    return None


_COMBINER = {timing.FAO: "add", timing.CAS: "cas", timing.POPC: "popc"}


def _source_uri(model) -> str:
    path = model.source_file
    if not path:
        return ""
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def _default_geom(target):
    return SimpleNamespace(
        label=target.label, num_bins=256, num_cores=8, pipeline_depth=2,
        waves_per_tile=None, bytes_read=0.0, flops=0.0,
        overhead_cycles=500.0)


def _site_job(target, site) -> int:
    """The job class a site is scored at: the workload's, or CAS where the
    declared combine is a CAS loop."""
    if site.combine == "cas":
        return timing.CAS
    return target.job_class if target.job_class is not None else timing.FAO


def _site_record(target, model, site, deriv) -> KernelSite:
    trip = int(np.prod(model.grid)) if model.grid else 1
    return KernelSite(
        op_name=model.name, kind=site.kind,
        num_bins=site.num_bins,
        num_updates=site.stream_len * trip,
        row_elems=site.row_elems,
        combiner=_COMBINER.get(_site_job(target, site), "add"),
        trip_count=trip, hlo_line=model.source_line,
        classification=deriv.classification)


def evaluate_target(target, session, *, models=None,
                    suppress: Sequence[str] = (),
                    num_cores: Optional[int] = None) -> list[Finding]:
    """Run the KERN catalog over one lint target's kernel models.

    All static findings are scored in a single columnar
    ``session.profile_sets`` pass against per-site conflict-free
    baselines of identical length, geometry and (for KERN001) job
    class — the contention ratio then reuses the audit's severity
    thresholds.  No kernel launches, no provider collections.
    """
    from repro_torch.lint import analysis as lan

    if models is None:
        models = lan.analyze_target(target)
    suppress = set(suppress)
    spec = target.spec or _default_geom(target)
    cores = num_cores or getattr(spec, "num_cores", 8)
    wpt = target.waves_per_tile or 1
    pd = spec.pipeline_depth or 2

    # (rule, model, site-record, deriv, extra) scored candidates collect
    # csets in pairs (site, baseline); unscored findings are emitted raw
    scored: list[dict] = []
    findings: list[Finding] = []
    csets: list = []

    def _emit(rule, model, ksite, message, *, severity=None, spec_=None,
              hint="", fixit=""):
        findings.append(Finding(
            rule_id=rule.id, rule_slug=rule.slug,
            severity=severity or rule.base_severity, message=message,
            label=f"{target.label}/{ksite.op_name}", site=ksite,
            hint=hint, fixit=fixit, suppressed=rule.id in suppress,
            hlo_uri=_source_uri(model), hlo_line=ksite.hlo_line,
            spec=spec_))

    # baselines are plain index streams, so their trace synthesis is
    # deferred and batched (one traces_from_index_batch call for the
    # whole target) — the site traces themselves come from the symbolic
    # derivation, which is already a few vectorized ops per site
    baseline_streams: list = []
    baseline_jobs: list = []

    def _queue_scored(rule, model, ksite, deriv, *, site_job, base_job,
                      message_fn):
        trace = lan._trace_from_derivation(
            deriv, spec, job_class=site_job, waves_per_tile=wpt)
        n = deriv.stream.shape[0]
        common = dict(num_cores=cores, bytes_read=spec.bytes_read,
                      flops=spec.flops,
                      overhead_cycles=spec.overhead_cycles, source="lint")
        csets.append(counters_mod.CounterSet.from_trace(
            trace, label=f"{target.label}/{ksite.op_name}", **common))
        csets.append(None)  # baseline slot, filled by the batch below
        baseline_streams.append(np.arange(n, dtype=np.int64))
        baseline_jobs.append(base_job)
        scored.append(dict(rule=rule, model=model, ksite=ksite,
                           deriv=deriv, message_fn=message_fn,
                           common=common))

    for model in models:
        grid_axes = set(range(len(model.grid)))

        # KERN003: unguarded RMW accumulation into a shared block
        flagged_refs = set()
        for w in model.writes:
            if not w.rmw or w.is_zero_init or w.ref in flagged_refs:
                continue
            deps = model.dep_axes(w.ref)
            if deps is None:
                continue
            shared = grid_axes - set(deps)
            missing = shared - model.init_guards.get(w.ref, set())
            if not missing:
                continue
            flagged_refs.add(w.ref)
            trip = int(np.prod(model.grid)) if model.grid else 1
            ksite = KernelSite(
                op_name=model.name, kind="rmw",
                num_bins=0, num_updates=0, row_elems=0,
                combiner="add", trip_count=trip,
                hlo_line=model.source_line, classification="structural")
            _emit(KERN003, model, ksite,
                  f"{KERN003.summary}: ref {w.ref} of {model.name} is "
                  f"shared across grid axis(es) {sorted(missing)} "
                  f"(block index map ignores them) but carries no "
                  f"`pl.when(program_id == 0)` zero-init on those axes",
                  fixit="guard the first accumulation with "
                        "pl.when(pl.program_id(axis) == 0) "
                        "zero-initialization")

        # KERN004 (structural): a swap inside a while/retry loop is
        # CAS-shaped even when no scatter site could be derived from it
        if model.while_has_swap and not model.sites:
            trip = int(np.prod(model.grid)) if model.grid else 1
            ksite = KernelSite(
                op_name=model.name, kind="rmw", num_bins=0,
                num_updates=0, row_elems=0, combiner="cas",
                trip_count=trip, hlo_line=model.source_line,
                classification="structural")
            _emit(KERN004, model, ksite,
                  f"{KERN004.summary}: swap inside a while/retry loop in "
                  f"{model.name}; no scatter site could be derived, so "
                  f"the retry contention is unmodeled",
                  spec_=target.spec,
                  fixit="advisor transform CasToFao")

        for site in model.sites:
            deriv = lan.degree_stats(
                lan.derive_stream(model, site, target.operands))
            ksite = _site_record(target, model, site, deriv)
            site_job = _site_job(target, site)

            # KERN002: commit-group-aligned row scatter into an unpadded
            # shared copy (advisory)
            if (site.kind == "one_hot_matmul" and site.memory == "shared"
                    and not site.padded
                    and site.row_elems >= counters_mod.COMMIT_GROUP
                    and site.row_elems % counters_mod.COMMIT_GROUP == 0):
                stride_deg = math.gcd(site.row_elems,
                                      counters_mod.COMMIT_GROUP)
                _emit(KERN002, model, ksite,
                      f"{KERN002.summary}: {ksite.describe()}; modeled "
                      f"bank-conflict stride degree "
                      f"{stride_deg} (= gcd(row_elems, "
                      f"{counters_mod.COMMIT_GROUP}))",
                      severity="warning" if stride_deg >= 2 else "note",
                      spec_=target.spec,
                      fixit="pad the update row or apply the "
                            "LaneInterleave remap")

            # KERN004: CAS-class combiner / swap inside a retry loop
            if model.while_has_swap or site_job == timing.CAS:
                why = ("swap inside a while/retry loop"
                       if model.while_has_swap
                       else "non-integer (weighted) combiner lowers to "
                            "CAS-class service")
                if deriv.is_static:
                    _queue_scored(
                        KERN004, model, ksite, deriv, site_job=site_job,
                        base_job=timing.FAO,
                        message_fn=lambda u, c, v, k=ksite, w=why: (
                            f"{KERN004.summary}: {k.describe()}; {w}; "
                            f"predicted scatter U={u:.0%}, {c:.2f}x "
                            f"conflict-free FAO baseline "
                            f"({v.bottleneck}"
                            f"{' saturated' if v.saturated else ''})"))
                else:
                    _emit(KERN004, model, ksite,
                          f"{KERN004.summary}: {ksite.describe()}; {why}",
                          spec_=target.spec,
                          fixit="advisor transform CasToFao")

            # KERN001 / KERN005: the static-vs-dynamic fork
            if deriv.is_static:
                if deriv.mean_degree > deriv.floor_degree + 1e-9:
                    _queue_scored(
                        KERN001, model, ksite, deriv, site_job=site_job,
                        base_job=site_job,
                        message_fn=lambda u, c, v, k=ksite, d=deriv: (
                            f"{KERN001.summary}: {k.describe()}; derived "
                            f"mean degree {d.mean_degree:.1f} vs reorder "
                            f"floor {d.floor_degree:.1f}; predicted "
                            f"scatter U={u:.0%}, {c:.2f}x conflict-free "
                            f"baseline ({v.bottleneck}"
                            f"{' saturated' if v.saturated else ''})"))
                # at the floor: conflict behaviour is proven optimal for
                # this stream — certified clean, no finding
            else:
                _emit(KERN005, model, ksite,
                      f"{KERN005.summary}: {ksite.describe()}; "
                      f"{'; '.join(deriv.reasons)}",
                      spec_=target.spec,
                      fixit="profile the attached WorkloadSpec via "
                            "`repro sweep` / `Session.profile`")

    if scored:
        base_traces = counters_mod.traces_from_index_batch(
            baseline_streams, num_cores=cores, job_class=baseline_jobs,
            waves_per_tile=wpt, pipeline_depth=pd)
        for i, tr in enumerate(base_traces):
            csets[2 * i + 1] = counters_mod.CounterSet.from_trace(
                tr, label=f"{target.label}/__baseline__",
                **scored[i]["common"])
        profiles = session.profile_sets(csets)
        for i, cand in enumerate(scored):
            prof, base = profiles[2 * i], profiles[2 * i + 1]
            u = float(prof.scatter_utilization)
            u_base = max(float(base.scatter_utilization), 1e-9)
            contention = u / u_base
            verdict = bottleneck.classify(prof)
            rule = cand["rule"]
            findings.append(Finding(
                rule_id=rule.id, rule_slug=rule.slug,
                severity=audit_rules._finding_severity(rule, contention),
                message=cand["message_fn"](u, contention, verdict),
                label=f"{target.label}/{cand['ksite'].op_name}",
                site=cand["ksite"], utilization=u,
                bottleneck=verdict.bottleneck,
                hint=verdict.hint.compact() if verdict.hint else "",
                fixit=audit_rules._fixit(verdict),
                suppressed=rule.id in suppress,
                hlo_uri=_source_uri(cand["model"]),
                hlo_line=cand["ksite"].hlo_line, spec=target.spec,
                baseline_utilization=u_base, contention=contention))

    order = {"error": 0, "warning": 1, "note": 2}
    findings.sort(key=lambda f: (order[f.severity],
                                 -(f.utilization or 0.0), f.label))
    return findings
