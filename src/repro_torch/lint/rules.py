"""The KERN rule catalog: the kernel lint's rules, as data.

The reference's kernel lint (``repro.lint``) traces its Pallas kernels
and rates what it finds with these five rules.  That analysis waits for
the port's kernel-lint slice (ROADMAP queue 1, "Kernel lint"); what is
here now is the catalog alone, because every SARIF log of
``repro_torch.audit.report`` lists the KERN rules in its rule index
beside the audit's own, as the reference's does:

    KERN001  affine-hot-bin          static degree above the reorder floor
    KERN002  bank-stride-conflict    commit-group-aligned row updates
    KERN003  unsynchronized-rmw-race accumulate into a shared block with
                                     no init guard on the sharing axis
    KERN004  cas-retry-loop          CAS-class combiner or swap-in-loop
    KERN005  data-dependent-index    needs dynamic audit (carries a
                                     WorkloadSpec for the sweep path)

The rule texts are the reference's, word for word.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """Catalog metadata; the matching logic comes with the lint."""

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
