"""Bottleneck classification and shift detection (paper §4.1).

The paper's headline capability: given utilization estimates across a
sweep (image sizes, batch sizes, router temperatures, ...), say *which
unit bounds each point* and flag where the bottleneck *shifts* — e.g. the
histogram moving from the shared-memory atomic unit to global memory at
~2^20 pixels, "unambiguously represented in our model's results".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.profiler import WorkloadProfile

SATURATED = 0.90   # unit considered saturated (a bottleneck) above this
UNDERUTILIZED = 0.50


@dataclasses.dataclass(frozen=True)
class Hint:
    """Machine-usable optimization hint attached to a verdict.

    ``comment`` is prose for humans; ``Hint`` is the same advice as
    data: which ``unit`` the advice targets, a stable ``action`` id, and
    the ``repro_torch.advisor`` transform ``family`` that implements it — so a
    tool (or the advisor itself) can act on a verdict without parsing
    English.
    """

    unit: str                # the unit the advice targets
    action: str              # stable id: reduce_contention | ...
    family: str              # advisor transform family implementing it

    def compact(self) -> str:
        """Flat ``action:family@unit`` form for text/csv cells."""
        return f"{self.action}:{self.family}@{self.unit}"


# Per-unit advice for a saturated (or leading) server: what to do about
# it, and which advisor transform family does that.  Units without a
# shipped transform family still get a stable family name so the hint
# remains actionable by external tooling.
_UNIT_HINTS = {
    "scatter": ("reduce_contention", "rotation"),
    "hbm": ("reduce_traffic", "tiling"),
    "mxu": ("reduce_flops", "precision"),
    "ici": ("reduce_collectives", "sharding"),
}


def _hint_for(name: str, u: float) -> Hint:
    if u <= UNDERUTILIZED:
        # nothing saturated: concurrency/overhead is the lever
        return Hint(unit=name, action="raise_concurrency",
                    family="geometry")
    action, family = _UNIT_HINTS.get(name, ("rebalance", "geometry"))
    return Hint(unit=name, action=action, family=family)


@dataclasses.dataclass
class BottleneckVerdict:
    label: str
    bottleneck: str
    utilization: float
    saturated: bool
    comment: str = ""
    hint: Optional[Hint] = None


@dataclasses.dataclass
class ShiftEvent:
    index: int
    label_before: str
    label_after: str
    unit_before: str
    unit_after: str


def classify(profile: WorkloadProfile) -> BottleneckVerdict:
    name = profile.bottleneck
    # "none" (every unit idle) is a verdict, not a unit: look it up safely
    u = _unit_utilization(profile, name) if profile.units else 0.0
    if u >= SATURATED:
        comment = f"{name} saturated — optimizing other units will not help"
    elif u <= UNDERUTILIZED:
        comment = ("no unit saturated — latency/overhead bound "
                   "(raise concurrency or fuse launches)")
    else:
        comment = f"{name} leading but unsaturated"
    return BottleneckVerdict(label=profile.label, bottleneck=name,
                             utilization=u, saturated=u >= SATURATED,
                             comment=comment, hint=_hint_for(name, u))


SHIFT_TOL = 0.02   # relative lead a new unit needs to count as a shift


def _unit_utilization(profile: WorkloadProfile, name: str) -> float:
    try:
        return profile.unit(name).utilization
    except KeyError:
        return 0.0


def detect_shifts(profiles: Sequence[WorkloadProfile],
                  tol: float = SHIFT_TOL) -> list[ShiftEvent]:
    """Find sweep points where the dominant unit changes.

    A bare argmax flip is noisy: two unsaturated units within rounding
    error of each other flip leadership from point to point without any
    real change in what bounds the workload.  A shift therefore only
    fires when the candidate unit *leads the currently held bottleneck by
    a relative margin* of ``tol`` at that point; near-ties keep the held
    unit (hysteresis), so a sweep through a crossover emits one event,
    not a flicker of them.
    """
    events = []
    if not profiles:
        return events
    current = profiles[0].bottleneck
    for i in range(1, len(profiles)):
        b = profiles[i]
        candidate = b.bottleneck
        if candidate == current:
            continue
        u_new = _unit_utilization(b, candidate)
        u_held = _unit_utilization(b, current)
        if u_new <= u_held * (1.0 + tol):
            continue   # within the tie margin: not a real shift
        events.append(ShiftEvent(
            index=i, label_before=profiles[i - 1].label, label_after=b.label,
            unit_before=current, unit_after=candidate))
        current = candidate
    return events


def speedup_estimate(before: WorkloadProfile, after: WorkloadProfile) -> float:
    """Predicted speedup of `after` over `before` from modeled windows.

    Two degenerate cases: both windows zero means "nothing modeled on
    either side" and the only honest answer is parity (1.0), while a zero
    ``after`` window against real ``before`` work is a broken profile —
    an infinite speedup must never propagate silently into reports.
    """
    t0 = float(np.max(before.T_cycles))
    t1 = float(np.max(after.T_cycles))
    if t1 > 0:
        return t0 / t1
    if t0 == 0:
        return 1.0
    raise ValueError(
        f"speedup_estimate: profile {after.label!r} has a zero modeled "
        f"window (T_cycles all zero) — cannot report a finite speedup "
        f"over {before.label!r}")
