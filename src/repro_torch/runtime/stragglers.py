"""Straggler detection via the paper's operational method (a copy of
the reference's numpy-only module).

Each host is a single-server queue whose jobs are training steps.  From
per-host step times we form the operational utilization of the *fleet
barrier*: a host whose service time drifts above the fleet's median
(utilization of the barrier interval > threshold) is flagged.  This reuses
the same law (U = B/T, B = N*S) the shared-scatter model uses — paper §6:
"our method is also applicable to other functional units".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    host_id: int
    mean_step_s: float
    barrier_utilization: float   # host busy time / barrier window
    is_straggler: bool


def detect(step_times_per_host: dict[int, Sequence[float]],
           window: int = 20, threshold: float = 1.15
           ) -> list[StragglerReport]:
    """threshold: flagged when host busy time exceeds 115% of the fleet
    median busy time over the window (i.e. it sets the barrier)."""
    reports = []
    recent = {h: np.asarray(list(t)[-window:], np.float64)
              for h, t in step_times_per_host.items() if len(t)}
    if not recent:
        return reports
    med = np.median([t.mean() for t in recent.values()])
    barrier = max(t.mean() for t in recent.values())
    for host, t in sorted(recent.items()):
        busy = t.mean()
        u = busy / barrier if barrier > 0 else 0.0
        reports.append(StragglerReport(
            host_id=host, mean_step_s=float(busy),
            barrier_utilization=float(u),
            is_straggler=bool(busy > threshold * med)))
    return reports


def mitigation(report: list[StragglerReport]) -> str:
    bad = [r.host_id for r in report if r.is_straggler]
    if not bad:
        return "none"
    return (f"hosts {bad} set the barrier: exclude from the next elastic "
            f"remesh epoch, or rebalance their data shards")
