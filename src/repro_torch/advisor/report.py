"""Ranked advisor output: candidates, predicted fixes, rendered reports.

The paper's case study (§5) explains *why* ``hist2`` wins; an
``AdvisorReport`` turns that explanatory power prescriptive: every
evaluated transform composition with its model-predicted speedup, the
predicted post-transform bottleneck (with a warning when the transform
*moves* the bottleneck — the §4.1 shift, now forecast instead of
observed), the rewrite's cost annotations, and optionally the paper-§5
model-vs-measured validation of the top candidates.

Renderable ``text`` / ``json`` / ``csv``; csv rows are ragged (each
candidate only carries its own transforms' ``param_*`` columns) and go
through the same union-header helper sweep csv uses.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.advisor.transforms import Transform, TransformCost
from repro_torch.analysis.render import rows_to_csv


@dataclasses.dataclass
class Candidate:
    """One evaluated transform composition."""

    spec: "object"                         # the rewritten WorkloadSpec
    transforms: tuple[Transform, ...]
    profile: Optional[object] = None       # predicted WorkloadProfile
    speedup: float = 1.0                   # modeled T(base) / T(candidate)
    verdict: Optional[object] = None       # BottleneckVerdict (with hint)
    cost: TransformCost = dataclasses.field(default_factory=TransformCost)
    validation: Optional[object] = None    # ValidationReport (top-k only)

    @property
    def label(self) -> str:
        return self.spec.label

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.transforms)

    @property
    def families(self) -> tuple[str, ...]:
        return tuple(t.family for t in self.transforms)

    def params(self) -> dict:
        """Merged transform parameters, ``param_``-prefixed for rows."""
        out: dict = {}
        for t in self.transforms:
            for k, v in t.params().items():
                out[f"param_{k}"] = v
        return out

    def summary(self) -> dict:
        """Compact dict of the candidate — what audit/lint findings
        attach as ``Finding.advice`` (and SARIF ``properties.advise``)."""
        prof = self.profile
        return {
            "transforms": "+".join(self.names),
            "families": "+".join(self.families),
            "predicted_speedup": round(float(self.speedup), 4),
            "predicted_bottleneck": prof.bottleneck if prof else "",
            "predicted_scatter_U": round(
                float(prof.scatter_utilization), 4) if prof else 0.0,
        }


@dataclasses.dataclass
class AdvisorReport:
    """The ranked frontier + baseline context (see module docstring)."""

    device: str
    baseline_label: str
    baseline_profile: object               # WorkloadProfile
    baseline_verdict: object               # BottleneckVerdict
    candidates: list[Candidate]            # every evaluated one, ranked
    top_k: int = 5
    stats: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.candidates)

    def top(self, k: Optional[int] = None) -> list[Candidate]:
        return self.candidates[:self.top_k if k is None else k]

    @property
    def best(self) -> Optional[Candidate]:
        return self.candidates[0] if self.candidates else None

    # -- flat rows (the csv/json payload) ---------------------------------

    def to_rows(self, limit: Optional[int] = None) -> list[dict]:
        """One flat record per ranked candidate (top-k by default).

        Ragged by construction: ``param_*`` columns depend on the
        candidate's transforms and ``validation_*`` columns exist only
        for validated candidates — render through the union-header csv
        helper, never ``fieldnames=rows[0]``.
        """
        base_bn = self.baseline_verdict.bottleneck
        rows = []
        for rank, c in enumerate(self.top(limit), start=1):
            prof = c.profile
            row = {
                "rank": rank,
                "label": c.label,
                "transforms": "+".join(c.names),
                "families": "+".join(c.families),
                "predicted_speedup": float(c.speedup),
                "predicted_bottleneck": prof.bottleneck if prof else "",
                # U of the unit named as the bottleneck (the verdict's
                # number) — pairing the hbm bottleneck with the scatter
                # model's utilization would read as a contradiction
                "predicted_U": (c.verdict.utilization if c.verdict
                                else 0.0),
                "predicted_scatter_U": (prof.scatter_utilization
                                        if prof else 0.0),
                "predicted_e": prof.e if prof else 0.0,
                "shifts_bottleneck": bool(prof
                                          and prof.bottleneck != base_bn),
                "scratch_bytes": c.cost.scratch_bytes,
                "reduce_flops": c.cost.reduce_flops,
                "cost_note": c.cost.note,
            }
            row.update(c.params())
            if c.validation is not None:
                row["validation_e_rel_err"] = c.validation.rel_err(
                    "kernel", "e")
                row["validation_max_rel_err"] = c.validation.max_rel_err
            rows.append(row)
        return rows

    # -- renderers --------------------------------------------------------

    def render(self, fmt: str = "text") -> str:
        if fmt == "json":
            b = self.baseline_profile
            payload = {
                "device": self.device,
                "baseline": {
                    "label": self.baseline_label,
                    "bottleneck": self.baseline_verdict.bottleneck,
                    "utilization": self.baseline_verdict.utilization,
                    "scatter_U": b.scatter_utilization,
                    "e": b.e,
                    "T_cycles": float(np.max(b.T_cycles)),
                    "hint": (dataclasses.asdict(self.baseline_verdict.hint)
                             if self.baseline_verdict.hint else None),
                },
                "candidates": self.to_rows(),
                "stats": self.stats,
            }
            return json.dumps(payload, indent=2)
        if fmt == "csv":
            return rows_to_csv(self.to_rows())
        if fmt == "text":
            return self._render_text()
        raise ValueError(f"unknown report format {fmt!r} "
                         "(expected 'text', 'json' or 'csv')")

    def _render_text(self) -> str:
        lines = []
        b = self.baseline_profile
        n = self.stats.get("candidates", len(self.candidates))
        lines.append(
            f"== advisor: {self.baseline_label} on {self.device} "
            f"({n} candidate{'s' if n != 1 else ''}, "
            f"{self.stats.get('frontiers', 0)} frontier(s)) ==")
        hint = self.baseline_verdict.hint
        lines.append(
            f"baseline: bottleneck={self.baseline_verdict.bottleneck}  "
            f"U={self.baseline_verdict.utilization:6.2%}  e={b.e:.2f}  "
            f"T={float(np.max(b.T_cycles)):.0f} cyc"
            + (f"  [{hint.compact()}]" if hint else ""))
        for row in self.to_rows():
            cost_bits = []
            if row["scratch_bytes"]:
                cost_bits.append(f"+{row['scratch_bytes']:.0f}B scratch")
            if row["reduce_flops"]:
                cost_bits.append(f"+{row['reduce_flops']:.0f} reduce flops")
            cost = ", ".join(cost_bits) if cost_bits else "free"
            shift = "  ! shifts bottleneck" if row["shifts_bottleneck"] \
                else ""
            lines.append(
                f"rank {row['rank']:>2}  x{row['predicted_speedup']:.3f}  "
                f"{row['transforms']:<32} -> "
                f"{row['predicted_bottleneck']} "
                f"U={row['predicted_U']:6.2%}  [{cost}]{shift}")
            if row["cost_note"]:
                lines.append(f"          note: {row['cost_note']}")
            if "validation_e_rel_err" in row:
                lines.append(
                    f"          validated (kernel vs trace): "
                    f"e rel err={row['validation_e_rel_err']:.2%}, "
                    f"max rel err={row['validation_max_rel_err']:.2%}")
        collected = self.stats.get("collected")
        if collected is not None:
            lines.append(
                f"cache: {collected} collected, "
                f"{self.stats.get('memo_hits', 0)} memo hits, "
                f"{self.stats.get('disk_hits', 0)} disk hits")
        return "\n".join(lines)
