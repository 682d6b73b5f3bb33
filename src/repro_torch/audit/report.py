"""Audit report container + text/json/csv/SARIF renderers + suppression.

SARIF output follows the 2.1.0 shape GitHub code-scanning upload
expects: one run, ``tool.driver`` with the rule catalog as
``reportingDescriptor``s, one ``result`` per finding with ``ruleIndex``
into that catalog, and in-source ``suppressions`` entries for findings
matched by a config's ``# repro: noqa RULE1,RULE2`` allowlist.

Severity map: our ``error``/``warning`` pass through; ``note`` maps to
SARIF level ``note``.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import re
from typing import Optional, Sequence

from repro_torch.analysis.render import rows_to_csv
from repro_torch.audit import rules as rules_mod
from repro_torch.audit.rules import CATALOG, Finding

SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"
SARIF_VERSION = "2.1.0"
TOOL_NAME = "repro-audit"

_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa:?\s*([A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*)")


def parse_noqa(source_text: str) -> set[str]:
    """Rule ids allowlisted via ``# repro: noqa ATOM001,GEOM001`` comments."""
    out: set[str] = set()
    for m in _NOQA_RE.finditer(source_text):
        out.update(t.strip() for t in m.group(1).split(","))
    return out


def noqa_for_object(obj) -> set[str]:
    """Suppressions declared in the module source defining ``obj``."""
    try:
        return parse_noqa(inspect.getsource(inspect.getmodule(obj)))
    except (OSError, TypeError):
        return set()


@dataclasses.dataclass
class AuditReport:
    """Findings for one audited target (a config, or one HLO module)."""

    label: str                       # e.g. config name, or module label
    device: str
    findings: list[Finding]
    steps: list[str] = dataclasses.field(default_factory=list)
    sites_scanned: int = 0
    instructions_scanned: int = 0

    # -- gating -----------------------------------------------------------

    def active(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def gated(self, fail_on: str) -> list[Finding]:
        """Non-suppressed findings at or above the gate severity."""
        if fail_on == "never":
            return []
        gate = rules_mod.SEVERITIES.index(fail_on)
        return [f for f in self.active() if f.gate_rank() >= gate]

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in rules_mod.SEVERITIES}
        for f in self.active():
            out[f.severity] += 1
        return out

    # -- renderers --------------------------------------------------------

    def to_rows(self) -> list[dict]:
        rows = []
        for f in self.findings:
            row = {
                "rule": f.rule_id, "slug": f.rule_slug,
                "severity": f.severity, "label": f.label,
                "utilization": f.utilization,
                "baseline_utilization": f.baseline_utilization,
                "contention": f.contention, "bottleneck": f.bottleneck,
                "hint": f.hint, "fixit": f.fixit,
                "suppressed": f.suppressed, "message": f.message,
            }
            if f.site is not None:
                row.update({
                    "op": f.site.op_name, "kind": f.site.kind,
                    "bins": f.site.num_bins, "updates": f.site.num_updates,
                    "row_elems": f.site.row_elems,
                    "combiner": f.site.combiner,
                    "trip_count": f.site.trip_count,
                    "hlo_line": f.site.hlo_line,
                })
            rows.append(row)
        return rows

    def render(self, fmt: str = "text") -> str:
        if fmt == "text":
            return self._render_text()
        if fmt == "json":
            payload = {
                "tool": TOOL_NAME, "label": self.label,
                "device": self.device, "steps": self.steps,
                "sites_scanned": self.sites_scanned,
                "instructions_scanned": self.instructions_scanned,
                "counts": self.counts(),
                "findings": self.to_rows(),
            }
            return json.dumps(payload, indent=2, default=str)
        if fmt == "csv":
            return rows_to_csv(self.to_rows())
        if fmt == "sarif":
            return json.dumps(self.to_sarif(), indent=2)
        raise ValueError(f"unknown report format {fmt!r} "
                         "(expected 'text', 'json', 'csv' or 'sarif')")

    def _render_text(self) -> str:
        lines = [f"== audit {self.label} on {self.device} "
                 f"({self.sites_scanned} site(s) from "
                 f"{self.instructions_scanned} instruction(s), "
                 f"steps: {', '.join(self.steps) or '-'}) =="]
        if not self.findings:
            lines.append("no findings")
        for f in self.findings:
            sup = " [suppressed]" if f.suppressed else ""
            u = f" U={f.utilization:.0%}" if f.utilization is not None else ""
            c = (f" x{f.contention:.2f}" if f.contention is not None else "")
            lines.append(f"{f.severity.upper():>7} {f.rule_id} "
                         f"{f.label}{u}{c}{sup}")
            lines.append(f"        {f.message}")
            if f.fixit:
                lines.append(f"        fix: {f.fixit}")
            if f.advice:
                lines.append(
                    f"        advise: x"
                    f"{f.advice.get('predicted_speedup', 0):.3f} via "
                    f"{f.advice.get('transforms', '?')} -> "
                    f"{f.advice.get('predicted_bottleneck', '?')}")
        c = self.counts()
        lines.append(f"{c['error']} error(s), {c['warning']} warning(s), "
                     f"{c['note']} note(s)"
                     + (f", {len(self.findings) - len(self.active())} "
                        "suppressed" if len(self.active())
                        != len(self.findings) else ""))
        return "\n".join(lines) + "\n"

    # -- SARIF ------------------------------------------------------------

    def to_sarif(self) -> dict:
        rule_ids, descriptors = _rule_descriptors()

        results = []
        for f in self.findings:
            res = {
                "ruleId": f.rule_id,
                "ruleIndex": rule_ids.index(f.rule_id),
                "level": _sarif_level(f.severity),
                "message": {"text": f.message},
            }
            if f.hlo_uri:
                res["locations"] = [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.hlo_uri},
                        "region": {"startLine": max(1, f.hlo_line)},
                    }
                }]
            props = {"label": f.label}
            if f.utilization is not None:
                props["predictedScatterUtilization"] = round(
                    f.utilization, 4)
            if f.contention is not None:
                props["contentionRatio"] = round(f.contention, 3)
            if f.bottleneck:
                props["bottleneck"] = f.bottleneck
            if f.fixit:
                props["fixit"] = f.fixit
            if f.advice:
                props["advise"] = f.advice
            res["properties"] = props
            if f.suppressed:
                res["suppressions"] = [{"kind": "inSource"}]
            results.append(res)

        return {
            "$schema": SARIF_SCHEMA,
            "version": SARIF_VERSION,
            "runs": [{
                "tool": {"driver": {
                    "name": TOOL_NAME,
                    "informationUri":
                        "https://github.com/paper-repro/repro",
                    "rules": descriptors,
                }},
                "results": results,
            }],
        }


def _rule_descriptors() -> tuple[list[str], list[dict]]:
    """The full reporting catalog: audit rules + AUDIT000 + KERN rules.

    ``repro audit`` and ``repro lint`` findings share one SARIF rule
    index, so their logs (and ``merge``d reports) interleave cleanly in
    one run.  The lint catalog is imported lazily — it is numpy-only,
    but keeping it out of module import keeps layering one-directional.
    """
    rule_ids: list[str] = []
    descriptors: list[dict] = []

    def add(rid, slug, summary, description, level):
        rule_ids.append(rid)
        descriptors.append({
            "id": rid, "name": _pascal(slug),
            "shortDescription": {"text": summary},
            "fullDescription": {"text": description},
            "defaultConfiguration": {"level": level},
        })

    for r in CATALOG:
        add(r.id, r.slug, r.summary, r.description,
            _sarif_level(r.base_severity))
    aid, aslug = rules_mod.AUDIT000
    add(aid, aslug, "while loop trip count could not be resolved",
        "Cost estimates multiply loop bodies by their trip counts; "
        "unresolved loops make per-site traffic a lower bound.", "note")
    try:
        from repro_torch.lint.rules import KERN_CATALOG
    except ImportError:             # lint layer absent: audit-only catalog
        KERN_CATALOG = ()
    for r in KERN_CATALOG:
        add(r.id, r.slug, r.summary, r.description,
            _sarif_level(r.base_severity))
    return rule_ids, descriptors


def merge_sarif(docs: Sequence[dict]) -> dict:
    """Combine SARIF documents produced by this module into one run.

    Results are re-indexed against the emitting doc's own rule list by
    ``ruleId``, so audit and lint logs merge regardless of the rule
    order they were written with (the CI merged-artifact path).
    """
    rule_ids, descriptors = _rule_descriptors()
    results: list[dict] = []
    for doc in docs:
        for run in doc.get("runs", []):
            for res in run.get("results", []):
                res = dict(res)
                rid = res.get("ruleId")
                if rid in rule_ids:
                    res["ruleIndex"] = rule_ids.index(rid)
                else:
                    res.pop("ruleIndex", None)
                results.append(res)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": TOOL_NAME,
                "informationUri": "https://github.com/paper-repro/repro",
                "rules": descriptors,
            }},
            "results": results,
        }],
    }


def merge(reports: Sequence[AuditReport], *, label: str = "zoo",
          ) -> AuditReport:
    """Combine per-config reports into one (the ``--all`` CLI path)."""
    reports = list(reports)
    device = reports[0].device if reports else "-"
    merged = AuditReport(
        label=label, device=device,
        findings=[f for r in reports for f in r.findings],
        steps=[s for r in reports for s in
               (f"{r.label}:{st}" for st in r.steps)],
        sites_scanned=sum(r.sites_scanned for r in reports),
        instructions_scanned=sum(r.instructions_scanned for r in reports))
    return merged


def _sarif_level(severity: str) -> str:
    return {"error": "error", "warning": "warning", "note": "note"}.get(
        severity, "note")


def _pascal(slug: str) -> str:
    return "".join(p.capitalize() for p in slug.split("-"))


def exit_code(report: AuditReport, fail_on: str) -> int:
    return 1 if report.gated(fail_on) else 0
