"""repro_torch.audit — static contention lint of a step: HLO text or a
captured torch step.

Layers (providers -> **audit** -> advisor):

* ``scanner``  — instruction-graph walk of (pre-opt) HLO, and
  ``scan_graph`` over a captured step's aten nodes, for atomic-shaped
  idioms (scatters, KV-cache writes, one-hot and sort-segment histogram
  lowerings, the K5 and K7 operators),
* ``rules``    — declarative catalog (ATOM001/002/003, BANK001,
  GEOM001 + the AUDIT000 module note) scoring each site with one
  columnar model pass — zero kernel executions,
* ``report``   — text/json/csv/SARIF renderers and ``# repro: noqa``
  suppression,
* ``zoo``      — config -> per-step captured graph (``launch.lowering``;
  kept out of this module's import path).

Entry points: ``audit_hlo`` (one module text), ``audit_capture`` (one
captured step), ``audit_source`` (text / a ``Capture`` / a
``WorkloadSpec`` from ``from_compiled`` — what ``Session.audit`` calls),
and ``audit_config`` (a zoo config end to end).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.audit import rules as rules_mod
from repro_torch.audit.report import (AuditReport, exit_code, merge,
                                      merge_sarif, parse_noqa)
from repro_torch.audit.rules import CATALOG, Finding, Rule
from repro_torch.audit.scanner import (AtomicSite, ScanResult, scan_graph,
                                       scan_hlo)

__all__ = [
    "AtomicSite", "AuditReport", "CATALOG", "Finding", "Rule",
    "ScanResult", "attach_advice", "audit_config", "audit_hlo",
    "audit_capture", "audit_source", "exit_code", "merge", "merge_sarif",
    "parse_noqa", "scan_graph", "scan_hlo",
]


def _device_name(session) -> str:
    dev = getattr(session, "device", None)
    return getattr(dev, "name", str(dev))


def _make_session(device: str = "v5e"):
    from repro_torch.analysis.session import Session  # lazy: light import
    return Session(device)


def _audit_scan(scan: ScanResult, session, label, rules, suppress,
                hlo_uri, num_cores) -> AuditReport:
    findings = rules_mod.evaluate(
        scan, session, label=label, rules=rules or CATALOG,
        suppress=suppress, hlo_uri=hlo_uri, num_cores=num_cores)
    return AuditReport(
        label=label, device=_device_name(session), findings=findings,
        steps=[label], sites_scanned=len(scan.sites),
        instructions_scanned=scan.num_instructions)


def audit_hlo(text: str, *, session=None, label: str = "module",
              rules: Optional[Sequence[Rule]] = None,
              suppress: Sequence[str] = (), hlo_uri: str = "",
              num_cores: int = 8) -> AuditReport:
    """Scan one HLO module text and score every finding.

    Scoring synthesizes index streams and evaluates them in a single
    ``session.profile_sets`` pass; the session's trace/kernel providers
    are never invoked.
    """
    if session is None:
        session = _make_session()
    return _audit_scan(scan_hlo(text), session, label, rules, suppress,
                       hlo_uri, num_cores)


def audit_capture(capture, *, session=None, label: str = "module",
                  rules: Optional[Sequence[Rule]] = None,
                  suppress: Sequence[str] = (), hlo_uri: str = "",
                  num_cores: int = 8) -> AuditReport:
    """``audit_hlo`` of a captured step (``launch.capture.Capture``):
    ``scan_graph`` instead of ``scan_hlo``, the same rules and scoring."""
    if session is None:
        session = _make_session()
    return _audit_scan(scan_graph(capture), session, label, rules, suppress,
                       hlo_uri, num_cores)


def attach_advice(report: AuditReport, session=None, *, depth: int = 2,
                  beam_width: int = 8, top_k: int = 3,
                  min_severity: str = "warning") -> AuditReport:
    """Run ``Session.advise`` on gating findings; attach the top transform.

    The "audit findings -> advised scenarios" play: every non-suppressed
    finding at or above ``min_severity`` that carries a candidate
    ``WorkloadSpec`` gets the advisor's best-ranked transform
    composition (predicted speedup + post-transform bottleneck) as
    ``Finding.advice`` — rendered into SARIF ``properties.advise`` and
    the text report.  Specs are deduplicated by fingerprint so one
    advisor search serves every finding that shares a workload.  The
    search validates nothing, so it launches no kernel.
    """
    if session is None:
        session = _make_session()
    gate = rules_mod.SEVERITIES.index(min_severity)
    cache: dict = {}
    updated = []
    for f in report.findings:
        if (f.suppressed or f.spec is None or f.gate_rank() < gate
                or f.advice is not None):
            updated.append(f)
            continue
        key = f.spec.fingerprint()
        if key not in cache:
            adv = session.advise(f.spec, depth=depth,
                                 beam_width=beam_width, top_k=top_k)
            cache[key] = adv.best.summary() if adv.best else None
        if cache[key] is None:
            updated.append(f)
            continue
        import dataclasses
        updated.append(dataclasses.replace(f, advice=dict(cache[key])))
    report.findings = updated
    return report


def _is_capture(source) -> bool:
    return hasattr(source, "nodes") and hasattr(source, "input_storages")


def _source_text(source):
    """HLO text, or a captured step, from str / ``Capture`` / a
    ``WorkloadSpec`` built with ``from_compiled(...)``."""
    if isinstance(source, str) or _is_capture(source):
        return source
    hlo_text = getattr(source, "hlo_text", None)
    if hlo_text:
        return hlo_text
    compiled = getattr(source, "compiled", None)
    if compiled is not None and _is_capture(compiled):
        return compiled           # WorkloadSpec.from_compiled(compiled=...)
    raise ValueError(
        f"cannot extract HLO from {type(source).__name__!r} — pass module "
        "text, a captured step (launch.lowering.build_captured), or a "
        "WorkloadSpec built with WorkloadSpec.from_compiled(...)")


def audit_source(source, *, session=None, label: str = "module",
                 rules: Optional[Sequence[Rule]] = None,
                 suppress: Sequence[str] = (),
                 num_cores: int = 8) -> AuditReport:
    """Audit any HLO-bearing source (what ``Session.audit`` delegates to)."""
    if label == "module":
        label = getattr(source, "label", label)
    src = _source_text(source)
    if isinstance(src, str):
        return audit_hlo(src, session=session, label=label, rules=rules,
                         suppress=suppress, num_cores=num_cores)
    return audit_capture(src, session=session, label=label, rules=rules,
                         suppress=suppress, num_cores=num_cores)


def config_noqa(arch: str) -> set[str]:
    """``# repro: noqa`` allowlist declared in a config's defining module."""
    import importlib
    import inspect

    from repro_torch.configs import ARCHS
    try:
        mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
        return parse_noqa(inspect.getsource(mod))
    except Exception:
        return set()


def audit_config(arch: str, *, session=None,
                 steps: Optional[Sequence[str]] = None,
                 reduced: bool = False, variant: str = "base",
                 rules: Optional[Sequence[Rule]] = None,
                 extra_suppress: Sequence[str] = (),
                 hlo_sink=None, num_cores: int = 8) -> AuditReport:
    """Audit every applicable step of a zoo config.

    Suppressions come from ``# repro: noqa RULE,...`` comments in the
    config's defining module, plus ``extra_suppress``.  ``hlo_sink``,
    when given, is called with ``(step, text)`` per captured step (the
    printed graph) and returns the artifact URI recorded in SARIF
    locations (or None).
    """
    from repro_torch.audit import zoo  # lazy: captures on the meta device

    if session is None:
        session = _make_session()
    arch = zoo.normalize_arch(arch)
    suppress = set(extra_suppress) | config_noqa(arch)
    captures = zoo.lower_config_steps(arch, steps=steps, reduced=reduced,
                                      variant=variant)
    findings: list[Finding] = []
    done_steps: list[str] = []
    sites = instrs = 0
    for step, cap in captures.items():
        uri = None
        if hlo_sink is not None:
            uri = hlo_sink(step, cap.text)
        rep = audit_capture(cap, session=session, label=f"{arch}/{step}",
                            rules=rules, suppress=suppress,
                            hlo_uri=uri or "", num_cores=num_cores)
        findings.extend(rep.findings)
        done_steps.append(step)
        sites += rep.sites_scanned
        instrs += rep.instructions_scanned
    order = {"error": 0, "warning": 1, "note": 2}
    findings.sort(key=lambda f: (order[f.severity],
                                 -(f.utilization or 0.0), f.label))
    return AuditReport(
        label=arch, device=_device_name(session), findings=findings,
        steps=done_steps, sites_scanned=sites,
        instructions_scanned=instrs)
