"""repro_torch.audit — static contention lint of a compiled step's HLO text.

Layers (providers -> **audit** -> advisor):

* ``scanner``  — instruction-graph walk of (pre-opt) HLO for
  atomic-shaped idioms (scatters, KV-cache DUS writes, one-hot and
  sort-segment histogram lowerings),
* ``rules``    — declarative catalog (ATOM001/002/003, BANK001,
  GEOM001 + the AUDIT000 module note) scoring each site with one
  columnar model pass — zero kernel executions,
* ``report``   — text/json/csv/SARIF renderers and ``# repro: noqa``
  suppression.

Entry points: ``audit_hlo`` (one module text) and ``audit_source`` (text
or a ``WorkloadSpec`` built with ``from_compiled(hlo_text=...)`` — what
``Session.audit`` calls).  The text is HLO as JAX lowers it; a torch
program has no HLO.  Auditing a zoo config end to end
(``audit_config``: lower each step, then audit it) waits for ROADMAP
queue 1, "Multi-device and the zoo audit", where torch programs are
captured with ``torch.export`` instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.audit import rules as rules_mod
from repro_torch.audit.report import (AuditReport, exit_code, merge,
                                      merge_sarif, parse_noqa)
from repro_torch.audit.rules import CATALOG, Finding, Rule
from repro_torch.audit.scanner import AtomicSite, ScanResult, scan_hlo

__all__ = [
    "AtomicSite", "AuditReport", "CATALOG", "Finding", "Rule",
    "ScanResult", "attach_advice", "audit_config", "audit_hlo",
    "audit_source", "exit_code", "merge", "merge_sarif", "parse_noqa",
    "scan_hlo",
]

ZOO_AUDIT = ("auditing a zoo config is not ported yet (ROADMAP queue 1, "
             "\"Multi-device and the zoo audit\"): lowering a config to HLO "
             "takes JAX, and capturing a torch program comes with that item; "
             "audit the step's HLO text instead (--hlo-file PATH)")


def _device_name(session) -> str:
    dev = getattr(session, "device", None)
    return getattr(dev, "name", str(dev))


def _make_session(device: str = "v5e"):
    from repro_torch.analysis.session import Session  # lazy: light import
    return Session(device)


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
    scan = scan_hlo(text)
    findings = rules_mod.evaluate(
        scan, session, label=label, rules=rules or CATALOG,
        suppress=suppress, hlo_uri=hlo_uri, num_cores=num_cores)
    return AuditReport(
        label=label, device=_device_name(session), findings=findings,
        steps=[label], sites_scanned=len(scan.sites),
        instructions_scanned=scan.num_instructions)


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


def _source_text(source) -> str:
    """HLO text from str / a ``WorkloadSpec`` built with
    ``from_compiled(hlo_text=...)``."""
    if isinstance(source, str):
        return source
    hlo_text = getattr(source, "hlo_text", None)
    if hlo_text:
        return hlo_text
    raise ValueError(
        f"cannot extract HLO from {type(source).__name__!r} — pass module "
        "text or a WorkloadSpec built with "
        "WorkloadSpec.from_compiled(hlo_text=...); capturing a torch "
        "program waits for ROADMAP queue 1, \"Multi-device and the zoo "
        "audit\"")


def audit_source(source, *, session=None, label: str = "module",
                 rules: Optional[Sequence[Rule]] = None,
                 suppress: Sequence[str] = (),
                 num_cores: int = 8) -> AuditReport:
    """Audit any HLO-bearing source (what ``Session.audit`` delegates to)."""
    if label == "module":
        label = getattr(source, "label", label)
    return audit_hlo(_source_text(source), session=session, label=label,
                     rules=rules, suppress=suppress, num_cores=num_cores)


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
    """Audit every applicable step of a zoo config: not ported yet.

    The reference lowers each step with JAX; the port has no such
    lowering, so this raises ``NotImplementedError`` naming the ROADMAP
    item that brings it.
    """
    raise NotImplementedError(f"{arch}: {ZOO_AUDIT}")
