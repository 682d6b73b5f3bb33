"""repro_torch.lint — static atomic-contention and race lint of the
port's CUDA kernels.

Layers (kernels -> **lint** -> audit report/SARIF -> advisor):

* ``symbolic`` — expression AST over grid/wave/lane variables with an
  exact numpy evaluator (torch-free),
* ``tracing``  — each kernel's launch as declared beside its launcher
  (grid, blocks, accumulators: shared or L2, padded, zeroing, the atomic
  that combines, the flush) and its committed index stream, traced from
  torch on meta tensors into the expression AST,
* ``analysis`` — static classification of index streams; where static,
  exact degree counters bit-for-bit equal to ``TraceProvider``'s with
  zero kernel launches,
* ``rules``    — the KERN001–KERN005 catalog, scored through the same
  columnar ``profile_sets`` pass and rendered by the same
  ``AuditReport``/SARIF machinery as ``repro_torch.audit``,
* ``registry`` — the port's kernels with deterministic probes.

Entry points: ``lint_kernel`` (one registered kernel), ``lint_registry``
(all of them, merged report — what ``Session.lint`` and ``python -m
repro_torch lint`` call), ``lint_spec`` (any ``WorkloadSpec`` carrying a
``KernelSource``), and ``derive_counters`` (the static counter path by
itself).  Nothing here launches a kernel or needs a card.

Suppression: ``# repro: noqa KERN002`` comments *in the module that
declares the kernel's launch* suppress that rule for its findings
(surfacing as SARIF ``suppressions: [{"kind": "inSource"}]`` entries),
the same syntax the audit honors in zoo configs.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.audit.report import AuditReport, noqa_for_object
from repro_torch.lint.analysis import (LintTarget, StaticDerivation,
                                       derive_counters, target_from_spec)
from repro_torch.lint.rules import (KERN_CATALOG, KernelRule, KernelSite,
                                    evaluate_target, kern_rule_by_id)

__all__ = [
    "AuditReport", "KERN_CATALOG", "KernelRule", "KernelSite",
    "LintTarget", "StaticDerivation", "derive_counters",
    "evaluate_target", "kern_rule_by_id", "kernel_names", "lint_kernel",
    "lint_registry", "lint_spec", "lint_target", "target_from_spec",
]


def kernel_names() -> list[str]:
    from repro_torch.lint import registry
    return registry.names()


def _make_session(device: str = "v5e"):
    from repro_torch.analysis.session import Session
    return Session(device)


def _device_name(session) -> str:
    dev = getattr(session, "device", None)
    return getattr(dev, "name", str(dev))


def lint_target(target: LintTarget, *, session=None,
                suppress: Sequence[str] = (),
                num_cores: Optional[int] = None) -> AuditReport:
    """Lint one prepared target; suppressions include in-source noqa."""
    from repro_torch.lint.analysis import analyze_target

    if session is None:
        session = _make_session()
    suppress = set(suppress)
    if target.module is not None:
        suppress |= noqa_for_object(target.module)
    models = analyze_target(target)
    findings = evaluate_target(target, session, models=models,
                               suppress=suppress, num_cores=num_cores)
    return AuditReport(
        label=target.label, device=_device_name(session),
        findings=findings, steps=[target.label],
        sites_scanned=sum(len(m.sites) for m in models),
        instructions_scanned=sum(m.num_eqns for m in models))


def lint_kernel(name: str, *, session=None, suppress: Sequence[str] = (),
                num_cores: Optional[int] = None) -> AuditReport:
    """Lint one registered kernel by name (see ``kernel_names()``)."""
    from repro_torch.lint import registry

    return lint_target(registry.build_target(name), session=session,
                       suppress=suppress, num_cores=num_cores)


def lint_registry(names: Optional[Sequence[str]] = None, *, session=None,
                  suppress: Sequence[str] = (),
                  num_cores: Optional[int] = None) -> AuditReport:
    """Lint registered kernels (all by default) into one merged report."""
    from repro_torch.audit.report import merge
    from repro_torch.lint import registry

    if session is None:
        session = _make_session()
    reports = [lint_kernel(n, session=session, suppress=suppress,
                           num_cores=num_cores)
               for n in (names or registry.names())]
    merged = merge(reports, label="kernels")
    order = {"error": 0, "warning": 1, "note": 2}
    merged.findings.sort(key=lambda f: (order[f.severity],
                                        -(f.utilization or 0.0), f.label))
    return merged


def lint_spec(spec, *, session=None, suppress: Sequence[str] = (),
              num_cores: Optional[int] = None) -> AuditReport:
    """Lint any ``WorkloadSpec`` that carries a ``KernelSource``."""
    return lint_target(target_from_spec(spec), session=session,
                       suppress=suppress, num_cores=num_cores)
