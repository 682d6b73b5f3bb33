"""The kernel lint held to the kernels it models.

Shared by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``, and
run on the CPU by ``tests/test_torch_lint.py`` (where the kernels' plain
versions stand in for them):

* ``k3_against_derivation``: each registered probe whose stream is
  static (``hist``, ``hist2`` and ``hist_weighted`` on the solid image)
  through K3 once; its per-wave degrees must equal the static
  derivation's trace bit for bit, and its CounterSet (N, O, e and every
  other field but the source) the lint's;
* ``kern005_through_k6``: each KERN005 finding's spec of the registry
  through ``Session.validate(spec, ("trace", kernel))``, K6 once a spec,
  e relative error exactly 0.0;
* ``declared_combines``: each registered declaration's combine classes
  against those of the instantiation's SASS opcodes (``chip_smoke.py``'s
  ``sass_atomics``).
"""

import numpy as np

STATIC_PROBES = ("hist", "hist2", "hist_weighted")


def k3_against_derivation(torch_device) -> list[dict]:
    """One row a static probe; raises AssertionError on a mismatch."""
    from repro_torch.core import counters
    from repro_torch.lint import analysis, registry

    rows = []
    for name in STATIC_PROBES:
        target = registry.build_target(name)
        spec = target.spec
        derived, deriv = analysis.derive_counters(spec, target=target)
        assert derived is not None, (name, deriv.reasons)
        want = analysis._trace_from_derivation(
            deriv, spec, job_class=target.job_class,
            waves_per_tile=target.waves_per_tile)
        got = spec.run_kernel(torch_device)          # K3, once
        measured = counters.CounterSet.from_trace(
            got, label=spec.label, num_cores=spec.num_cores,
            bytes_read=spec.bytes_read, flops=spec.flops,
            overhead_cycles=spec.overhead_cycles, source="trace")
        assert (got.degree.dtype == want.degree.dtype
                and np.array_equal(got.degree, want.degree)), \
            f"{name}: K3's degrees differ from the static derivation"
        assert counters.bitwise_equal(measured, derived), \
            f"{name}: K3's counters differ from the lint's"
        rows.append({"name": name, "waves": int(got.degree.shape[0]),
                     "N": float(np.sum(derived.N)),
                     "O": float(np.sum(derived.O)),
                     "e": float(derived.e),
                     "mean_degree": deriv.mean_degree,
                     "floor_degree": deriv.floor_degree})
    return rows


def kern005_through_k6(session, torch_device) -> list[dict]:
    """Each KERN005 spec of the registry through trace and K6: e rel err
    0.0."""
    from repro_torch.analysis.providers import InstrumentedKernelProvider
    from repro_torch.lint import lint_registry

    kernel = InstrumentedKernelProvider(torch_device=torch_device)
    specs = {f.label: f.spec for f in lint_registry(session=session).findings
             if f.rule_id == "KERN005"}
    rows = []
    for label, spec in specs.items():
        rep = session.validate(spec, ("trace", kernel), check_batch=False)
        trace, measured = rep.comparisons
        assert (measured.rel_err["e"] == 0.0
                and measured.counters["N"] == trace.counters["N"]
                and measured.counters["O"] == trace.counters["O"]), \
            f"validate {label}: {rep.to_dict()}"
        rows.append({"label": label, "e": measured.counters["e"],
                     "N": measured.counters["N"]})
    return rows


def declared_combines(sass: dict) -> list[dict]:
    """Each registered declaration against its instantiation's SASS
    (``{instantiation: [opcode, ...]}``); raises on a mismatch."""
    from repro_torch.lint import registry
    from repro_torch.lint.tracing import combine_classes

    rows = []
    for name in registry.names():
        decl = registry.build_target(name).decl
        assert decl.kernel in sass, f"{name}: no SASS for {decl.kernel}"
        want = decl.expected_combines()
        got = combine_classes(sass[decl.kernel])
        assert got == want, (f"{name}: {decl.kernel} compiled to "
                             f"{sorted(got)}, declared {sorted(want)}")
        rows.append({"name": name, "kernel": decl.kernel,
                     "combines": sorted(want)})
    return rows
