"""Registered lint targets: the port's CUDA kernels with probe inputs.

Each entry builds a :class:`~repro_torch.lint.analysis.LintTarget`: the
launch as its launcher declares it, its operands in ref order, and
(where the workload layer models it) a probe :class:`WorkloadSpec`
whose geometry mirrors the paper's §5 study
(``examples/torch_advisor_histogram.py``: solid 2^15-px image, 8 waves
per tile, 2500-cycle overhead) — so a KERN001 finding's ``--advise`` run
lands in the paper's up-to-30% rotation band.  The probes are the
reference's (``repro/lint/registry.py``), so the two lints' reports
compare.

Probes are deterministic (fixed rng seed): lint output is reproducible
run to run, like the audit's synthesized streams.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

PROBE_PIXELS = 1 << 15
PROBE_WAVES_PER_TILE = 8
PROBE_OVERHEAD_CYCLES = 2500.0
_SEED = 0


def hist_probe_spec(variant: str, kind: str = "solid", *,
                    weighted: bool = False):
    """The histogram probe: a 2^15-px ``kind`` image at the paper's §5
    geometry."""
    from repro_torch.analysis.workload import WorkloadSpec
    from repro_torch.data.images import make_image

    label = (f"{variant}-weighted-{kind}" if weighted
             else f"{variant}-{kind}")
    return WorkloadSpec.from_histogram(
        make_image(kind, PROBE_PIXELS, seed=_SEED), label=label,
        variant=variant, weighted=weighted,
        waves_per_tile=PROBE_WAVES_PER_TILE,
        overhead_cycles=PROBE_OVERHEAD_CYCLES)


def _hist_target(variant: str, weighted: bool = False):
    from repro_torch.lint.analysis import target_from_spec

    return target_from_spec(hist_probe_spec(variant, weighted=weighted))


def _scatter_add_target():
    from repro_torch.analysis.workload import WorkloadSpec
    from repro_torch.lint.analysis import target_from_spec

    rng = np.random.default_rng(_SEED)
    n, d, segs = 8192, 32, 4096
    ids = rng.integers(0, segs, size=n).astype(np.int32)
    values = np.ones((n, d), np.float32)
    spec = WorkloadSpec.from_scatter_add(
        ids, values, segs, label="scatter_add-uniform")
    return target_from_spec(spec)


def _moe_dispatch_target():
    from repro_torch.analysis.workload import WorkloadSpec
    from repro_torch.core import timing
    from repro_torch.kernels.scatter_add import kernel as scat_kernel
    from repro_torch.kernels.scatter_add import ops as scat_ops
    from repro_torch.lint.analysis import LintTarget

    rng = np.random.default_rng(_SEED)
    n, experts = 8192, 64
    ids = rng.integers(0, experts, size=n).astype(np.int32)
    spec = WorkloadSpec.from_scatter_add(
        ids, np.zeros((n, 1), np.float32), experts,
        label="moe_dispatch-uniform", job_class=timing.POPC)
    return LintTarget(
        label="moe_dispatch-uniform",
        decl=scat_kernel.bincount_lint_declaration(n, experts),
        operands=(ids,), spec=spec, module=scat_kernel,
        job_class=timing.POPC,
        waves_per_tile=scat_ops.default_waves_per_tile())


def _flash_attention_target():
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.lint.analysis import LintTarget

    # the reference's probe, (H, T, d) = (4, 1024, 64) f32, with a batch
    return LintTarget(
        label="flash_attention",
        decl=flash_kernel.lint_declaration(1, 4, 1024, 64),
        operands=(None, None, None), spec=None, module=flash_kernel,
        job_class=None, waves_per_tile=None)


KERNELS: dict[str, Callable] = {
    "hist": lambda: _hist_target("hist"),
    "hist2": lambda: _hist_target("hist2"),
    "hist_weighted": lambda: _hist_target("hist", weighted=True),
    "scatter_add": _scatter_add_target,
    "moe_dispatch": _moe_dispatch_target,
    "flash_attention": _flash_attention_target,
}


def names() -> list[str]:
    return list(KERNELS)


def build_target(name: str):
    try:
        build = KERNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown lint kernel {name!r} (registered: "
            f"{', '.join(KERNELS)})") from None
    return build()
