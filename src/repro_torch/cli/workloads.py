"""Declarative workload construction for the command line.

Translates parsed CLI arguments into the ``WorkloadSpec``s the Session
API consumes — synthetic index streams, image histograms (``--variant
hist|hist2``), scatter-adds, and HLO text files — plus the grid axes
the sweep engine expands.  Everything here is argument plumbing; the
specs themselves are ordinary ``repro_torch.analysis.WorkloadSpec``s, so
a CLI run is bit-identical to the equivalent Python session.
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.workload import WorkloadSpec
from repro_torch.data.images import make_image

WORKLOADS = ("indices", "histogram", "scatter", "hlo")


def parse_int(text: str) -> int:
    """Integer with ``2^k`` power notation (sizes read like the paper)."""
    text = text.strip()
    if "^" in text:
        base, exp = text.split("^", 1)
        return int(base) ** int(exp)
    return int(text)


def make_indices(dist: str, size: int, num_bins: int,
                 seed: int) -> np.ndarray:
    """Synthetic scatter-destination stream (the paper's two extremes)."""
    if dist == "solid":
        return np.zeros(size, np.int64)       # maximum contention, e -> 32
    if dist == "uniform":
        rng = np.random.default_rng(seed)
        return rng.integers(0, num_bins, size)  # low contention, e ~ 2-3
    raise ValueError(f"unknown distribution {dist!r}")


def _spec_kwargs(args) -> dict:
    """Roofline/geometry overrides shared by every workload family."""
    kw = {"num_cores": args.num_cores,
          "overhead_cycles": args.overhead_cycles}
    if args.bytes_read is not None:
        kw["bytes_read"] = args.bytes_read
    if args.flops is not None:
        kw["flops"] = args.flops
    return kw


def _as_list(value, default):
    """Single-value commands store scalars, sweeps store lists."""
    if value is None:
        return list(default)
    return list(value) if isinstance(value, (list, tuple)) else [value]


def _labeler(base: str, values: list):
    """Per-point labels: a user-supplied base label must stay unique
    across a multi-value size axis, or sweep rows and shift events become
    indistinguishable ("foo -> foo")."""
    multi = base is not None and len(values) > 1

    def label(value, default: str) -> str:
        if base is None:
            return default
        return f"{base}-{value}" if multi else base
    return label


def build_specs(args) -> tuple[list[WorkloadSpec], dict]:
    """(base specs, grid axes) from parsed workload arguments.

    One base spec per size/pixel value (stream *content* is not a spec
    field, so it cannot be a ``grid`` axis); launch geometry provided as
    lists becomes the grid axes that ``WorkloadSpec.grid`` expands.
    """
    specs: list[WorkloadSpec] = []
    if args.workload == "indices":
        sizes = _as_list(args.size, [1 << 16])
        label = _labeler(args.label, sizes)
        for size in sizes:
            idx = make_indices(args.dist, size, args.num_bins, args.seed)
            specs.append(WorkloadSpec.from_indices(
                idx, args.num_bins,
                label=label(size, f"{args.dist}-{size}"),
                **_spec_kwargs(args)))
    elif args.workload == "histogram":
        pixels = _as_list(args.pixels, [1 << 16])
        label = _labeler(args.label, pixels)
        for px in pixels:
            img = make_image(args.dist, px, seed=args.seed)
            specs.append(WorkloadSpec.from_histogram(
                img, label=label(px, f"{args.dist}-{args.variant}-{px}px"),
                variant=args.variant, num_bins=args.num_bins,
                **_spec_kwargs(args)))
    elif args.workload == "scatter":
        sizes = _as_list(args.size, [1 << 16])
        label = _labeler(args.label, sizes)
        for size in sizes:
            ids = make_indices(args.dist, size, args.num_segments, args.seed)
            values = np.ones(size, np.float32)
            specs.append(WorkloadSpec.from_scatter_add(
                ids, values, args.num_segments,
                label=label(size, f"{args.dist}-scatter-{size}"),
                **_spec_kwargs(args)))
    elif args.workload == "hlo":
        if not args.hlo_file:
            raise ValueError("--workload hlo needs --hlo-file PATH")
        with open(args.hlo_file) as f:
            text = f.read()
        label = args.label or f"hlo-{args.hlo_file}"
        specs.append(WorkloadSpec.from_compiled(
            hlo_text=text, label=label, num_devices=args.num_devices,
            **_spec_kwargs(args)))
    else:
        raise ValueError(f"unknown workload {args.workload!r}")

    axes: dict = {}
    wpt = getattr(args, "waves_per_tile", None)
    depth = getattr(args, "pipeline_depth", None)
    if isinstance(wpt, (list, tuple)):
        axes["waves_per_tile"] = [int(v) for v in wpt]
    elif wpt is not None:
        specs = [s.with_(waves_per_tile=int(wpt)) for s in specs]
    if isinstance(depth, (list, tuple)):
        axes["pipeline_depth"] = [int(v) for v in depth]
    elif depth is not None:
        specs = [s.with_(pipeline_depth=int(depth)) for s in specs]
    return specs, axes


def expand_grid(specs: list[WorkloadSpec],
                axes: dict) -> list[WorkloadSpec]:
    """Cartesian product of base specs with the geometry axes."""
    if not axes:
        return specs
    out: list[WorkloadSpec] = []
    for spec in specs:
        out.extend(spec.grid(**axes))
    return out
