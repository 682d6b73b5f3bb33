"""Grid-sweep engine demo on the PyTorch/H100 port: one base workload x a
cartesian parameter grid x two modeled devices, collected concurrently
with per-point memoization, then the base point measured.

The sweep runs the trace provider (host numpy), so its csv equals the
reference example's (``examples/grid_sweep.py``) row for row.  The last
step validates the base point against the instrumented scatter-add
kernel (K6) on ``--torch-device`` (default ``cuda``; ``cpu`` runs its
plain version): modeled and measured counters must agree exactly.
Writes results/torch/grid_sweep.csv (``REPRO_TORCH_RESULTS`` moves
results/torch/).

The same sweep is available without Python:

    PYTHONPATH=src python -m repro_torch sweep --workload indices \
        --size 2^16 2^18 --dist uniform \
        --waves-per-tile 4 8 16 32 --pipeline-depth 2 4 \
        --devices v5e v5p --jobs 8 --format csv

Run: PYTHONPATH=src python examples/torch_grid_sweep.py [--torch-device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.analysis import (InstrumentedKernelProvider,  # noqa: E402
                                  Session, WorkloadSpec, sweep_grid)
from repro_torch.analysis.sweep_cache import results_root  # noqa: E402


def base_spec() -> WorkloadSpec:
    rng = np.random.default_rng(0)
    return WorkloadSpec.from_indices(
        rng.integers(0, 256, 1 << 18), 256, label="uniform-256K")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the kernel of the last step runs "
                         "(default cuda)")
    args = ap.parse_args(argv)
    base = base_spec()
    results = sweep_grid(
        base,
        {"waves_per_tile": [4, 8, 16, 32], "pipeline_depth": [2, 4]},
        devices=("v5e", "v5p"),
        parallel=8)

    out = results_root() / "grid_sweep.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for name, result in results.items():
            print(result.render("text"))
            f.write(result.render("csv"))
    print(f"wrote per-device sweep csv to {out}")

    # the engine's point: same verdict machinery, now over a whole grid —
    # occupancy (waves_per_tile x pipeline_depth) moves utilization, and
    # the device axis shows hardware balance moving the bottleneck
    for name, result in results.items():
        peak = max(result.profiles, key=lambda p: p.scatter_utilization)
        print(f"{name}: peak scatter U={peak.scatter_utilization:.2%} "
              f"at {peak.label}")

    # the base point modeled against measured: K6 on --torch-device
    report = Session("v5e").validate(base, providers=(
        "trace", InstrumentedKernelProvider(torch_device=args.torch_device)))
    print(f"{base.label}: trace vs kernel on {args.torch_device}, max "
          f"relative error {report.max_rel_err:.2%}")
    return report


if __name__ == "__main__":
    main()
