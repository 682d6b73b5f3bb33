"""Quickstart on the PyTorch/H100 port: the paper's two tools in five lines.

1. ``Session(device="v5e")`` — Tool 1: resolves the once-per-chip
   service-time table S(n, e, c) of the modeled device (built on first
   ever use, then loaded from the ``.npz`` cache under
   results/torch/tables/).
2. ``WorkloadSpec.from_histogram(...)`` — describe an instrumented
   histogram launch declaratively.
3. ``sess.profile(spec)`` / ``sess.classify(spec)`` — Tool 2: per-core
   utilization + the bottleneck verdict.
4. ``sess.validate(spec)`` — the paper's §5 check: the modeled counter
   path ("trace" provider) against the measured one (the instrumented
   CUDA kernel on ``--torch-device``, counters read back from the launch).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--torch-device cpu]

``--torch-device`` (default ``cuda``) is where the kernels run; ``cpu``
runs their plain versions.  The same tour without Python:

    python -m repro_torch validate --workload histogram --dist solid \
        --pixels 2^14 --torch-device cpu
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.analysis import (InstrumentedKernelProvider,  # noqa: E402
                                  Session, WorkloadSpec)
from repro_torch.data.images import make_image  # noqa: E402
from repro_torch.kernels.histogram import ops  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the kernels run (default cuda)")
    args = ap.parse_args(argv)
    dev = args.torch_device

    sess = Session(device="v5e")
    table = sess.table
    print(f"service-time table [{sess.device.name}]: "
          f"n<={int(table.n_grid[-1])}, e<={int(table.e_grid[-1])}, "
          f"S range {float(table.service_time(64, 1, 0)):.1f}.."
          f"{float(table.service_time(1, 32, 1)):.1f} cycles\n")

    # The paper §4's two extremes: solid (fully serialized) vs uniform.
    for kind in ("solid", "uniform"):
        img = make_image(kind, 1 << 18)
        # kernel-correctness smoke: every pixel's 4 channels land
        # somewhere, in the counting kernel and in the weighted one
        assert int(ops.histogram(img, torch_device=dev).sum()) \
            == img.shape[0] * 4
        assert float(ops.histogram_weighted(
            img, np.ones(img.shape[0], np.float32),
            torch_device=dev).sum()) == img.shape[0] * 4
        spec = WorkloadSpec.from_histogram(
            img, label=f"{kind} 256Kpx", force_fao=True, waves_per_tile=32)
        prof = sess.profile(spec)
        print(prof.render())
        verdict = sess.last.verdicts[0]
        print(f"verdict: {verdict.bottleneck} ({verdict.utilization:.0%}) — "
              f"{verdict.comment}\n")

    # The fix the model recommends for the solid case: channel reorder
    # (the paper's hist2 kernel).  One sweep call gives both profiles,
    # the per-point verdicts, and the predicted speedup.
    img = make_image("solid", 1 << 18)
    specs = [WorkloadSpec.from_histogram(img, label=v, variant=v,
                                         force_fao=True, waves_per_tile=32)
             for v in ("hist", "hist2")]
    result = sess.sweep(specs)
    e0 = result.profiles[0].e
    e1 = result.profiles[1].e
    print(f"channel reorder on solid: e {e0:.0f} -> {e1:.0f}, "
          f"predicted speedup {float(result.speedup_vs_first[1]):.2f}x "
          f"(paper: ~30% on large monochrome images)")
    print()
    print(sess.report())

    # Model vs measured (paper §5): the "trace" provider synthesizes the
    # committed index stream on the host; the kernel provider runs the
    # instrumented kernel on ``dev`` and reads the counters back.  They
    # must agree exactly.
    small = make_image("solid", 1 << 14)
    spec = WorkloadSpec.from_histogram(small, label="solid 16Kpx",
                                       force_fao=True, waves_per_tile=32)
    print(sess.validate(spec, providers=(
        "trace", InstrumentedKernelProvider(torch_device=dev))).render())


if __name__ == "__main__":
    main()
