"""Full paper-§4 case study on the PyTorch/H100 port: both kernels x both
image kinds x sizes 32px..4Mpx x launch-occupancy settings, utilization +
speedup + bottleneck-shift detection.  Writes results/torch/casestudy.csv
(``REPRO_TORCH_RESULTS`` moves results/torch/).

Uses the ``repro_torch.analysis`` session API: a derived device carries
the case-study cache emulation; the instrumented histogram kernel runs
once per (kind, variant, size) on ``--torch-device`` and its trace is
re-geometried per occupancy point via frozen ``WorkloadSpec``s.

Run: PYTHONPATH=src python examples/torch_histogram_casestudy.py \
        [--fast] [--torch-device cpu]

The headline hist-vs-hist2 comparison (same LLC emulation, same Session
numbers) is also available without Python:

    PYTHONPATH=src python -m repro_torch compare --device v5e
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis import (Session, WorkloadSpec,  # noqa: E402
                                  get_device)
from repro_torch.analysis.sweep_cache import results_root  # noqa: E402
from repro_torch.core import bottleneck  # noqa: E402
from repro_torch.core.profiler import CacheModel  # noqa: E402
from repro_torch.data.images import make_image  # noqa: E402
from repro_torch.kernels.histogram import ops  # noqa: E402

HEADER = "kind,variant,pixels,waves_per_tile,e,utilization,bottleneck"


def case_study_session() -> Session:
    """The case study's device: v5e with the LLC emulation."""
    device = get_device("v5e").with_(
        cache=CacheModel(llc_bytes=1 << 21, miss_latency_cycles=800,
                         hide_concurrency=48))
    return Session(device)


def casestudy_rows(sess, sizes, waves_opts, torch_device):
    """(csv rows without the header, the shift-study profiles)."""
    rows = []
    shift_profiles = []
    for kind in ("solid", "uniform"):
        for variant in ("hist", "hist2"):
            for n in sizes:
                img = make_image(kind, n)
                # run the instrumented kernel once; re-geometry the trace
                # per occupancy point instead of re-running it
                _, tr = ops.histogram_instrumented(
                    img, variant=variant, force_fao=True,
                    torch_device=torch_device)
                for wpt in waves_opts:
                    spec = WorkloadSpec.from_trace(
                        tr, label=f"{kind}/{variant}/{n}/{wpt}",
                        waves_per_tile=wpt, bytes_read=float(n * 4))
                    prof = sess.profile(spec)
                    rows.append(
                        f"{kind},{variant},{n},{wpt},"
                        f"{prof.e:.2f},"
                        f"{prof.scatter_utilization:.4f},{prof.bottleneck}")
                    if kind == "uniform" and variant == "hist" and wpt == 8:
                        shift_profiles.append(prof)
    return rows, shift_profiles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the instrumented kernel runs (default cuda)")
    args = ap.parse_args(argv)
    sess = case_study_session()
    sizes = [2 ** p for p in range(5, 23, 3 if args.fast else 1)]
    waves_opts = [8, 32] if args.fast else [4, 8, 16, 32]

    rows, shift_profiles = casestudy_rows(sess, sizes, waves_opts,
                                          args.torch_device)
    out = results_root() / "casestudy.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join([HEADER] + rows) + "\n")
    print(f"wrote {len(rows)} rows to {out}")

    # headline numbers (mirror the paper's narrative)
    def util(kind, variant, n, wpt=32):
        for r in rows:
            k, v, px, w, e, u, b = r.split(",")
            if (k, v, int(px), int(w)) == (kind, variant, n, wpt):
                return float(u), b
        raise KeyError

    big = sizes[-1]
    u_solid, _ = util("solid", "hist", big)
    u_uni, _ = util("uniform", "hist", big)
    u_solid2, _ = util("solid", "hist2", big)
    print(f"large solid: U={u_solid:.2f} (paper: ~1.0); "
          f"large uniform: U={u_uni:.2f} (paper: ~0.76)")
    print(f"reorder on solid: U {u_solid:.2f} -> {u_solid2:.2f}")
    # the profiles are already computed: detect shifts on them directly
    # instead of re-profiling via sess.sweep
    for s in bottleneck.detect_shifts(shift_profiles):
        print(f"bottleneck shift at sweep idx {s.index}: "
              f"{s.unit_before} -> {s.unit_after} "
              f"({s.label_before} -> {s.label_after})")


if __name__ == "__main__":
    main()
