"""The §5 hist-vs-hist2 skew difference as two contention heat maps, on
the PyTorch/H100 port.

The paper's utilization model says *that* the naive ``hist`` kernel
saturates the scatter unit on contended (solid-color) images and that
``hist2``'s per-lane channel rotation relieves it; the heat map shows
*where*.  Both variants commit exactly the same multiset of bin updates
(identical per-bin hit counts — rotation only reshuffles commit
groups), so the separating signal is serialized *replays*: updates that
queued behind an earlier hit to the same bin within one commit group.

This example renders both heat maps side by side and checks the §5
localization story end to end:

  * ``hist`` concentrates: each commit group is 32 lanes of one channel
    hitting one bin, so the hottest bin serializes 31/32 of its hits
    (top-bin share 31/128 of the whole stream, max wave degree 32);
  * ``hist2`` disperses: a rotated commit group spreads over all 4
    channel bins, the worst wave degree drops to 8 and the top-bin
    share falls strictly below ``hist``'s;
  * per-bin totals stay consistent with the profile path: the heat
    map's embedded ``CounterSet`` is bitwise-equal to what the trace
    provider collects for the same spec, its counters equal the ones
    the instrumented CUDA kernel measures on ``--torch-device``, and the
    per-bin hits sum to the committed stream length exactly.

Run: PYTHONPATH=src python examples/torch_heatmap_histogram.py \
        [--torch-device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.analysis import (InstrumentedKernelProvider,  # noqa: E402
                                  Session, WorkloadSpec)
from repro_torch.core.counters import bitwise_equal  # noqa: E402
from repro_torch.data.images import make_image  # noqa: E402

# The paper's contended setting: solid images, every lane of a naive
# commit group hits the same bin (e = 32).
PIXELS = 1 << 16
WAVES_PER_TILE = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the instrumented kernel runs "
                         "(default cuda)")
    args = ap.parse_args(argv)
    kernel = InstrumentedKernelProvider(torch_device=args.torch_device)
    sess = Session("v5e")
    img = make_image("solid", PIXELS)
    maps = {}
    for variant in ("hist", "hist2"):
        spec = WorkloadSpec.from_histogram(
            img, label=f"solid-{PIXELS}px-{variant}", variant=variant,
            waves_per_tile=WAVES_PER_TILE)
        hm = maps[variant] = sess.heatmap(spec)
        print(hm.render("text", top_k=8))
        print()

        # bit-consistency with the profile path: same stream, same
        # degree kernels, same aggregation -> identical counters
        if not bitwise_equal(hm.counters, sess.collect(spec)):
            print(f"FAIL {variant}: heat-map counters diverge from "
                  f"the provider's collect()")
            return 1
        if not bitwise_equal(hm.counters, sess.collect(spec, kernel),
                             ignore=("source", "meta")):
            print(f"FAIL {variant}: heat-map counters diverge from the "
                  f"instrumented kernel's on {args.torch_device}")
            return 1
        if int(hm.hits.sum()) != PIXELS * img.shape[1]:
            print(f"FAIL {variant}: per-bin hits sum to "
                  f"{int(hm.hits.sum())}, expected the committed stream "
                  f"length {PIXELS * img.shape[1]}")
            return 1

    hist, hist2 = maps["hist"], maps["hist2"]
    if hist.hits.sum() != hist2.hits.sum() \
            or not np.array_equal(hist.bins, hist2.bins) \
            or not np.array_equal(hist.hits, hist2.hits):
        print("FAIL: rotation changed per-bin hit totals — it must only "
              "reshuffle commit groups")
        return 1
    if not (hist.peak_degree > hist2.peak_degree):
        print(f"FAIL: expected hist wave degree ({hist.peak_degree}) "
              f"above hist2 ({hist2.peak_degree})")
        return 1
    if not (hist2.top_bin_share < hist.top_bin_share):
        print(f"FAIL: hist2 top-bin share {hist2.top_bin_share:.4f} not "
              f"strictly below hist {hist.top_bin_share:.4f}")
        return 1
    if len(hist.hot_bins) < 1:
        print("FAIL: contended hist run surfaced no hot bins")
        return 1

    print(f"hist  top-bin share {100 * hist.top_bin_share:.1f}% "
          f"(peak wave degree {hist.peak_degree:.0f})")
    print(f"hist2 top-bin share {100 * hist2.top_bin_share:.1f}% "
          f"(peak wave degree {hist2.peak_degree:.0f})")
    print("OK: hist2's rotation disperses the hot bins hist localizes; "
          "counters bit-identical to the profile path and the kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
