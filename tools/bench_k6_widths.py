"""Time K6 (``scatter_add_instrumented``) at row widths d = 1, 8 and 64.

    python3 tools/bench_k6_widths.py [--tree PATH]

on a machine with an NVIDIA GPU and ``nvcc``.  Imports ``repro_torch``
from ``PATH/src`` (default: this checkout), so that two trees can be
timed in one call, and builds its kernels there.  Each case holds 4 Mi
f32 values (4 Mi / d rows) with uniform ids, on the shared route and on
the global one.  Prints the card's name and power limit and one JSON
object of CUDA-event medians in ms.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

CASES = ((1, 4096), (8, 1024), (8, 4096), (64, 256), (64, 1024))
VALUES = 1 << 22


def time_ms(fn, reps: int = 25) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", type=Path,
                        default=Path(__file__).resolve().parents[1])
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.kernels.scatter_add import ops

    if not torch.cuda.is_available():
        print("bench_k6_widths: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    result = {"card": card, "tree": str(args.tree), "ms": {}}
    for d, segments in CASES:
        n = VALUES // d
        ids_np = rng.integers(0, segments, n).astype(np.int32)
        ids = torch.as_tensor(ops.committed_id_stream(ids_np, segments),
                              device="cuda")
        vals = torch.as_tensor(rng.random((n, d), np.float32), device="cuda")
        case = f"{n} x {d} -> {segments} ({sk.scatter_route(segments, d)})"
        result["ms"][case] = time_ms(
            lambda: sk.scatter_add_instrumented_launch(vals, ids, segments))
        print(f"  {case}: {result['ms'][case]:.4f} ms", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
