"""Time the K1 candidates and the cost of a shared-copy flush on the card.

    python3 tools/bench_degrees.py [--out DIR]

from the root of a checkout, on a machine with an NVIDIA GPU and ``nvcc``.
Builds ``tools/degree_candidates.cu`` (ways to take a commit group's
largest duplicate count, see its header; their SASS instruction and
shuffle counts are printed, the SASS is written to
``DIR/degree_candidates.sass``) into ``build/tools/``, checks
every candidate's degrees bit for bit against ``wave_degrees_plain`` and
times each with CUDA events on streams of 4 Mi ids at the main paths'
shapes: Tool 1's designed patterns at e = 1 ... 32 (e = 1 is all distinct
in every group, e = 32 all equal), K6's uniform ids into 4096 segments,
and K3's committed streams (``hist`` and ``hist2``) of the solid and
uniform 4 Mpx x 4 images (16 Mi ids).  Then it times the flush K6's shared route pays, one global
f32 atomicAdd for each of 4096 entries from 132 and from 264 blocks.
Prints the card's name and power limit and one JSON object, which it also
writes to ``DIR/bench_degrees.json`` (default ``results/torch/bench``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

METHODS = ("match", "ballot+match", "sort", "ballot+sort", "sort (loops)",
           "pairs", "ballot+pairs", "peel+sort", "ballot, match or sort",
           "ballot, match or sort, in pairs")
REPS = 25


def build(out_dir: Path) -> tuple[ctypes.CDLL, dict]:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / "libdegree_candidates.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "degree_candidates.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bench_degrees.argtypes = [I, P, P, I, P]
    lib.bench_flush.argtypes = [P, I, I, P]
    lib.bench_degrees.restype = lib.bench_flush.restype = I
    return lib, sass_counts(out, out_dir)


def sass_counts(lib_path: Path, out_dir: Path) -> dict[str, dict[str, int]]:
    """Instructions, and shuffles among them, in each degree kernel's SASS
    (by method); the SASS itself goes to ``out_dir``."""
    import re
    import shutil
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / "degree_candidates.sass").write_text(sass)
    out, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"degree_kernelILi(\d+)E", line)
            func = METHODS[int(m.group(1))] if m else None
            if func:
                out[func] = {"instructions": 0, "SHFL": 0}
        elif func and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[func]["instructions"] += 1
            out[func]["SHFL"] += "SHFL" in line
    return out


def time_ms(fn) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def streams() -> dict[str, np.ndarray]:
    from repro_torch.core.microbench import make_pattern
    from repro_torch.data.images import make_image
    from repro_torch.kernels.histogram import ops as hist_ops
    out = {f"pattern e={e}": make_pattern(4096, e, 4096, seed=e).reshape(-1)
           for e in (1, 2, 4, 8, 16, 32)}
    out["K6 uniform 4Mi -> 4096"] = np.random.default_rng(1).integers(
        0, 4096, 1 << 22).astype(np.int32)
    for kind in ("solid", "uniform"):
        for variant in ("hist", "hist2"):
            out[f"K3 {kind} 4Mpx x 4 {variant}"] = \
                hist_ops.committed_index_stream(
                    make_image(kind, 1 << 22), variant=variant).astype(np.int32)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=Path,
                        default=ROOT / "results" / "torch" / "bench")
    out_dir = parser.parse_args().out
    out_dir.mkdir(parents=True, exist_ok=True)
    import torch

    from repro_torch.kernels import instrumentation as instr

    if not torch.cuda.is_available():
        print("bench_degrees: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lib, sass = build(out_dir)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {"card": card, "sass": sass, "degrees_ms": {}, "flush_ms": {}}
    print(f"  SASS of the degree kernels: {sass}", flush=True)
    for name, ids_np in streams().items():
        ids = torch.as_tensor(ids_np, device="cuda")
        waves = ids.numel() // instr.LANES
        want = instr.wave_degrees_plain(ids)
        deg = torch.empty(waves, dtype=torch.float32, device="cuda")
        row = {}
        for m, method in enumerate(METHODS):
            def run(m=m):
                err = lib.bench_degrees(m, ids.data_ptr(), deg.data_ptr(),
                                        waves, stream())
                if err:
                    raise RuntimeError(f"{method}: CUDA error {err}")
            deg.fill_(-1.0)
            run()
            torch.cuda.synchronize()
            if not torch.equal(deg, want):
                raise SystemExit(f"{method} on {name}: degrees differ")
            row[method] = time_ms(run)
        result["degrees_ms"][name] = row
        print(f"  {name:26s} mean degree {float(want.double().mean()):.4f} "
              + "  ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    out = torch.zeros(4096, dtype=torch.float32, device="cuda")
    for blocks in (132, 264):
        result["flush_ms"][f"{blocks} blocks x 4096 f32"] = time_ms(
            lambda: lib.bench_flush(out.data_ptr(), 4096, blocks, stream()))
    print(f"  flush {result['flush_ms']}")
    print(card)
    line = json.dumps(result)
    print(line)
    (out_dir / "bench_degrees.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
