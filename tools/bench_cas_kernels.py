"""Time K5 (``scatter_add``) and K4 (``hist_weighted``), the f32 atomic
(CAS-class) kernels, on the card.

    python3 tools/bench_cas_kernels.py [--tree PATH] [--candidates] [--routes]

on a machine with an NVIDIA GPU and ``nvcc``.  Makes its inputs with this
checkout's ``repro_torch.data``, then imports the kernels from
``PATH/src`` (default: this checkout) and builds them there, so that a
parent tree and a change can be timed in one call.  Cases, each held once
against the plain version (rtol/atol 1e-5) before it is timed:

  * K5 at d = 1, 4 Mi f32 values into 4096 segments: solid, uniform and
    skewed ids (``streams.skewed_ids``), shared route;
  * K5 at d = 8 and 64, 4 Mi f32 values, uniform ids, on the shared and on
    the global route; the MoE combine of ``chip_smoke.py`` (32,768 x 4096
    bf16 rows into 4096 tokens, the owned route);
  * K4 on the solid and uniform 4 Mpx x 4 images, ``hist`` and ``hist2``.

``--candidates`` also builds ``tools/flush_candidates.cu`` (K5's d = 1
shared route and K4 with other flushes: thread-block clusters of 2 or 4
blocks, or at most one block an SM) into ``build/tools/`` and times it on
K5's solid and uniform d = 1 cases and on K4's cases.  ``--routes`` times
each of K5's global routes on the same inputs, through the tree's C entry
point with the route given: scalar against vector tiles at d = 8 and 64,
and scalar tiles, vector tiles and owned rows on combines of 4096 tokens
with rows of 1, 2, 4 and 8 KB (f32 and bf16), once with 32,768 rows (8 a
token) and once with 256 MB of values.  Prints the card's name and power
limit and one JSON object: CUDA-event medians in ms, the number of SASS
instructions of each kernel of the two libraries, and the cases that
disagreed with their plain version (untimed; the tool then exits 1).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
IDS, SEGMENTS = 1 << 22, 4096
PX, BINS = 1 << 22, 256
WIDTHS = ((8, 1024), (8, 4096), (64, 256), (64, 1024))
COMBINE_TOKENS, EXPERTS, TOP_K, D_MODEL = 4096, 128, 8, 4096
# (name, cluster, blocks per SM) of the flush candidates
# (tools/flush_candidates.cu)
CANDIDATES = (("cluster 1, as many blocks as fit", 1, 0),
              ("cluster 1, 1 block an SM", 1, 1),
              ("cluster 2", 2, 0), ("cluster 4", 4, 0))
# K5's global routes as its C entry point numbers them
# (scatter_add/kernel.py: K5_ROUTES)
GLOBAL_ROUTES = {"scalar tiles": 0, "vector tiles": 2, "owned rows": 3}
ROW_BYTES = (1024, 2048, 4096, 8192)
COMBINE_BYTES = 32_768 * 8192  # the MoE combine's values
TOL = dict(rtol=1e-5, atol=1e-5)
REPS = 25


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


def make_inputs() -> dict:
    """Every case's numpy input, from this checkout's data module; the
    module is then forgotten, so that the tree's package can be imported."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import streams
    from repro_torch.data.images import make_image
    rng = np.random.default_rng(0)
    out = {
        "ids": {"solid": np.full(IDS, SEGMENTS // 2, np.int32),
                "uniform": rng.integers(0, SEGMENTS, IDS).astype(np.int32),
                "skewed": streams.skewed_ids(IDS, SEGMENTS, seed=1)},
        "values": rng.random((IDS, 1), np.float32),
        "images": {k: make_image(k, PX) for k in ("solid", "uniform")},
        "weights": rng.random(PX).astype(np.float32),
    }
    out["combine_ids"] = combine_ids(rng, TOP_K)
    sys.path.remove(str(ROOT / "src"))
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    return out


def combine_ids(rng, top_k: int) -> np.ndarray:
    """The token of each row of an MoE combine: each of COMBINE_TOKENS
    tokens picks top_k of EXPERTS experts (top_k <= EXPERTS), and the rows
    come expert by expert."""
    experts = rng.random((COMBINE_TOKENS, EXPERTS)).argsort(axis=1)[:, :top_k]
    order = np.argsort(experts.reshape(-1), kind="stable")
    return np.repeat(np.arange(COMBINE_TOKENS, dtype=np.int32), top_k)[order]


def sass_sizes(lib_path: Path) -> dict[str, int]:
    """SASS instructions in each kernel of a library, by mangled name."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            out[func] = 0
        elif func and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[func] += 1
    return out


def build_candidates() -> ctypes.CDLL:
    """``tools/flush_candidates.cu``, built into ``build/tools/``."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / "libflush_candidates.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "flush_candidates.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.candidate_k5.argtypes = [P, P, P, I, I, I, I, P]
    lib.candidate_k4.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
    lib.candidate_k5.restype = lib.candidate_k4.restype = I
    return lib


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", type=Path, default=ROOT)
    parser.add_argument("--candidates", action="store_true")
    parser.add_argument("--routes", action="store_true")
    args = parser.parse_args()
    tree = args.tree.resolve()
    inputs = make_inputs()
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk

    if not torch.cuda.is_available():
        print("bench_cas_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    result = {"card": card, "tree": str(args.tree), "ms": {}, "sass": {}}
    for lib in ("scatter_add", "histogram"):
        result["sass"].update(sass_sizes(_build.library_path(lib)))

    failures = result["failures"] = []

    def record(case, fn, plain, table=result["ms"]):
        """Times fn when it agrees with its plain version; a case that
        disagrees is listed in failures, untimed, and the tool exits 1."""
        try:
            torch.testing.assert_close(fn(), plain, **TOL, msg=case)
        except AssertionError as err:
            failures.append(str(err))
            print(f"  {case}: DISAGREES\n{err}", flush=True)
            return
        table[case] = time_ms(fn)
        print(f"  {case}: {table[case]:.4f} ms", flush=True)

    dev = "cuda"
    k5 = {}
    vals = torch.as_tensor(inputs["values"], device=dev)
    for kind, ids_np in inputs["ids"].items():
        ids = torch.as_tensor(ids_np, device=dev)
        k5[kind] = (vals, ids, sk.scatter_add_plain(vals, ids, SEGMENTS))
        record(f"K5 {kind} {IDS} x 1 f32 -> {SEGMENTS}",
               lambda: sk.scatter_add_launch(vals, ids, SEGMENTS), k5[kind][2])
    rng = np.random.default_rng(1)
    for d, segments in WIDTHS:
        n = IDS // d
        ids = torch.as_tensor(rng.integers(0, segments, n).astype(np.int32),
                              device=dev)
        wide = torch.as_tensor(rng.random((n, d), np.float32), device=dev)
        record(f"K5 uniform {n} x {d} f32 -> {segments} "
               f"({sk.scatter_route(segments, d)})",
               lambda: sk.scatter_add_launch(wide, ids, segments),
               sk.scatter_add_plain(wide, ids, segments))
    del wide
    ids = torch.as_tensor(inputs["combine_ids"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    moe = torch.randn((ids.numel(), D_MODEL), generator=gen, device=dev,
                      dtype=torch.float32).to(torch.bfloat16)
    record(f"K5 MoE combine {tuple(moe.shape)} bf16 -> {COMBINE_TOKENS}",
           lambda: sk.scatter_add_launch(moe, ids, COMBINE_TOKENS),
           sk.scatter_add_plain(moe, ids, COMBINE_TOKENS))
    del moe
    w = torch.as_tensor(inputs["weights"], device=dev)
    k4 = {}
    for kind, img_np in inputs["images"].items():
        img = torch.as_tensor(img_np, device=dev)
        k4[kind] = (img, hk.histogram_weighted_plain(img, w, BINS))
        for variant, reorder in (("hist", False), ("hist2", True)):
            record(f"K4 {kind} {PX} x 4 {variant}",
                   lambda: hk.histogram_launch(img, reorder=reorder,
                                               weights=w), k4[kind][1])

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if args.candidates:
        result["candidates_ms"] = {}
        lib = build_candidates()

        def run_k5(cluster, per_sm, vals, ids):
            out = torch.zeros((SEGMENTS, 1), device=dev)
            _build.raise_on_error(lib.candidate_k5(
                vals.data_ptr(), ids.data_ptr(), out.data_ptr(), IDS,
                SEGMENTS, cluster, per_sm, stream()), "candidate_k5")
            return out

        def run_k4(cluster, per_sm, img, reorder):
            out = torch.zeros((4, BINS), device=dev)
            _build.raise_on_error(lib.candidate_k4(
                img.data_ptr(), w.data_ptr(), out.data_ptr(), PX, 4, BINS,
                hk.DEFAULT_TILE, reorder, cluster, per_sm, stream()),
                "candidate_k4")
            return out

        for name, cluster, per_sm in CANDIDATES:
            table = result["candidates_ms"].setdefault(name, {})
            for kind in ("solid", "uniform"):
                vals, ids, plain = k5[kind]
                record(f"{name}: K5 {kind} x 1", functools.partial(
                    run_k5, cluster, per_sm, vals, ids), plain, table)
                img, plain = k4[kind]
                for variant, reorder in (("hist", 0), ("hist2", 1)):
                    record(f"{name}: K4 {kind} {variant}", functools.partial(
                        run_k4, cluster, per_sm, img, reorder), plain, table)

    if args.routes:
        result["routes_ms"] = {}
        entry = sk._lib().repro_scatter_add

        def run_route(route, vals, ids, segments):
            out = torch.zeros((segments, vals.shape[1]), device=dev)
            _build.raise_on_error(entry(
                vals.data_ptr(), ids.data_ptr(), out.data_ptr(),
                vals.shape[0], vals.shape[1], segments,
                sk.VALUE_DTYPES[vals.dtype], route, stream()), "scatter_add")
            return out

        def time_routes(case, vals, ids, segments, routes):
            plain = sk.scatter_add_plain(vals, ids, segments)
            for name in routes:
                record(f"{case}: {name}", functools.partial(
                    run_route, GLOBAL_ROUTES[name], vals, ids, segments),
                    plain, result["routes_ms"])

        rng = np.random.default_rng(2)
        for d, segments in WIDTHS:
            if sk.scatter_route(segments, d) != "global":
                continue
            n = IDS // d
            ids = torch.as_tensor(
                rng.integers(0, segments, n).astype(np.int32), device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                vals = torch.as_tensor(rng.random((n, d), np.float32),
                                       device=dev).to(dtype)
                time_routes(f"uniform {n} x {d} {dtype} -> {segments}", vals,
                            ids, segments, ("scalar tiles", "vector tiles"))
        for row_bytes in ROW_BYTES:
            for dtype in (torch.float32, torch.bfloat16):
                d = row_bytes // dtype.itemsize
                for top_k in sorted({TOP_K, COMBINE_BYTES // row_bytes
                                     // COMBINE_TOKENS}):
                    ids = torch.as_tensor(combine_ids(rng, top_k), device=dev)
                    gen = torch.Generator(device=dev).manual_seed(top_k)
                    vals = torch.randn((ids.numel(), d), generator=gen,
                                       device=dev).to(dtype)
                    time_routes(f"combine {ids.numel()} x {d} {dtype} "
                                f"({row_bytes} B rows) -> {COMBINE_TOKENS}",
                                vals, ids, COMBINE_TOKENS, GLOBAL_ROUTES)
                    del vals
    print(card)
    print(json.dumps(result))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
