"""Time K7 (``bincount``) on the card, warm and cold.

    python3 tools/bench_bincount.py [--tree PATH] [--candidates]

on a machine with an NVIDIA GPU and ``nvcc``.  Makes its inputs with this
checkout's ``repro_torch.data``, then imports the kernels from
``PATH/src`` (default: this checkout) and builds them there, so that a
parent tree and a change can be timed in one call.  Each case goes
through the tree's ``bincount_launch`` (the output's allocation
included), is held once bit for bit against ``bincount_plain`` and is
then timed:

  * 4 Mi ids into 8192 bins: uniform (as ``chip_smoke.py`` draws them),
    solid (one bin) and skewed (``streams.skewed_ids``); 4 Mi uniform ids
    into 1024 bins;
  * the MoE dispatch of ``benchmarks/run.py``, 65,536 ids into 128
    experts, balanced and collapsed, and a decode step's 32 ids.

"Warm" times the call as it follows itself; "cold" writes a 128 MB
buffer on the stream before the sleep that precedes the start event, so
that the ids come from device memory.  Also timed: an empty kernel launch
(``torch.cuda._sleep(0)``), the floor of a launch-bound row.

``--candidates`` also builds ``tools/bincount_candidates.cu`` into
``build/tools/`` and times each of its candidates on the same cases: the
grid route with clusters of 1, 2, 4 and 8, one or two blocks an SM,
scalar loads or 1 to 8 16-byte loads in flight, the flush rotated or in
64-bit pairs, the output zeroed by a memset, the words strided over the
grid or in a contiguous range a block, the output zeroed by a kernel that
the counting overlaps (programmatic dependent launch); the cooperative
two-phase launch; one cluster of 1 to 8 blocks that stores every count,
with 1, 4 or 32 shared copies a block, and one block with 8 loads in
flight.
Then the tree's two routes forced through its C entry points on uniform
streams of 4 Ki to 1 Mi ids (where the route changes), and the rate of
L2's int32 atomic adds.  Prints the card's name and power limit and one
JSON object of CUDA-event medians in ms; exits 1 after it if a case
disagreed with ``bincount_plain`` (untimed).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
IDS = 1 << 22
DISPATCH, EXPERTS, DECODE = 1 << 16, 128, 32
COLD_BYTES = 128 << 20
REPS = 25
# the grid-route candidates: (name, cluster, blocks an SM, 16-byte loads in
# flight (0: scalar ids), flush (0 plain, 1 rotated, 2 64-bit pairs),
# least words (ids: scalar or ranges) a thread, out zeroed by
# cudaMemsetAsync, each block a contiguous range of words)
GRID = (("grid, 2 blocks an SM", 1, 2, 4, 0, 4, 0, 0),
        ("grid, 1 block an SM", 1, 1, 4, 0, 4, 0, 0),
        ("grid, clusters of 2", 2, 1, 4, 0, 4, 0, 0),
        ("grid, clusters of 4", 4, 1, 4, 0, 4, 0, 0),
        ("grid, clusters of 8", 8, 1, 4, 0, 4, 0, 0),
        ("grid, 1 block an SM, 8 loads", 1, 1, 8, 0, 8, 0, 0),
        ("grid, 1 block an SM, rotated", 1, 1, 4, 1, 4, 0, 0),
        ("grid, 1 block an SM, a word a thread", 1, 1, 4, 0, 1, 0, 0),
        ("grid, 1 block an SM, 1 load, a word a thread", 1, 1, 1, 0, 1, 0, 0),
        ("grid, 1 block an SM, 2 loads, a word a thread",
         1, 1, 2, 0, 1, 0, 0),
        ("grid, 1 block an SM, scalar, an id a thread", 1, 1, 0, 0, 1, 0, 0),
        ("grid, 2 blocks an SM, scalar, an id a thread", 1, 2, 0, 0, 1, 0, 0),
        ("grid, 1 block an SM, a word a thread, pairs", 1, 1, 4, 2, 1, 0, 0),
        ("grid, 1 block an SM, a word a thread, memset", 1, 1, 4, 0, 1, 1, 0),
        ("grid, 1 block an SM, ranges, 1 load, an id a thread",
         1, 1, 1, 0, 1, 0, 1),
        ("grid, 1 block an SM, ranges, 2 loads, an id a thread",
         1, 1, 2, 0, 1, 0, 1),
        ("grid, 1 block an SM, ranges, 4 loads, an id a thread",
         1, 1, 4, 0, 1, 0, 1),
        ("grid, 2 blocks an SM, ranges, 2 loads, an id a thread",
         1, 2, 2, 0, 1, 0, 1),
        ("grid, ranges, 2 loads, memset, 103 blocks on 4 Mi ids",
         1, 1, 2, 0, 40, 1, 1),
        ("grid, ranges, 2 loads, memset, 66 blocks on 4 Mi ids",
         1, 1, 2, 0, 62, 1, 1))
# the output zeroed by a kernel the counting overlaps: (name, carveout)
# (the attribute of 1 stays set on the functions, so 1 runs last)
PDL = (("grid, zeroed by a dependent launch", 0),
       ("grid, zeroed by a dependent launch, one shared size", 2),
       ("grid, zeroed by a dependent launch, largest carveout", 1))
COOPERATIVE = (("cooperative, 1 block an SM", 1),
               ("cooperative, 2 blocks an SM", 2))
# one cluster that stores: (name, cluster, loads, most copies a block)
ONE = tuple((f"one cluster of {c}, {k} copies", c, 4, k)
            for c in (1, 2, 4, 8) for k in (1, 4, 32)) + (
    ("one block, 8 loads", 1, 8, 1),)
ROUTE_IDS = (1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 20)
RED_REDS = 64  # global atomic adds a thread


def make_cases() -> dict[str, tuple[np.ndarray, int]]:
    """Every case's ids and bins, from this checkout's data module; the
    module is then forgotten, so that the tree's package can be imported."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import streams
    rng = np.random.default_rng(0)  # benchmarks/run.py's dispatch draw
    cases = {
        "uniform 4Mi -> 8192": (np.random.default_rng(1).integers(
            0, 8192, IDS).astype(np.int32), 8192),
        "solid 4Mi -> 8192": (np.full(IDS, 4096, np.int32), 8192),
        "skewed 4Mi -> 8192": (streams.skewed_ids(IDS, 8192, seed=1), 8192),
        "uniform 4Mi -> 1024": (np.random.default_rng(1).integers(
            0, 1024, IDS).astype(np.int32), 1024),
        "dispatch balanced 64Ki -> 128": (
            rng.integers(0, EXPERTS, DISPATCH).astype(np.int32), EXPERTS),
        "dispatch collapsed 64Ki -> 128": (np.zeros(DISPATCH, np.int32),
                                           EXPERTS),
        "decode 32 -> 128": (np.random.default_rng(7).integers(
            0, EXPERTS, DECODE).astype(np.int32), EXPERTS),
    }
    sys.path.remove(str(ROOT / "src"))
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    return cases


def sass_sizes(lib_path: Path, pattern: str) -> dict[str, int]:
    """SASS instructions of each kernel whose mangled name matches."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            func = func if re.search(pattern, func) else None
            if func:
                out[func] = 0
        elif func and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[func] += 1
    return out


def build_candidates() -> ctypes.CDLL:
    """``tools/bincount_candidates.cu``, built into ``build/tools/``."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / "libbincount_candidates.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "bincount_candidates.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.candidate_grid.argtypes = [P, P, I, I, I, I, I, I, I, I, I, P]
    lib.candidate_one.argtypes = [P, P, I, I, I, I, I, P]
    lib.candidate_cooperative.argtypes = [P, P, P, I, I, I,
                                          ctypes.POINTER(I), P]
    lib.candidate_red.argtypes = [P, I, I, P]
    lib.candidate_pdl.argtypes = [P, P, I, I, I, P]
    for fn in (lib.candidate_grid, lib.candidate_one,
               lib.candidate_cooperative, lib.candidate_red,
               lib.candidate_pdl):
        fn.restype = I
    return lib


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", type=Path, default=ROOT)
    parser.add_argument("--candidates", action="store_true")
    args = parser.parse_args()
    tree = args.tree.resolve()
    cases = make_cases()
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.scatter_add import kernel as sk

    if not torch.cuda.is_available():
        print("bench_bincount: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    dev = "cuda"
    evict = torch.empty(COLD_BYTES // 4, dtype=torch.int32, device=dev)

    def time_ms(fn, cold: bool) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for rep in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if cold:
                evict.fill_(rep)
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    result = {"card": card, "tree": str(args.tree),
              "sass": sass_sizes(_build.library_path("scatter_add"),
                                 "bincount"),
              "empty_launch_ms": time_ms(lambda: torch.cuda._sleep(0), False),
              "ms": {}}
    print(f"  empty launch: {result['empty_launch_ms']:.4f} ms", flush=True)
    failures = result["failures"] = []
    inputs = {name: (torch.as_tensor(ids, device=dev), s)
              for name, (ids, s) in cases.items()}
    plains = {name: sk.bincount_plain(ids, s)
              for name, (ids, s) in inputs.items()}

    def record(table, label, case, fn, dirty_fn=None):
        """Times fn, warm and cold, when it agrees with the plain version
        (called once through dirty_fn, on an output full of 0x7f bytes,
        where it is given); a case that disagrees is listed in failures,
        untimed, and the tool exits 1."""
        got = (dirty_fn or fn)()
        torch.cuda.synchronize()
        if not torch.equal(got, plains[case]):
            wrong = int((got != plains[case]).sum())
            failures.append(f"{label}: {case}: {wrong} bins differ")
            print(f"  {label}: {case}: DISAGREES ({wrong} bins)", flush=True)
            return
        row = table.setdefault(case, {})
        row["warm"], row["cold"] = time_ms(fn, False), time_ms(fn, True)
        print(f"  {label}: {case}: warm {row['warm']:.4f} ms, cold "
              f"{row['cold']:.4f} ms", flush=True)

    for case, (ids, s) in inputs.items():
        record(result["ms"], "K7", case,
               lambda ids=ids, s=s: sk.bincount_launch(ids, s))

    if args.candidates:
        lib = build_candidates()
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        dirty = lambda s: torch.full((s,), 0x7F7F7F7F, dtype=torch.int32,  # noqa: E731
                                     device=dev)

        def grid(ids, s, cluster, per_sm, loads, flush, words, memset, ranges):
            out = (torch.empty if memset else torch.zeros)(
                s, dtype=torch.int32, device=dev)
            _build.raise_on_error(lib.candidate_grid(
                ids.data_ptr(), out.data_ptr(), ids.numel(), s, cluster,
                per_sm, loads, flush, words, memset, ranges, stream()),
                "candidate_grid")
            return out

        def one(ids, s, cluster, loads, copies, out=None):
            out = torch.empty(s, dtype=torch.int32, device=dev) \
                if out is None else out
            _build.raise_on_error(lib.candidate_one(
                ids.data_ptr(), out.data_ptr(), ids.numel(), s, cluster,
                loads, copies, stream()), "candidate_one")
            return out

        def cooperative(ids, s, per_sm, out=None):
            grid = ctypes.c_int(0)
            _build.raise_on_error(lib.candidate_cooperative(
                ids.data_ptr(), None, None, 0, s, per_sm, ctypes.byref(grid),
                stream()), "candidate_cooperative")
            scratch = torch.empty((grid.value, s), dtype=torch.int32,
                                  device=dev)
            out = torch.empty(s, dtype=torch.int32, device=dev) \
                if out is None else out
            _build.raise_on_error(lib.candidate_cooperative(
                ids.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                ids.numel(), s, per_sm, ctypes.byref(grid), stream()),
                "candidate_cooperative")
            return out

        def pdl(ids, s, carveout, out=None):
            out = torch.empty(s, dtype=torch.int32, device=dev) \
                if out is None else out
            _build.raise_on_error(lib.candidate_pdl(
                ids.data_ptr(), out.data_ptr(), ids.numel(), s, carveout,
                stream()), "candidate_pdl")
            return out

        # a carveout set on a function stays set: the plain dependent
        # launch runs on every case before the variants that set one
        table = result["candidates_ms"] = {}
        for name, carveout in PDL:
            for case, (ids, s) in inputs.items():
                record(table.setdefault(name, {}), name, case,
                       lambda: pdl(ids, s, carveout),
                       lambda: pdl(ids, s, carveout, dirty(s)))
        for case, (ids, s) in inputs.items():
            for name, *knobs in GRID:
                record(table.setdefault(name, {}), name, case,
                       lambda: grid(ids, s, *knobs))
            for name, per_sm in COOPERATIVE:
                record(table.setdefault(name, {}), name, case,
                       lambda: cooperative(ids, s, per_sm),
                       lambda: cooperative(ids, s, per_sm, dirty(s)))
            if ids.numel() > 1 << 20:
                continue
            for name, *knobs in ONE:
                record(table.setdefault(name, {}), name, case,
                       lambda: one(ids, s, *knobs),
                       lambda: one(ids, s, *knobs, out=dirty(s)))

        # the tree's routes, forced through its C entry points
        if hasattr(sk._lib(), "repro_bincount_block"):
            routes = result["routes_ms"] = {}
            entries = {"grid": sk._lib().repro_bincount,
                       "block": sk._lib().repro_bincount_block}

            def forced(route, ids, s, out=None):
                # either entry point writes every bin (the grid's launcher
                # zeroes out first)
                if out is None:
                    out = torch.empty(s, dtype=torch.int32, device=dev)
                _build.raise_on_error(entries[route](
                    ids.data_ptr(), out.data_ptr(), ids.numel(), s, stream()),
                    "bincount")
                return out

            rng = np.random.default_rng(8)
            for n in ROUTE_IDS:
                for s in (EXPERTS, 8192):
                    case = f"uniform {n} -> {s}"
                    ids = torch.as_tensor(rng.integers(0, s, n)
                                          .astype(np.int32), device=dev)
                    plains[case] = sk.bincount_plain(ids, s)
                    for route in entries:
                        record(routes.setdefault(route, {}), route, case,
                               lambda: forced(route, ids, s),
                               lambda: forced(route, ids, s, dirty(s)))

        # L2's int32 atomic rate: one 1024-thread block an SM, RED_REDS adds
        # a thread onto s addresses
        red = result["red"] = {}
        for s in (EXPERTS, 8192, 1 << 20):
            out = torch.zeros(s, dtype=torch.int32, device=dev)
            run = lambda: lib.candidate_red(out.data_ptr(), s, RED_REDS,  # noqa: E731
                                            stream())
            _build.raise_on_error(run(), "candidate_red")
            ms = time_ms(run, False)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            adds = sms * 1024 * RED_REDS
            red[f"{adds} adds onto {s} addresses"] = {
                "ms": ms, "G_adds_per_s": adds / ms / 1e6}
            print(f"  red: {s} addresses: {ms:.4f} ms, "
                  f"{adds / ms / 1e6:.1f} G adds/s", flush=True)

    print(card)
    print(json.dumps(result))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
