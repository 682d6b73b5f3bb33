"""Run the PyTorch/H100 port's §5 histogram path on one card, and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA GPU, PyTorch
built for CUDA and the CUDA toolkit (``nvcc``).  The port's kernels
(``src/repro_torch/kernels/csrc``) are built from the checkout first.

Phases, each of which must pass:

0. the environment: the card's name and power limit, torch and CUDA;
1. build every kernel with nvcc, and list the shared-memory atomics each
   compiled to;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape (4 Mpx x 4 channels, 256 bins) and at padded shapes;
3. drive the main path, as ``examples/quickstart.py`` and ``repro compare``
   run it, through the port's ``Session`` and its ``"kernel"`` provider,
   with every launch count set to 0 just before and read just after;
4. time each kernel, its plain version and one PyTorch library call at
   the main path's shape, beside the least time the card could take.

The last line is the contract line ``{"ok": true, "device": {...}}``; the
line before it lists every kernel with its launches and times.  Without
a CUDA device, or outside a checkout, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_PX = 1 << 22          # the paper's largest image (PAPER_SIZES[-1])
PAD_PX = (100, 5000)       # sizes that pad the last 2048-pixel tile
NUM_BINS = 256
K4_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 atomics sum in run-to-run order
COMPARE_PX = [2 ** p for p in range(5, 23, 3)]

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and the f32 rate
# outside the tensor cores, which bounds the kernels' adds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# which Pallas kernel of the reference each CUDA kernel replaces
KERNELS = {
    "hist": ("src/repro_torch/kernels/csrc/histogram.cu",
             "src/repro/kernels/histogram/kernel.py:74"),
    "hist_instrumented": ("src/repro_torch/kernels/csrc/histogram.cu",
                          "src/repro/kernels/histogram/kernel.py:106"),
    "hist_weighted": ("src/repro_torch/kernels/csrc/histogram.cu",
                      "src/repro/kernels/histogram/kernel.py:88"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== phase: {name}")
    return time.perf_counter()


# ---------------------------------------------------------------------------
# 0-1. environment and build
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_atomics(lib_path: Path) -> dict[str, list[str]]:
    """Shared-memory atomic opcodes per kernel instantiation in the SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    found: dict[str, set[str]] = {}
    func = None
    for line in out.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            found[func] = set()
        elif func and ("ATOMS" in line or "REDUX" in line
                       or "MATCH" in line):
            found[func].add(line.split(";")[0].split("*/")[-1].split()[0])
    return {_template_args(f): sorted(ops) for f, ops in found.items()}


def _template_args(mangled: str) -> str:
    """``hist_kernel<reorder, weighted, instrumented>`` from a mangled name."""
    i = mangled.find("hist_kernelI")
    if i < 0:
        return mangled
    bits = [b == "1" for b in re.findall(r"Lb([01])E", mangled[i:])[:3]]
    names = ("reorder", "weighted", "instrumented")
    return "hist_kernel<" + ",".join(n for n, b in zip(names, bits) if b) + ">"


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def case_image(kind: str, n: int, channels: int = 4):
    from repro_torch.data.images import make_image
    if channels == 4:
        return make_image(kind, n)
    if kind == "solid":
        return np.full((n, channels), 128, np.int32)
    rng = np.random.default_rng(1)
    return rng.integers(0, NUM_BINS, (n, channels)).astype(np.int32)


def check_kernels(dev, sizes) -> dict[str, float]:
    """Every kernel against its plain version; returns max |err| by kernel."""
    import torch

    from repro_torch.core import counters
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram import ops

    err = {k: 0.0 for k in KERNELS}
    rng = np.random.default_rng(0)
    for n, channels in sizes:
        for kind in ("solid", "uniform"):
            img_np = case_image(kind, n, channels)
            img = torch.as_tensor(img_np, device=dev)
            w = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
            plain = hk.histogram_plain(img, NUM_BINS)
            for variant, reorder in (("hist", False), ("hist2", True)):
                case = f"{n}x{channels} {kind} {variant}"
                counts = hk.histogram_launch(img, reorder=reorder)
                k3_counts, k3_deg = hk.histogram_launch(
                    img, reorder=reorder, instrumented=True)
                sums = hk.histogram_launch(img, reorder=reorder, weights=w)
                if dev != "cpu":
                    torch.cuda.synchronize()
                p_counts, p_deg = hk.histogram_instrumented_plain(
                    img, NUM_BINS, reorder)
                stream = ops.committed_index_stream(img_np, variant=variant)
                np_deg = counters._degrees_full_waves(
                    stream.reshape(-1, 1024), 32)
                _require(torch.equal(counts, plain), f"K2 counts, {case}")
                _require(torch.equal(k3_counts, p_counts),
                         f"K3 counts, {case}")
                _require(torch.equal(k3_deg, p_deg),
                         f"K3 degrees vs plain, {case}")
                _require(np.array_equal(
                    k3_deg.cpu().numpy().reshape(-1).astype(np.float64),
                    np_deg), f"K3 degrees vs committed stream, {case}")
                p_sums = hk.histogram_weighted_plain(img, w, NUM_BINS)
                torch.testing.assert_close(sums, p_sums, **K4_TOL,
                                           msg=f"K4 sums, {case}")
                err["hist"] = max(err["hist"], _abs_err(counts, plain))
                err["hist_instrumented"] = max(
                    err["hist_instrumented"], _abs_err(k3_counts, p_counts),
                    _abs_err(k3_deg, p_deg))
                err["hist_weighted"] = max(err["hist_weighted"],
                                           _abs_err(sums, p_sums))
                if kind == "solid" and n == MAIN_PX:
                    want = {"hist": 32.0, "hist2": 8.0}[variant]
                    got = float(k3_deg.double().mean())
                    _require(got == want, f"{case}: mean degree {got}, "
                                          f"expected {want}")
                log(f"  {case}: K2/K3 bit-equal, K4 max |err| "
                    f"{_abs_err(sums, p_sums):.3g}, mean degree "
                    f"{float(k3_deg.double().mean())!r}")
    return err


def _abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# 3. the main path
# ---------------------------------------------------------------------------


def main_path(dev, provider, px_small: int, px_main: int,
              compare_px, cache_dir) -> dict[str, float]:
    """quickstart.py's tour and ``repro compare``'s case study, through
    the port's Session with ``provider`` as the measured counter source.

    Returns the host-clock seconds of each step.
    """
    import torch

    from repro_torch.analysis import Session, WorkloadSpec, get_device
    from repro_torch.core.profiler import CacheModel
    from repro_torch.data.images import make_image
    from repro_torch.kernels.histogram import ops

    seconds = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        if dev != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    sess = Session("v5e", cache_dir=cache_dir, provider=provider)
    step("table")

    # quickstart: kernel smoke and verdicts on the two §4 extremes
    for kind in ("solid", "uniform"):
        img = make_image(kind, px_small)
        total = int(ops.histogram(img, torch_device=dev).sum())
        _require(total == img.shape[0] * 4, f"{kind}: histogram sum {total}")
        wsum = float(ops.histogram_weighted(
            img, np.ones(img.shape[0], np.float32),
            torch_device=dev).sum())
        _require(wsum == img.shape[0] * 4, f"{kind}: weighted sum {wsum}")
        verdict = sess.classify(WorkloadSpec.from_histogram(
            img, label=f"{kind} {px_small}px", force_fao=True,
            waves_per_tile=32))
        log(f"  classify {kind} {px_small}px: {verdict.bottleneck} "
            f"({verdict.utilization:.0%})")
    step("classify")

    # the model's recommended fix for the solid case: hist2
    img = make_image("solid", px_main)
    result = sess.sweep([WorkloadSpec.from_histogram(
        img, label=v, variant=v, force_fao=True, waves_per_tile=32)
        for v in ("hist", "hist2")])
    e0, e1 = result.profiles[0].e, result.profiles[1].e
    _require((e0, e1) == (32.0, 8.0), f"sweep e {e0} -> {e1}")
    log(f"  sweep solid {px_main}px: e {e0} -> {e1}, predicted speedup "
        f"{float(result.speedup_vs_first[1]):.4f}x")
    step("sweep")

    # one 4 Mpx point's counters through each provider alone
    spec = WorkloadSpec.from_histogram(img, label="solid/hist",
                                       force_fao=True, waves_per_tile=32)
    sess.collect(spec, "trace")
    step("collect/trace")
    sess.collect(spec, provider)
    step("collect/kernel")

    # §5: modeled ("trace") against measured (the kernel provider)
    for kind in ("solid", "uniform"):
        img = make_image(kind, px_main)
        for variant in ("hist", "hist2"):
            spec = WorkloadSpec.from_histogram(
                img, label=f"{kind}/{variant}", variant=variant,
                force_fao=True, waves_per_tile=32)
            rep = sess.validate(spec, providers=("trace", provider))
            beq = [c.batch_bitwise_equal for c in rep.comparisons]
            e = rep.comparisons[1].counters["e"]
            _require(np.isfinite(e) and e >= 1.0, f"validate e {e}")
            _require(rep.max_rel_err == 0.0 and beq == [True, True],
                     f"validate {kind}/{variant}: max rel err "
                     f"{rep.max_rel_err}, batch bit-equal {beq}")
            log(f"  validate {kind}/{variant} {px_main}px: e {e!r}, "
                f"max rel err 0.0, batch bit-identical")
    step("validate")

    # repro compare: the case study through both providers, identical
    device = get_device("v5e").with_(cache=CacheModel(
        llc_bytes=1 << 21, miss_latency_cycles=800, hide_concurrency=48))
    by_provider = {}
    for prov in ("trace", provider):
        s = Session(device, table=sess.table, provider=prov)
        by_provider[s.provider.name] = compare(s, compare_px)
    trace_rows, kernel_rows = by_provider["trace"], by_provider["kernel"]
    _require(trace_rows == kernel_rows,
             "compare: kernel provider's verdicts and shifts differ from "
             "the trace provider's")
    rows, shifts = kernel_rows
    log(f"  compare: {len(rows)} points, {len(shifts)} size-axis shift(s), "
        f"identical through the trace and kernel providers")
    for line in shifts:
        log(f"    shift {line}")
    step("compare")
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return seconds


def compare(sess, pixels) -> tuple[list, list]:
    """``repro compare``'s rows and size-axis shift events."""
    from repro_torch.analysis import WorkloadSpec
    from repro_torch.data.images import make_image

    def spec(kind, px, variant):
        return WorkloadSpec.from_histogram(
            make_image(kind, px), label=f"{kind}/{px}px/{variant}",
            variant=variant, waves_per_tile=8)

    rows, size_shifts = [], []
    for kind in ("solid", "uniform"):
        for variant in ("hist", "hist2"):
            res = sess.sweep([spec(kind, px, variant) for px in pixels])
            size_shifts.extend(
                f"{kind}/{variant}: {s.unit_before}->{s.unit_after} "
                f"({s.label_before} -> {s.label_after})" for s in res.shifts)
        for px in pixels:
            res = sess.sweep([spec(kind, px, "hist"),
                              spec(kind, px, "hist2")])
            h, h2 = res.profiles
            shift = res.shifts[0] if res.shifts else None
            rows.append((kind, px, h.scatter_utilization, h.bottleneck,
                         h2.scatter_utilization, h2.bottleneck,
                         float(res.speedup_vs_first[1]),
                         f"{shift.unit_before}->{shift.unit_after}"
                         if shift else ""))
    return rows, size_shifts


# ---------------------------------------------------------------------------
# 4. times
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call.

    A short sleep on the stream before the start event lets the host
    enqueue the call before the card reaches it, so the events time the
    card's work and not the wrapper's host overhead.
    """
    import torch
    for _ in range(warmup):
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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def time_kernels(dev) -> dict:
    """Times of each kernel at the main path's shape, by image and variant."""
    import torch

    from repro_torch.kernels.histogram import kernel as hk

    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.random(MAIN_PX).astype(np.float32), device=dev)
    out = {k: {} for k in KERNELS}
    for kind in ("solid", "uniform"):
        img = torch.as_tensor(case_image(kind, MAIN_PX), device=dev)
        n, c = img.shape
        # the library yardstick's input: the flat bin index, made once
        flat = (img + torch.arange(c, device=dev, dtype=torch.int32)
                * NUM_BINS).reshape(-1).to(torch.int64)
        w_flat = w[:, None].expand(n, c).reshape(-1).contiguous()
        img_bytes, out_bytes = img.numel() * 4, c * NUM_BINS * 4
        deg_bytes = img.numel() // 1024 * 4
        adds = img.numel()
        for variant, reorder in (("hist", False), ("hist2", True)):
            case = f"{kind}/{variant}"
            runs = {
                "hist": (
                    lambda: hk.histogram_launch(img, reorder=reorder),
                    lambda: hk.histogram_plain(img, NUM_BINS),
                    lambda: torch.bincount(flat, minlength=c * NUM_BINS),
                    img_bytes + out_bytes),
                "hist_instrumented": (
                    lambda: hk.histogram_launch(img, reorder=reorder,
                                                instrumented=True),
                    lambda: hk.histogram_instrumented_plain(
                        img, NUM_BINS, reorder),
                    None,
                    img_bytes + out_bytes + deg_bytes),
                "hist_weighted": (
                    lambda: hk.histogram_launch(img, reorder=reorder,
                                                weights=w),
                    lambda: hk.histogram_weighted_plain(img, w, NUM_BINS),
                    lambda: torch.bincount(flat, weights=w_flat,
                                           minlength=c * NUM_BINS),
                    img_bytes + n * 4 + out_bytes),
            }
            for name, (kernel, plain, library, nbytes) in runs.items():
                bound_ms, bound_by = bound(nbytes, adds)
                row = {
                    "ms": time_ms(kernel, reps=25),
                    "plain_ms": time_ms(plain, reps=5, warmup=1),
                    "library_ms": (time_ms(library, reps=25)
                                   if library is not None else None),
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                }
                out[name][case] = row
                lib = ("n/a" if row["library_ms"] is None
                       else f"{row['library_ms']:.4f}")
                log(f"  {name:18s} {case:14s} kernel {row['ms']:.4f} ms  "
                    f"plain {row['plain_ms']:.4f} ms  library {lib} ms  "
                    f"bound {bound_ms:.4f} ms ({bound_by})")
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import kernel as hk

    dev = "cuda"
    phase("environment")
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = phase("build")
    logs = _build.build_all()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for func, ops in sass_atomics(_build.library_path("histogram")).items():
        log(f"  SASS {func}: {' '.join(ops)}")

    t0 = phase("kernels against their plain versions")
    err = check_kernels(dev, [(MAIN_PX, 4)] + [(n, 4) for n in PAD_PX]
                        + [(5000, 3), (70000, 3)])
    log(f"  ok in {time.perf_counter() - t0:.1f} s; max |err| {err}")

    t0 = phase("main path")
    hk.reset_launches()
    with tempfile.TemporaryDirectory() as cache_dir:
        main_path(dev, "kernel", 1 << 18, MAIN_PX, COMPARE_PX, cache_dir)
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)
    log(f"  ok in {time.perf_counter() - t0:.1f} s; launches {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    _require(not missing, f"kernels not launched on the main path: {missing}")

    t0 = phase("times at the main path's shape (4 Mpx x 4 channels)")
    log(f"  card: {card}")
    times = time_kernels(dev)
    log(f"  ok in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        head = times[name]["solid/hist"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], **head,
            "shape": f"{MAIN_PX}x4 int32, {NUM_BINS} bins, solid, hist",
            "cases": times[name],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
