"""Run the PyTorch/H100 port's main paths on one card, and check them.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA GPU, PyTorch
built for CUDA and the CUDA toolkit (``nvcc``).  The port's kernels
(``src/repro_torch/kernels/csrc``) are built from the checkout first.

Two paths, each run through the port's ``Session`` and its ``"kernel"``
provider: the paper's §5 histogram case study (K1-K4), and the scatter-add
path (K5-K7): Tool 1's kernel mode, the MoE dispatch streams of
``benchmarks/run.py``, the ``indices`` route and the persistent sweep
cache.  Phases, each of which must pass:

0. the environment: the card's name and power limit, torch and CUDA;
1. build every kernel with nvcc (one process per source, in parallel),
   and list the atomics each compiled to;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at padded and odd shapes;
3. drive each main path with every launch count set to 0 just before it
   and read just after: the histogram path as ``examples/quickstart.py``
   and ``repro compare`` run it, then the scatter path;
4. time each kernel, its plain version and one PyTorch library call at
   the main paths' shapes, beside the least time the card could take.

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
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 atomics sum in run-to-run order
COMPARE_PX = [2 ** p for p in range(5, 23, 3)]

# the scatter path: 4 Mi ids (the histogram's 4 Mpx) into 4096 segments,
# the MoE dispatch of benchmarks/run.py (65,536 tokens over 128 experts),
# and the MoE combine at qwen3-moe-235b-a22b's widths (4096 tokens x
# top-8 expert rows of d_model 4096, bf16, summed per token)
SCATTER_IDS = 1 << 22
SCATTER_SEGMENTS = 4096
DISPATCH_TOKENS, EXPERTS = 1 << 16, 128
COMBINE_TOKENS, TOP_K, D_MODEL = 4096, 8, 4096

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
    "scatter_add": ("src/repro_torch/kernels/csrc/scatter_add.cu",
                    "src/repro/kernels/scatter_add/kernel.py:40"),
    "scatter_add_instrumented": ("src/repro_torch/kernels/csrc/scatter_add.cu",
                                 "src/repro/kernels/scatter_add/kernel.py:72"),
    "bincount": ("src/repro_torch/kernels/csrc/scatter_add.cu",
                 "src/repro/kernels/scatter_add/kernel.py:60"),
}
HIST_KERNELS = ("hist", "hist_instrumented", "hist_weighted")
SCATTER_KERNELS = ("scatter_add", "scatter_add_instrumented", "bincount")


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
    """Atomic, reduction and match opcodes per kernel instantiation in
    the SASS (shared-memory ``ATOMS``, global ``ATOMG``/``RED``)."""
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
        elif func:
            words = line.split(";")[0].split("*/")[-1].split()
            op = next((w for w in words if not w.startswith("@")), "")
            if op.startswith(("ATOM", "RED", "MATCH")):
                found[func].add(op)
    return {_template_args(f): sorted(ops) for f, ops in found.items()}


# each kernel template's bool parameters, in order
_FLAGS = {"hist_kernel": ("reorder", "weighted", "instrumented"),
          "scatter_kernel": ("shared", "instrumented")}
_VALUE_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def _template_args(mangled: str) -> str:
    """``hist_kernel<reorder,...>``, ``scatter_kernel<bf16,shared,...>`` or
    ``bincount_kernel`` from a mangled name."""
    m = re.search(r"(hist_kernel|scatter_kernel|bincount_kernel)(I?)",
                  mangled)
    if m is None:
        return mangled
    name, rest = m.group(1), mangled[m.end():]
    if not m.group(2):
        return name
    t = re.match(r"(f|13__nv_bfloat16|6__half)L", rest)
    args = [_VALUE_TYPES[t.group(1)]] if t else []
    bits = [b == "1" for b in re.findall(r"Lb([01])E", rest)]
    args += [f for f, b in zip(_FLAGS[name], bits) if b]
    return f"{name}<{','.join(args)}>"


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

    err = {k: 0.0 for k in HIST_KERNELS}
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
                torch.testing.assert_close(sums, p_sums, **F32_TOL,
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


def dispatch_ids(kind: str, n: int = DISPATCH_TOKENS,
                 experts: int = EXPERTS) -> np.ndarray:
    """``benchmarks/run.py``'s MoE dispatch streams (seeded as there)."""
    rng = np.random.default_rng(0)
    balanced = rng.integers(0, experts, n)    # drawn in the benchmark's order
    skewed = rng.zipf(1.3, n) % experts
    streams = {"balanced": balanced, "skewed": skewed,
               "collapsed": np.zeros(n, np.int64)}
    return streams[kind].astype(np.int32)


def scatter_ids(kind: str, n: int = SCATTER_IDS,
                segments: int = SCATTER_SEGMENTS) -> np.ndarray:
    """A solid (one segment) or uniform id stream."""
    if kind == "solid":
        return np.full(n, segments // 2, np.int32)
    return np.random.default_rng(1).integers(0, segments, n).astype(np.int32)


def combine_case(dev):
    """The MoE combine: expert output rows, grouped by expert as the
    experts emit them, summed back into their tokens (bf16 values)."""
    import torch
    rng = np.random.default_rng(2)
    experts = rng.random((COMBINE_TOKENS, EXPERTS)).argsort(axis=1)[:, :TOP_K]
    order = np.argsort(experts.reshape(-1), kind="stable")
    ids = np.repeat(np.arange(COMBINE_TOKENS, dtype=np.int32), TOP_K)[order]
    gen = torch.Generator(device=dev).manual_seed(3)
    vals = torch.randn((ids.size, D_MODEL), generator=gen, device=dev,
                       dtype=torch.float32).to(torch.bfloat16)
    return vals, torch.as_tensor(ids, device=dev)


def _with_strays(ids: np.ndarray, segments: int) -> np.ndarray:
    """A copy with one id in a hundred set out of range (-1 or S): the
    drop rule must hold on the card too."""
    out = ids.copy()
    rng = np.random.default_rng(4)
    out[rng.integers(0, out.size, max(out.size // 100, 1))] = -1
    out[rng.integers(0, out.size, max(out.size // 100, 1))] = segments
    return out


def check_scatter_kernels(dev) -> dict[str, float]:
    """K5-K7 against their plain versions; returns max |err| by kernel.

    Sums are held at rtol/atol 1e-5 (f32 atomics add in run-to-run
    order; the plain version adds in f64); counts and degrees bitwise.
    """
    import torch

    from repro_torch.core import counters
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.kernels.scatter_add import ops

    err = {k: 0.0 for k in SCATTER_KERNELS}
    rng = np.random.default_rng(5)

    def k5(case, vals, ids, segments):
        got = sk.scatter_add_launch(vals, ids, segments)
        torch.cuda.synchronize()
        plain = sk.scatter_add_plain(vals, ids, segments)
        torch.testing.assert_close(got, plain, **F32_TOL,
                                   msg=f"K5 sums, {case}")
        err["scatter_add"] = max(err["scatter_add"], _abs_err(got, plain))
        log(f"  K5 {case} ({sk.scatter_route(segments, vals.shape[1])}): "
            f"max |err| {_abs_err(got, plain):.3g}")

    def k6(case, ids_np, vals, segments):
        stream_np = ops.committed_id_stream(ids_np, segments)
        stream = torch.as_tensor(stream_np, device=dev)
        out, deg = sk.scatter_add_instrumented_launch(vals, stream, segments)
        torch.cuda.synchronize()
        p_out, p_deg = sk.scatter_add_instrumented_plain(vals, stream,
                                                         segments)
        np_deg = counters._degrees_full_waves(stream_np.reshape(-1, 1024), 32)
        torch.testing.assert_close(out, p_out, **F32_TOL,
                                   msg=f"K6 sums, {case}")
        _require(torch.equal(deg, p_deg), f"K6 degrees vs plain, {case}")
        _require(np.array_equal(deg.cpu().numpy().astype(np.float64), np_deg),
                 f"K6 degrees vs committed stream, {case}")
        err["scatter_add_instrumented"] = max(
            err["scatter_add_instrumented"], _abs_err(out, p_out),
            _abs_err(deg, p_deg))
        mean = float(deg.double().mean())
        log(f"  K6 {case}: degrees bit-equal, mean degree {mean!r}")
        return mean

    def k7(case, ids, segments):
        got = sk.bincount_launch(ids, segments)
        torch.cuda.synchronize()
        _require(torch.equal(got, sk.bincount_plain(ids, segments)),
                 f"K7 counts, {case}")
        log(f"  K7 {case}: bit-equal")

    for kind in ("solid", "uniform"):
        ids_np = scatter_ids(kind)
        ids = torch.as_tensor(ids_np, device=dev)
        vals = torch.as_tensor(rng.random((ids_np.size, 1), np.float32),
                               device=dev)
        case = f"{kind} {ids_np.size} x 1 f32 -> {SCATTER_SEGMENTS}"
        k5(case, vals, ids, SCATTER_SEGMENTS)
        mean = k6(case, ids_np, vals, SCATTER_SEGMENTS)
        if kind == "solid":
            _require(mean == 32.0, f"{case}: mean degree {mean}, expected 32")
        k7(f"{kind} {ids_np.size} -> 8192",
           torch.as_tensor(scatter_ids(kind, segments=8192), device=dev), 8192)
    vals, ids = combine_case(dev)
    k5(f"MoE combine {tuple(vals.shape)} bf16 -> {COMBINE_TOKENS}", vals, ids,
       COMBINE_TOKENS)
    del vals, ids
    for n, d, segments, dtype in ((1000, 8, 64, torch.float32),
                                  (5000, 16, 128, torch.float32),
                                  (2048, 8, 64, torch.float16),
                                  (3000, 8, 16384, torch.float32)):
        ids_np = _with_strays(rng.integers(0, segments, n).astype(np.int32),
                              segments)
        vals = torch.as_tensor(rng.standard_normal((n, d), np.float32),
                               device=dev)
        case = f"({n}, {d}, {segments}) {str(dtype)[6:]} with strays"
        k5(case, vals.to(dtype), torch.as_tensor(ids_np, device=dev),
           segments)
        k6(case, ids_np, vals, segments)
    for kind in ("balanced", "skewed", "collapsed"):
        k7(f"dispatch {kind} {DISPATCH_TOKENS} -> {EXPERTS}",
           torch.as_tensor(dispatch_ids(kind), device=dev), EXPERTS)
    for n, segments in ((1, 2), (5000, 100), (70001, 8192)):
        ids_np = _with_strays(rng.integers(0, segments, n).astype(np.int32),
                              segments)
        k7(f"odd {n} -> {segments} with strays",
           torch.as_tensor(ids_np, device=dev), segments)
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


def scatter_path(dev, provider, cache_dir, tables_dir) -> dict[str, float]:
    """The scatter-add path: the MoE dispatch count, Tool 1's kernel mode,
    ``benchmarks/run.py``'s dispatch rows validated modeled against
    measured, the ``indices`` route at 4 Mi ids, and a cold then a warm
    sweep over the persistent cache.

    Returns the host-clock seconds of each step.
    """
    import torch

    from repro_torch.analysis import Session, WorkloadSpec
    from repro_torch.core import counters, microbench
    from repro_torch.kernels.scatter_add import ops

    seconds = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    # kernel smoke: a scatter of ones is the dispatch count
    for kind in ("balanced", "skewed", "collapsed"):
        ids = dispatch_ids(kind)
        summed = ops.scatter_add(np.ones((ids.size, 1), np.float32), ids,
                                 num_segments=EXPERTS, torch_device=dev)
        counts = ops.bincount(ids, num_segments=EXPERTS, torch_device=dev)
        _require(torch.equal(summed[:, 0], counts.float())
                 and int(counts.sum()) == ids.size,
                 f"{kind}: scatter of ones != bincount")
    step("smoke")

    # Tool 1: designed (n, e) patterns recovered from K6's degrees
    table = microbench.build_table(mode="kernel", torch_device=dev)
    checks = table.meta["kernel_validation"]
    worst = max(rec["e_rel_err"] for rec in checks)
    # n designed waves count as n rounded up to the 2-wave tile
    _require(len(checks) == 8 and worst < 0.05
             and all(rec["counted"]["N"] == -(-rec["designed"]["n"] // 2) * 2
                     for rec in checks),
             f"Tool 1 kernel mode: {checks}")
    log(f"  Tool 1 kernel mode: {len(checks)} designed patterns, largest "
        f"e_rel_err {worst!r}")
    step("tool1")

    # benchmarks/run.py's MoE dispatch rows, modeled against measured
    sess = Session("v5e", cache_dir=tables_dir, provider=provider)
    dispatch = []
    for kind in ("balanced", "skewed", "collapsed"):
        ids = dispatch_ids(kind)
        spec = WorkloadSpec.from_scatter_add(
            ids, np.ones((ids.size, 1), np.float32), EXPERTS, label=kind,
            waves_per_tile=32, bytes_read=float(ids.size * 4))
        dispatch.append(spec)
        rep = sess.validate(spec, providers=("trace", provider))
        beq = [c.batch_bitwise_equal for c in rep.comparisons]
        _require(rep.max_rel_err == 0.0 and beq == [True, True],
                 f"validate {kind}: max rel err {rep.max_rel_err}, batch "
                 f"bit-equal {beq}")
        prof = sess.profile(spec)
        log(f"  validate dispatch {kind}: e {prof.e!r}, U "
            f"{prof.scatter_utilization!r}, {prof.bottleneck}; max rel err "
            f"0.0, batch bit-identical")
    step("validate")

    # the indices route at 4 Mi ids, against the trace provider
    indices = []
    for kind in ("solid", "uniform"):
        spec = WorkloadSpec.from_indices(scatter_ids(kind), SCATTER_SEGMENTS,
                                         label=f"indices {kind}",
                                         waves_per_tile=32)
        indices.append(spec)
        got = sess.collect(spec, provider)
        want = sess.collect(spec, "trace")
        _require(counters.bitwise_equal(got, want, ignore=("source", "meta")),
                 f"indices {kind}: kernel counters differ from trace")
        log(f"  indices {kind} {SCATTER_IDS} ids: e {got.e!r}, "
            f"{got.total_jobs:.0f} waves, equal to the trace provider's")
    step("indices")

    # a cold then a warm sweep over the persistent cache
    specs = [s for spec in dispatch + indices
             for s in spec.grid(waves_per_tile=[8, 32])]
    reports = []
    for run in ("cold", "warm"):
        s = Session("v5e", table=sess.table, provider=provider,
                    persistent_cache=cache_dir)
        reports.append(s.sweep(specs).render("json"))
        log(f"  {run} sweep of {len(specs)} points: {s.stats}")
        step(f"sweep/{run}")
    _require(s.stats["collected"] == 0
             and s.stats["disk_hits"] == len(specs),
             f"warm sweep collected points: {s.stats}")
    _require(reports[0] == reports[1], "warm sweep report differs")
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return seconds


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
    out = {k: {} for k in HIST_KERNELS}
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
                _log_row(name, case, row)
    return out


def _log_row(name: str, case: str, row: dict) -> None:
    lib = ("n/a" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    log(f"  {name:18s} {case:14s} kernel {row['ms']:.4f} ms  "
        f"plain {row['plain_ms']:.4f} ms  library {lib} ms  "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


def time_scatter_kernels(dev) -> dict:
    """Times of K5-K7 at the scatter path's shapes.

    Bytes: each value and id read once, each output written once.
    Operations: one f32 add per (row, d) update that lands.  The library
    yardsticks: ``Tensor.index_add_`` on f32 values (cast outside the
    timed call; every id here is in range, which it needs) for K5,
    ``torch.bincount`` for K7, none for K6.
    """
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.kernels.scatter_add import ops

    out = {k: {} for k in SCATTER_KERNELS}

    def record(name, case, kernel, plain, library, nbytes, adds):
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
        _log_row(name, case, row)

    rng = np.random.default_rng(6)
    segs = SCATTER_SEGMENTS
    for kind in ("solid", "uniform"):
        ids_np = scatter_ids(kind)
        n = ids_np.size
        ids = torch.as_tensor(ids_np, device=dev)
        ids64 = ids.to(torch.int64)
        stream = torch.as_tensor(ops.committed_id_stream(ids_np, segs),
                                 device=dev)
        vals = torch.as_tensor(rng.random((n, 1), np.float32), device=dev)
        case = f"{kind} 4Mi x 1 f32"
        record("scatter_add", case,
               lambda: sk.scatter_add_launch(vals, ids, segs),
               lambda: sk.scatter_add_plain(vals, ids, segs),
               lambda: torch.zeros((segs, 1), device=dev).index_add_(
                   0, ids64, vals),
               n * 4 + n * 4 + segs * 4, n)
        record("scatter_add_instrumented", case,
               lambda: sk.scatter_add_instrumented_launch(vals, stream, segs),
               lambda: sk.scatter_add_instrumented_plain(vals, stream, segs),
               None, n * 4 + n * 4 + segs * 4 + n // 1024 * 4, n)
        k7_ids = torch.as_tensor(scatter_ids(kind, segments=8192), device=dev)
        k7_ids64 = k7_ids.to(torch.int64)
        record("bincount", f"{kind} 4Mi -> 8192",
               lambda: sk.bincount_launch(k7_ids, 8192),
               lambda: sk.bincount_plain(k7_ids, 8192),
               lambda: torch.bincount(k7_ids64, minlength=8192),
               n * 4 + 8192 * 4, n)
    d_ids = torch.as_tensor(dispatch_ids("balanced"), device=dev)
    d_ids64 = d_ids.to(torch.int64)
    record("bincount", "dispatch 64Ki -> 128",
           lambda: sk.bincount_launch(d_ids, EXPERTS),
           lambda: sk.bincount_plain(d_ids, EXPERTS),
           lambda: torch.bincount(d_ids64, minlength=EXPERTS),
           d_ids.numel() * 4 + EXPERTS * 4, d_ids.numel())
    vals, ids = combine_case(dev)
    vals32, ids64 = vals.float(), ids.to(torch.int64)
    rows, d = vals.shape
    record("scatter_add", "MoE combine bf16",
           lambda: sk.scatter_add_launch(vals, ids, COMBINE_TOKENS),
           lambda: sk.scatter_add_plain(vals, ids, COMBINE_TOKENS),
           lambda: torch.zeros((COMBINE_TOKENS, d), device=dev).index_add_(
               0, ids64, vals32),
           rows * d * 2 + rows * 4 + COMBINE_TOKENS * d * 4, rows * d)
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
    from repro_torch.kernels.scatter_add import kernel as sk

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
    for lib in sorted(logs):
        for func, ops in sass_atomics(_build.library_path(lib)).items():
            log(f"  SASS {func}: {' '.join(ops)}")

    t0 = phase("kernels against their plain versions")
    err = check_kernels(dev, [(MAIN_PX, 4)] + [(n, 4) for n in PAD_PX]
                        + [(5000, 3), (70000, 3)])
    err.update(check_scatter_kernels(dev))
    log(f"  ok in {time.perf_counter() - t0:.1f} s; max |err| {err}")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tables = Path(tmp) / "tables"
        t0 = phase("main path: the histogram case study")
        hk.reset_launches()
        sk.reset_launches()
        main_path(dev, "kernel", 1 << 18, MAIN_PX, COMPARE_PX, tables)
        torch.cuda.synchronize()
        launches.update({k: hk.LAUNCHES[k] for k in HIST_KERNELS})
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{dict(hk.LAUNCHES)}")

        t0 = phase("main path: scatter-add, Tool 1 and the sweep cache")
        hk.reset_launches()
        sk.reset_launches()
        scatter_path(dev, "kernel", Path(tmp) / "cache", tables)
        torch.cuda.synchronize()
        launches.update({k: sk.LAUNCHES[k] for k in SCATTER_KERNELS})
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{dict(sk.LAUNCHES)}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    _require(not missing, f"kernels not launched on the main path: {missing}")

    t0 = phase("times at the main paths' shapes")
    log(f"  card: {card}")
    times = time_kernels(dev)
    times.update(time_scatter_kernels(dev))
    log(f"  ok in {time.perf_counter() - t0:.1f} s")

    heads = {
        "hist": ("solid/hist",
                 f"{MAIN_PX}x4 int32, {NUM_BINS} bins, solid, hist"),
        "scatter_add": ("uniform 4Mi x 1 f32",
                        f"{SCATTER_IDS} ids x 1 f32 into "
                        f"{SCATTER_SEGMENTS} segments, uniform, shared route"),
        "bincount": ("uniform 4Mi -> 8192",
                     f"{SCATTER_IDS} ids into 8192 segments, uniform"),
    }
    heads["hist_instrumented"] = heads["hist_weighted"] = heads["hist"]
    heads["scatter_add_instrumented"] = heads["scatter_add"]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        case, shape = heads[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], **times[name][case],
            "shape": shape, "cases": times[name],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
