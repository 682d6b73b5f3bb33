"""Run the PyTorch/H100 port's main paths on one card, and check them.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA GPU, PyTorch
built for CUDA and the CUDA toolkit (``nvcc``).  The port's kernels
(``src/repro_torch/kernels/csrc``) are built from the checkout first.

Four paths run through the port's ``Session`` and its ``"kernel"``
provider: the paper's §5 histogram case study (K1-K4), driven as
``python -m repro_torch`` runs it (``validate``, ``compare``, ``advise``,
``heatmap``, ``sweep``), the scatter-add path (K5-K7): Tool 1's
kernel mode, the MoE dispatch streams of ``benchmarks/run.py``, the
``indices`` route and the persistent sweep cache, the profiling
service with the kernel provider (K3, K6) as its primary: clean jobs
over HTTP, a chaos burst under the seeded fault schedule, and
``python -m repro_torch serve``/``client`` as processes, and the static
audit of HLO text (``audit --hlo-file`` on the two reduced and two
full-width texts of ``tests/data``, which launches nothing, then each
finding's candidate stream through K6).  Then it serves a
dense LM: qwen2-72b at its published widths, with the depth cut to what
one card holds, through ``make_prefill`` (each layer's attention in K8,
flash attention) and ``generate``.  Phases, each of which must pass:

0. the environment: the card's name and power limit, torch and CUDA;
1. build every kernel with nvcc (one process per source, in parallel),
   list the atomic and warp-wide opcodes each compiled to, and require
   that K2 kept one shared atomic per pixel and step, that K5's vector
   route adds 16 bytes at once, and that K4 and K5 spill no register;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at padded and odd shapes (K3-K6 also on the
   designed commit groups of ``repro_torch.data.streams``, K5 on each of
   its routes; K8 also at the reference test's shapes, blocks and bounds,
   and on its Hopper route at ragged T, before any model is on the card);
3. drive each main path with every launch count set to 0 just before it
   and read just after: the histogram path as
   ``examples/torch_quickstart.py`` and the port's command line run it
   (each command in-process through ``repro_torch.cli.main.main`` with
   ``--provider kernel``, its host seconds and launches logged), then the
   scatter path, then the service (each job's host seconds and launches
   logged; no response may be degraded outside the chaos burst, and in
   it none but by an injected fault), then the static audit (each
   command's host seconds, each text's sites, instructions and findings
   logged; no launch during the audit, K6 once a distinct finding spec),
   then serving, then MoE serving
   (K7 and K5 on each model's live layer-0 tensors held against their
   plain versions there, outside the counts);
4. time each kernel, its plain version and one PyTorch library call at
   the main paths' shapes, beside the least time the card could take
   (K5 and K7 also on the MoE layers' live inputs).

The last line is the contract line ``{"ok": true, "device": {...}}``; the
line before it lists every kernel with its launches and times.  Without
a CUDA device, or outside a checkout, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
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
# the MoE dispatch of benchmarks/run.py (65,536 tokens over 128 experts;
# a decode step of 4 tokens x top-8 gives 32 ids),
# and the MoE combine at qwen3-moe-235b-a22b's widths (4096 tokens x
# top-8 expert rows of d_model 4096, bf16, summed per token)
SCATTER_IDS = 1 << 22
SCATTER_SEGMENTS = 4096
DISPATCH_TOKENS, EXPERTS = 1 << 16, 128
DECODE_IDS = 32            # one decode step of 4 tokens x top-8
COMBINE_TOKENS, TOP_K, D_MODEL = 4096, 8, 4096

# the serving path: qwen2-72b at its published widths, prefill of 4
# prompts of 2048 tokens, then 16 prompt tokens replayed and 16 generated
SERVE_ARCH = "qwen2-72b"
PREFILL_B, PREFILL_T = 4, 2048
RAGGED_T = 2000                      # not a whole 128-key tile: K8 masks it
DECODE_PROMPT, DECODE_GEN = 16, 16
F32_CHECK_LAYERS, F32_CHECK_B, F32_CHECK_T = 2, 2, 80
# qwen2-72b layers served on one card: 36 of 80 (the rest stand for
# further pipeline stages); serving_reckoning() checks that they fit
SERVE_LAYERS = 36
MEMORY_MARGIN = 2 << 30              # allocator slack beside the reckoning
# the MoE serving path: qwen3-moe-235b-a22b at every published width with
# 12 of 94 layers (the rest stand for further pipeline stages; 13 are not
# reckoned safe beside the prefill's logits), and granite-moe-1b-a400m
# whole, each with the prefill and decode of the serving path
MOE_SERVE = (("qwen3-moe-235b-a22b", "qwen3-moe", 12),
             ("granite-moe-1b-a400m", "granite-moe", None))
MOE_SHORT = {arch: short for arch, short, _ in MOE_SERVE}
MOE_KERNELS = ("flash_attention", "bincount", "scatter_add",
               "scatter_add_instrumented")
FLASH_F32_TOL = 2e-4                 # tests/test_kernels_flash.py
FLASH_BF16_TOL = 3e-2                # its bf16 case, T = 64 only
# bf16 beyond the reference test's T = 64, where a typical output is small
# (about 0.03 at T = 2048) and 3e-2 would pass nearly anything: each
# element within FLASH_BF16_RTOL |out| (two bf16 ulps, for the two output
# roundings) plus FLASH_BF16_P_TOL sum_j p_j |v_j| (twice the worst error
# of rounding P to bf16 for the P V product), and the mean |err|, over all
# rows and over the later half, at most FLASH_BF16_MEAN of the mean |out|
FLASH_BF16_RTOL = 1.6e-2
FLASH_BF16_P_TOL = 2.0 ** -8
FLASH_BF16_MEAN = 2.0 ** -8
DECODE_TOL = 2e-2                    # tests/test_models_decode.py

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, the f32 rate
# outside the tensor cores, which bounds the atomic kernels' adds, and the
# dense bf16 tensor-core rate, which bounds K8
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:27"),
}
HIST_KERNELS = ("hist", "hist_instrumented", "hist_weighted")
SCATTER_KERNELS = ("scatter_add", "scatter_add_instrumented", "bincount")
SERVE_KERNELS = ("flash_attention",)
# the service path's kernels: K3 for histogram jobs, K6 for indices jobs
SERVICE_KERNELS = ("hist_instrumented", "scatter_add_instrumented")
# the audit launches nothing; K6 checks each finding's stream
AUDIT_KERNELS = ("scatter_add_instrumented",)
AUDIT_IDS = 1 << 17        # a finding's synthesized stream (audit/rules.py)


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
    """Atomic, reduction, warp, tensor-core, TMA and barrier opcodes per
    kernel instantiation in the SASS (shared-memory ``ATOMS``, global
    ``ATOMG``/``RED``, ``MATCH``, ``VOTE`` of a ballot, ``SHFL``, ``HMMA``
    of ``mma.sync``, ``HGMMA`` of ``wgmma``, ``UTMALDG`` of a TMA load,
    ``SYNCS`` of an ``mbarrier``)."""
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
            if op.startswith(("ATOM", "RED", "MATCH", "VOTE", "SHFL",
                              "HMMA", "HGMMA", "UTMALDG", "SYNCS")):
                found[func].add(op)
    return {_template_args(f): sorted(ops) for f, ops in found.items()}


# each kernel template's bool parameters, in order
_FLAGS = {"hist_kernel": ("reorder",),
          "hist_weighted_kernel": ("reorder",),
          "hist_instrumented_kernel": ("reorder",),
          "scatter_rows_kernel": ("shared",),
          "scatter_tiles_kernel": ("shared", "vector"),
          "scatter_owned_kernel": (),
          "scatter_instrumented_kernel": ("shared",),
          "bincount_kernel": ("store",)}
_VALUE_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def _template_args(mangled: str) -> str:
    """``hist_kernel<reorder>``, ``scatter_tiles_kernel<bf16,vector>``,
    ``scatter_rows_kernel<f32,shared>``,
    ``scatter_instrumented_kernel<shared>`` or ``bincount_kernel<store>``
    from a mangled name."""
    m = re.search(r"(hist_kernel|hist_weighted_kernel|hist_instrumented_kernel|"
                  r"scatter_rows_kernel|scatter_tiles_kernel|"
                  r"scatter_owned_kernel|scatter_instrumented_kernel|"
                  r"bincount_kernel|bincount_zero_kernel)(I?)", mangled)
    flash = re.search(r"(flash_(?:f32|bf16|bf16_sm90)_kernel)ILi(\d+)E",
                      mangled)
    if flash:
        return f"{flash.group(1)}<{flash.group(2)}>"
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
    """A solid (one segment), uniform or skewed (1/k^1.3) id stream."""
    from repro_torch.data import streams
    if kind == "solid":
        return np.full(n, segments // 2, np.int32)
    if kind == "skewed":
        return streams.skewed_ids(n, segments, seed=1)
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


def audit_streams() -> list[tuple[str, np.ndarray, int]]:
    """K6's inputs on the audit path, as (case, ids, segments): three of
    the rules' synthesized streams (values are ones), the fewest and the
    most segments a finding spec asks for and a uniform draw between."""
    n = AUDIT_IDS
    uniform = np.random.default_rng(7).integers(0, 1536, n)
    return [("audit hot 128Ki -> 2", np.arange(n) % 2, 2),
            ("audit uniform 128Ki -> 1536", uniform, 1536),
            ("audit rows 128Ki -> 13107200", np.arange(n) // 32, 13107200)]


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
        log(f"  K5 {case} ({sk.scatter_add_route(vals, segments)}): "
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
        # the output is allocated, not zeroed: a freed block of 0x7f bytes
        # of its size comes back to it, so that a bin left unwritten shows
        dirty = torch.full((segments,), 0x7F7F7F7F, dtype=torch.int32,
                           device=ids.device)
        del dirty
        got = sk.bincount_launch(ids, segments)
        torch.cuda.synchronize()
        _require(torch.equal(got, sk.bincount_plain(ids, segments)),
                 f"K7 counts, {case}")
        log(f"  K7 {case} ({sk.bincount_route(ids.numel(), segments)}): "
            f"bit-equal")

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
    for case, ids_np, segments in audit_streams():
        k6(case, ids_np.astype(np.int32),
           torch.ones((ids_np.size, 1), device=dev), segments)
    for kind in ("balanced", "skewed", "collapsed"):
        k7(f"dispatch {kind} {DISPATCH_TOKENS} -> {EXPERTS}",
           torch.as_tensor(dispatch_ids(kind), device=dev), EXPERTS)
    for n, segments in ((1, 2), (5000, 100), (70001, 8192)):
        ids_np = _with_strays(rng.integers(0, segments, n).astype(np.int32),
                              segments)
        k7(f"odd {n} -> {segments} with strays",
           torch.as_tensor(ids_np, device=dev), segments)
    # K7's edges: n % 4 = 1, 2, 3 and 0 ids, S = 1, 128, 8192, both routes
    # (BINCOUNT_BLOCK_IDS on either side), views that start 4 and 12 bytes
    # into a 16-byte word, strays, and the skewed, collapsed and decode
    # streams
    block = sk.BINCOUNT_BLOCK_IDS
    for n in (0, 1, 2, 3, 5, 32, block, block + 1, 70001, SCATTER_IDS + 3):
        for segments in (1, 128, 8192):
            ids_np = _with_strays(
                rng.integers(0, segments, n + 3).astype(np.int32), segments)
            whole = torch.as_tensor(ids_np, device=dev)
            for off in (0, 1, 3):
                k7(f"{n} -> {segments} with strays, ids[{off}:]",
                   whole[off:off + n], segments)
    k7(f"skewed {SCATTER_IDS} -> 8192", torch.as_tensor(
        scatter_ids("skewed", segments=8192), device=dev), 8192)
    k7(f"skewed {SCATTER_IDS} -> 8192, ids[1:]", torch.as_tensor(
        scatter_ids("skewed", segments=8192), device=dev)[1:], 8192)
    k7(f"collapsed {DISPATCH_TOKENS} -> {EXPERTS}, ids[1:]", torch.as_tensor(
        dispatch_ids("collapsed"), device=dev)[1:], EXPERTS)
    k7(f"decode {DECODE_IDS} -> {EXPERTS}", torch.as_tensor(
        dispatch_ids("balanced")[:DECODE_IDS], device=dev), EXPERTS)
    return err


# K6 on the adversarial streams: (d, S) on the shared route and on the
# global one (S x d x 4 bytes over the 96 KB budget)
ADVERSARIAL_K6 = ((1, 4096), (1, 32768), (8, 1024), (8, 4096), (64, 256),
                  (64, 1024))
ADVERSARIAL_SHORT = 37      # value rows short of the stream: they add nothing
# K5 on the adversarial streams: (d, S) on the shared route, on the global
# one with scalar adds (d = 1), with vector adds (d = 8) and with owned
# rows (d = 2048)
ADVERSARIAL_K5 = ((1, 4096), (1, 32768), (8, 1024), (8, 4096), (2048, 4096))


def check_adversarial(dev, err: dict[str, float]) -> None:
    """K3, K4, K5 and K6 on ``repro_torch.data.streams``' designed commit
    groups: K3 and K4 (C = 3, 4; hist and hist2) on each stream laid out as
    an image, K3's counts and degrees bit-equal, K4's sums (random weights,
    a fifth of them 0) within F32_TOL; K5 (ADVERSARIAL_K5, f32 and bf16)
    and K6 (ADVERSARIAL_K6) on each stream cut to its first n = size -
    ADVERSARIAL_SHORT rows (so that K5's last warp is partial) within
    F32_TOL, K6's degrees of the whole stream bit-equal.  Raises the max
    |err| entries in ``err``."""
    import torch

    from repro_torch.core import counters
    from repro_torch.data import streams
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram import ops
    from repro_torch.kernels.scatter_add import kernel as sk

    rng = np.random.default_rng(7)
    cases = streams.adversarial_streams()
    for name, stream_np in cases.items():
        for channels in (3, 4):
            img_np = streams.stream_image(stream_np, channels)
            img = torch.as_tensor(img_np, device=dev)
            for variant, reorder in (("hist", False), ("hist2", True)):
                case = f"{name}, C={channels} {variant}"
                counts, deg = hk.histogram_launch(img, reorder=reorder,
                                                  instrumented=True)
                torch.cuda.synchronize()
                p_counts, p_deg = hk.histogram_instrumented_plain(
                    img, NUM_BINS, reorder)
                committed = ops.committed_index_stream(img_np,
                                                       variant=variant)
                _require(torch.equal(counts, p_counts), f"K3 counts, {case}")
                _require(torch.equal(deg, p_deg), f"K3 degrees, {case}")
                _require(np.array_equal(
                    deg.cpu().numpy().reshape(-1).astype(np.float64),
                    counters._degrees_full_waves(
                        committed.reshape(-1, 1024), 32)),
                    f"K3 degrees vs committed stream, {case}")
                w_np = rng.random(img_np.shape[0]).astype(np.float32)
                w_np[::5] = 0.0
                w = torch.as_tensor(w_np, device=dev)
                sums = hk.histogram_launch(img, reorder=reorder, weights=w)
                torch.cuda.synchronize()
                p_sums = hk.histogram_weighted_plain(img, w, NUM_BINS)
                torch.testing.assert_close(sums, p_sums, **F32_TOL,
                                           msg=f"K4 sums, {case}")
                err["hist_weighted"] = max(err["hist_weighted"],
                                           _abs_err(sums, p_sums))
        ids = torch.as_tensor(stream_np, device=dev)
        want_deg = counters._degrees_full_waves(stream_np.reshape(-1, 1024),
                                                32)
        n = stream_np.size - ADVERSARIAL_SHORT
        for d, segments in ADVERSARIAL_K6:
            case = (f"{name}, d={d} S={segments} "
                    f"({sk.scatter_route(segments, d)})")
            vals = torch.as_tensor(rng.standard_normal((n, d), np.float32),
                                   device=dev)
            out, deg = sk.scatter_add_instrumented_launch(vals, ids, segments)
            torch.cuda.synchronize()
            p_out, p_deg = sk.scatter_add_instrumented_plain(vals, ids,
                                                             segments)
            torch.testing.assert_close(out, p_out, **F32_TOL,
                                       msg=f"K6 sums, {case}")
            _require(torch.equal(deg, p_deg), f"K6 degrees, {case}")
            _require(np.array_equal(deg.cpu().numpy().astype(np.float64),
                                    want_deg),
                     f"K6 degrees vs committed stream, {case}")
            err["scatter_add_instrumented"] = max(
                err["scatter_add_instrumented"], _abs_err(out, p_out))
        routes = set()
        for d, segments in ADVERSARIAL_K5:
            for dtype in (torch.float32, torch.bfloat16):
                vals = torch.as_tensor(rng.standard_normal((n, d), np.float32),
                                       device=dev).to(dtype)
                route = sk.scatter_add_route(vals, segments)
                routes.add(route)
                case = (f"{name}, {n} x {d} {str(dtype)[6:]} -> {segments} "
                        f"({route})")
                got = sk.scatter_add_launch(vals, ids[:n], segments)
                torch.cuda.synchronize()
                plain = sk.scatter_add_plain(vals, ids[:n], segments)
                torch.testing.assert_close(got, plain, **F32_TOL,
                                           msg=f"K5 sums, {case}")
                err["scatter_add"] = max(err["scatter_add"],
                                         _abs_err(got, plain))
    log(f"  K3 and K4 (C = 3, 4; hist, hist2), K5 ({len(ADVERSARIAL_K5)} d/S "
        f"cases x f32, bf16; routes {sorted(routes)}) and K6 "
        f"({len(ADVERSARIAL_K6)} d/S cases) on {len(cases)} adversarial "
        f"streams: degrees and K3 counts bit-equal, K4, K5 and K6 sums within "
        f"{F32_TOL}")


def flash_case(b, h, kv, t, d, dtype, dev, seed=0):
    """Seeded normal q (B, H, T, d) and k, v (B, KV, T, d) on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, h, t, d), (b, kv, t, d), (b, kv, t, d))]


def check_flash_kernel(dev) -> dict[str, float]:
    """K8 against ``ref.attention_ref`` (per batch entry, K/V expanded for
    GQA) and its plain version, within the reference test's bounds: 2e-4
    in f32, 3e-2 in bf16 at its T = 64; bf16 at longer T is held to a
    bound scaled to the output (``scaled_bf16_check``).  Its three routes:
    f32, bf16 at d <= 32 (``mma.sync``) and bf16 at d = 64, 128 (``wgmma``
    fed by TMA), the last also at ragged T.  Returns max |err| over every
    case."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref

    worst = 0.0

    def check(case, q, k, v, causal, bq=128, bkv=128):
        """(B, H, T, d) q, (B, KV, T, d) k/v through ``ops`` with the
        reference's blocks (B = 1 through its unbatched (H, T, d) layout),
        or with ``bq=None`` through the launcher, as ``attend`` calls it,
        at any T."""
        nonlocal worst
        group = q.shape[1] // k.shape[1]
        kw = dict(causal=causal, bq=bq, bkv=bkv, group=group,
                  torch_device=dev)
        if bq is None:
            got = fk.flash_attention_launch(q, k, v, causal=causal,
                                            group=group)
        elif q.shape[0] == 1:
            got = ops.flash_attention(q[0], k[0], v[0], **kw)[None]
        else:
            got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        scaled = q.dtype == torch.bfloat16 and q.shape[2] > 64
        tol = FLASH_F32_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
        plain = fk.attention_plain(q, k, v, causal=causal, group=group)
        if scaled:
            bound_txt = scaled_bf16_check(got, plain, q, k, v, causal,
                                          group, case)
        else:
            torch.testing.assert_close(got.float(), plain.float(), rtol=tol,
                                       atol=tol, msg=f"K8 vs plain, {case}")
            bound_txt = f"bound {tol}"
        err = _abs_err(got, plain)
        if q.shape[2] <= 256:                # the oracle, entry by entry
            ke, ve = (x.repeat_interleave(group, dim=1) for x in (k, v))
            for i in range(q.shape[0]):
                want = ref.attention_ref(q[i], ke[i], ve[i], causal)
                if scaled:
                    scaled_bf16_check(got[i:i + 1], want[None], q[i:i + 1],
                                      k[i:i + 1], v[i:i + 1], causal, group,
                                      f"{case} vs attention_ref")
                else:
                    torch.testing.assert_close(
                        got[i].float(), want.float(), rtol=tol, atol=tol,
                        msg=f"K8 vs attention_ref, {case}")
                err = max(err, _abs_err(got[i], want))
        worst = max(worst, err)
        log(f"  K8 {case}: max |err| {err:.3g}; {bound_txt}")

    for h, t, d in ((2, 64, 32), (4, 128, 64), (1, 256, 16)):
        q, k, v = flash_case(1, h, h, t, d, torch.float32, dev)
        for causal in (True, False):
            check(f"({h}, {t}, {d}) f32 causal={causal} bq=bkv=32", q, k, v,
                  causal, 32, 32)
    q, k, v = flash_case(1, 2, 2, 64, 32, torch.float32, dev, seed=1)
    for bq, bkv in ((16, 64), (64, 16), (32, 32)):
        check(f"(2, 64, 32) f32 bq={bq} bkv={bkv}", q, k, v, True, bq, bkv)
    check("(2, 2, 64, 32) bf16 batched", *flash_case(
        2, 2, 2, 64, 32, torch.bfloat16, dev, seed=2), True, 32, 32)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            check(f"GQA group 8 (2, 64/8, 256, 128) {str(dtype)[6:]} "
                  f"causal={causal}", *flash_case(2, 64, 8, 256, 128, dtype,
                                                  dev, seed=3), causal)
    # the Hopper route at ragged T: TMA's zero rows past T and the mask of
    # the last tile, on one query row up to a tile and a row past two
    for d in (64, 128):
        for t in (1, 127, 129, RAGGED_T):
            for causal in (True, False):
                check(f"(3, 8/2, {t}, {d}) bf16 causal={causal}",
                      *flash_case(3, 8, 2, t, d, torch.bfloat16, dev,
                                  seed=6), causal, None, None)
        check(f"(3, 8/2, {PREFILL_T}, {d}) bf16 causal=False",
              *flash_case(3, 8, 2, PREFILL_T, d, torch.bfloat16, dev,
                          seed=7), False, None, None)
    # the serving paths' prefill shapes (qwen2-72b, then the MoE models);
    # the plain version's f32 scores take up to 4.3 GB, so this runs
    # before any model is on the card
    for arch in (SERVE_ARCH,) + tuple(arch for arch, _, _ in MOE_SERVE):
        cfg = _serve_config(arch=arch)
        check(f"{arch} prefill ({PREFILL_B}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads}, {PREFILL_T}, {cfg.head_dim}) bf16 causal",
              *flash_case(PREFILL_B, cfg.num_heads, cfg.num_kv_heads,
                          PREFILL_T, cfg.head_dim, torch.bfloat16, dev,
                          seed=4), True)
        torch.cuda.empty_cache()
    return {"flash_attention": worst}


def scaled_bf16_check(got, want, q, k, v, causal, group, case) -> str:
    """Holds bf16 K8 output ``got`` to ``want`` elementwise within
    FLASH_BF16_RTOL |want| + FLASH_BF16_P_TOL (P |V|), P |V| being the
    attention of the same scores over |v|, and in the mean within
    FLASH_BF16_MEAN of the mean |want|, over all rows and over the later
    half; returns the measured numbers as text."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk

    t = q.shape[2]
    err = (got.float() - want.float()).abs()
    mag = want.float().abs()
    p_abs_v = fk.attention_plain(q.float(), k.float(), v.float().abs(),
                                 causal=causal, group=group)
    slack = FLASH_BF16_RTOL * mag + FLASH_BF16_P_TOL * p_abs_v
    used = float((err / slack).max())
    del p_abs_v, slack
    _require(used <= 1.0, f"K8 vs plain, {case}: an element uses {used:.3g} "
                          f"of its bound")
    means = {}
    for part, rows in (("all", slice(None)), ("later half", slice(t // 2,
                                                                  None))):
        e, m = float(err[:, :, rows].mean()), float(mag[:, :, rows].mean())
        _require(e <= FLASH_BF16_MEAN * m,
                 f"K8 vs plain, {case}: mean |err| {e} over {part} rows > "
                 f"{FLASH_BF16_MEAN} x mean |out| {m}")
        means[part] = (e, m)
    return (f"at most {used:.3g} of the bound {FLASH_BF16_RTOL} |out| + "
            f"2^-8 P|V| on any element; mean |err| / mean |out| "
            + ", ".join(f"{part} {e:.3g} / {m:.3g}"
                        for part, (e, m) in means.items())
            + f" (bound {FLASH_BF16_MEAN:.3g})")


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
    """quickstart.py's tour through the port's Session, then the paper's
    tools as ``python -m repro_torch`` runs them, in-process through
    ``repro_torch.cli.main.main`` with ``provider`` as the measured counter
    source on ``dev``: ``validate``, ``compare`` through both providers,
    ``advise --validate-top 1``, ``heatmap``, a cold then a warm ``sweep``
    (in the results root ``REPRO_TORCH_RESULTS`` names), and ``--version``
    in a process of its own.

    Returns the host-clock seconds of each step.
    """
    import torch

    import repro_torch
    from repro_torch.analysis import Session, WorkloadSpec
    from repro_torch.cli.main import main as cli_main
    from repro_torch.data.images import make_image
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram import ops
    from repro_torch.kernels.scatter_add import kernel as sk

    seconds = {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        if dev != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    def launched() -> dict:
        return {**hk.LAUNCHES, **sk.LAUNCHES}

    def cli(name, *argv) -> str:
        """One command's stdout; its host seconds and launches logged."""
        nonlocal t0
        before = launched()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(argv) + ["--torch-device", dev,
                                        "--cache-dir", str(cache_dir)])
        step(f"cli/{name}")
        delta = {k: n - before.get(k, 0) for k, n in launched().items()
                 if n != before.get(k, 0)}
        log(f"  cli {name}: {seconds[f'cli/{name}']:.3f} s, launches "
            f"{delta}")
        _require(rc == 0, f"python -m repro_torch {' '.join(argv)}: rc {rc}")
        return buf.getvalue()

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
    image = ("--workload", "histogram", "--pixels", str(px_main))
    for kind in ("solid", "uniform"):
        for variant in ("hist", "hist2"):
            rep = json.loads(cli(
                f"validate {kind}/{variant}", "validate", *image, "--dist",
                kind, "--variant", variant, "--waves-per-tile", "32",
                "--format", "json"))
            ref, measured = rep["comparisons"]
            beq = [c["batch_bitwise_equal"] for c in rep["comparisons"]]
            e = measured["counters"]["e"]
            _require(np.isfinite(e) and e >= 1.0, f"validate e {e}")
            _require((ref["provider"], measured["provider"])
                     == ("trace", "kernel")
                     and all(v == 0.0 for v in measured["rel_err"].values())
                     and beq == [True, True],
                     f"validate {kind}/{variant}: {rep}")
            log(f"    e {e!r}, max rel err 0.0, batch bit-identical")

    # repro compare: the case study through both providers, identical
    pixels = [str(px) for px in compare_px]
    reports = {prov: cli(f"compare/{prov}", "compare", "--provider", prov,
                         "--pixels", *pixels, "--format", "json",
                         "--no-artifact", "--no-cache")
               for prov in ("trace", provider)}
    _require(reports["trace"] == reports[provider],
             "compare: kernel provider's verdicts and shifts differ from "
             "the trace provider's")
    payload = json.loads(reports[provider])
    log(f"    {len(payload['points'])} points, "
        f"{len(payload['size_shifts'])} size-axis shift(s), identical "
        f"through the trace and kernel providers")
    for line in payload["size_shifts"]:
        log(f"    shift {line}")
    log(f"    verdict: {payload['verdict']}")

    # the advisor on the paper's solid image, its winner measured
    rep = json.loads(cli("advise", "advise", *image, "--dist", "solid",
                         "--provider", provider, "--validate-top", "1",
                         "--format", "json", "--no-artifact", "--no-cache"))
    top = rep["candidates"][0]
    _require("rotation" in top["families"].split("+")
             and top.get("validation_e_rel_err") == 0.0
             and top.get("validation_max_rel_err") == 0.0,
             f"advise: top-1 {top}")
    log(f"    top-1 {top['transforms']} x{top['predicted_speedup']!r} of "
        f"{rep['stats']['candidates']} candidates, {rep['stats']}; "
        f"validated e rel err 0.0")

    # the heat map of the same image
    hm = json.loads(cli("heatmap", "heatmap", *image, "--dist", "solid",
                        "--provider", provider, "--format", "json",
                        "--no-artifact"))
    _require(hm["peak_degree"] == 32.0 and hm["counters"]["e"] == 32.0
             and hm["total_hits"] == px_main * 4
             and 0.0 < hm["top_bin_share"] < 1.0,
             f"heatmap: peak {hm['peak_degree']}, e "
             f"{hm['counters']['e']}, hits {hm['total_hits']}, share "
             f"{hm['top_bin_share']}")
    log(f"    peak wave degree {hm['peak_degree']}, top-bin share "
        f"{hm['top_bin_share']!r} (bin {hm['top_bin']}), hot bins "
        f"{hm['hot_bins']}")

    # a cold then a warm sweep over the persistent cache
    sweep = ("sweep", *image[:-1], str(px_main // 4), str(px_main),
             "--dist", "solid", "--waves-per-tile", "8", "32",
             "--provider", provider, "--no-artifact")
    before = launched()
    cold = cli("sweep/cold", *sweep).splitlines()
    mid = launched()
    warm = cli("sweep/warm", *sweep).splitlines()
    _require(cold[-1] == "cache: 4 collected, 0 memo hits, 0 disk hits"
             and warm[-1] == "cache: 0 collected, 0 memo hits, 4 disk hits"
             and cold[:-1] == warm[:-1] and mid != before
             and launched() == mid,
             f"sweep cold {cold[-1]!r}, warm {warm[-1]!r}")
    log(f"    {cold[-1]} -> {warm[-1]}; reports identical")

    # the entry point itself
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "--version"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    step("cli/--version")
    _require(proc.returncode == 0 and proc.stdout.strip()
             == f"repro_torch {repro_torch.__version__}",
             f"python -m repro_torch --version: {proc}")
    log(f"  cli --version (a process of its own): "
        f"{seconds['cli/--version']:.3f} s, {proc.stdout.strip()}")
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return seconds


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


def service_path(dev, results: Path, px_main: int, n_ids: int,
                 segments: int, burst: int = 64) -> dict[str, float]:
    """The profiling service with the kernel provider as its primary:

    (a) a clean service behind its HTTP server, one job at a time through
        ``ServiceClient`` (``validate`` on the four images, ``profile`` of
        the ``indices`` stream, ``advise --validate-top 1``, a sweep cold
        then warm), every response undegraded and every breaker closed;
    (b) chaos: the reference chaos test's fault schedule on the kernel
        primary, a mixed burst from 8 client threads, every fallback one
        that the schedule injected, then its profile and sweep jobs
        again, warm;
    (c) ``python -m repro_torch serve`` and ``client`` as processes.

    Returns the host-clock seconds of each step.
    """
    import signal
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.analysis import Session
    from repro_torch.analysis.resilience import counter_set_error, is_degraded
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.service import (ProfilingService, ServiceClient,
                                     ServiceConfig, ServiceError)
    from repro_torch.service.jobs import build_workload_specs, mixed_burst
    from repro_torch.service.server import make_http_server

    seconds = {}
    path_kernels = ("hist_instrumented", "scatter_add_instrumented")

    def launched() -> dict:
        return {**hk.LAUNCHES, **sk.LAUNCHES}

    def delta(before) -> dict:
        return {k: n - before[k] for k, n in launched().items()
                if n != before[k]}

    def running(config):
        """(service, its HTTP server, a client), the server serving."""
        svc = ProfilingService(config).start()
        server = make_http_server(svc, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return svc, server, ServiceClient(
            "127.0.0.1", server.server_address[1], timeout_s=300)

    def closed(svc, server):
        server.shutdown()
        server.server_close()
        svc.stop()

    # (a) clean, one job at a time over HTTP
    os.environ["REPRO_TORCH_RESULTS"] = str(results / "clean")
    svc, server, client = running(ServiceConfig(
        provider="kernel", fallbacks=("trace",), torch_device=dev,
        workers=4))

    def submit(label, job, kernels=True) -> dict:
        """One job's result; its host seconds and launches logged."""
        name = f"{job['kind']} {label}"
        before = launched()
        t0 = time.perf_counter()
        body = client.submit({**job, "timeout_s": 120})
        if dev != "cpu":
            torch.cuda.synchronize()
        seconds[f"service/{name}"] = time.perf_counter() - t0
        got = delta(before)
        log(f"  service {name}: {seconds[f'service/{name}']:.3f} s, "
            f"launches {got}")
        breakers = client.status()["breakers"]
        _require(body["ok"] and body["degraded"] is False
                 and body["fallback_providers"] == []
                 and all(b["state"] == "closed" for b in breakers.values()),
                 f"service {name}: degraded {body['degraded']}, fallbacks "
                 f"{body['fallback_providers']}, breakers {breakers}")
        _require(not kernels or any(got.get(k) for k in path_kernels),
                 f"service {name}: launched neither K3 nor K6 ({got})")
        return body["result"]

    try:
        _require(client.health() == {"ok": True}, "service health")
        for kind in ("solid", "uniform"):
            for variant in ("hist", "hist2"):
                rep = submit(f"{kind}/{variant}", {
                    "kind": "validate",
                    "workload": {"workload": "histogram", "pixels": px_main,
                                 "dist": kind, "variant": variant,
                                 "waves_per_tile": 32}})
                ref, measured = rep["comparisons"]
                _require((ref["provider"], measured["provider"])
                         == ("trace", "kernel")
                         and all(v == 0.0
                                 for v in measured["rel_err"].values())
                         and [c["batch_bitwise_equal"]
                              for c in rep["comparisons"]] == [True, True],
                         f"service validate {kind}/{variant}: {rep}")
                log(f"    e {measured['counters']['e']!r}, max rel err 0.0, "
                    f"batch bit-identical")
        trace = Session("v5e")
        for kind in ("uniform", "solid"):
            workload = {"workload": "indices", "size": n_ids, "dist": kind,
                        "num_bins": segments, "waves_per_tile": 32}
            rep = submit(f"indices {kind}",
                         {"kind": "profile", "workload": workload})
            want = json.loads(trace.analyze(
                build_workload_specs(workload)).render("json"))["points"]
            point = rep["points"][0]
            _require(rep["points"] == want,
                     f"service indices {kind}: {point} against the trace "
                     f"provider's {want}")
            log(f"    {n_ids} ids into {segments}: e {point['e']!r}, "
                f"{point['bottleneck']}, equal to the trace provider's")
        rep = submit(f"solid {px_main}px", {
            "kind": "advise",
            "workload": {"workload": "histogram", "pixels": px_main,
                         "dist": "solid"},
            "options": {"validate_top": 1}})
        top = rep["candidates"][0]
        _require("rotation" in top["families"].split("+")
                 and top.get("validation_e_rel_err") == 0.0
                 and top.get("validation_max_rel_err") == 0.0,
                 f"service advise: top-1 {top}")
        log(f"    top-1 {top['transforms']} x{top['predicted_speedup']!r} "
            f"of {rep['stats']['candidates']} candidates; validated e rel "
            f"err 0.0")
        sweep = {"kind": "sweep",
                 "workload": {"workload": "histogram",
                              "pixels": [px_main // 4, px_main],
                              "dist": "solid", "waves_per_tile": [8, 32]}}
        reports = []
        for run in ("cold", "warm"):
            stats = client.status()["sessions"]["v5e"]
            before = launched()
            reports.append(submit(run, sweep, kernels=run == "cold"))
            after = client.status()["sessions"]["v5e"]
            collected = after["collected"] - stats["collected"]
            log(f"    {run}: {collected} collected, session {after}")
        _require(collected == 0 and launched() == before
                 and reports[0] == reports[1],
                 f"service warm sweep: {collected} collected, launches "
                 f"{delta(before)}")
    finally:
        closed(svc, server)

    # (b) chaos on the card: 20% faults, 5% corrupt counters, no retries
    os.environ["REPRO_TORCH_RESULTS"] = str(results / "chaos")
    svc, server, _ = running(ServiceConfig(
        provider="kernel", fallbacks=("trace",), torch_device=dev,
        workers=4, queue_depth=256, timeout_s=60.0, max_timeout_s=120.0,
        retries=0, breaker_threshold=10 ** 6, fault_rate=0.2,
        corrupt_rate=0.05, fault_seed=42))
    port = server.server_address[1]
    # A launch that fails only under the worker pool would fall back to
    # `trace` like an injected fault does.  So watch both ends: what the
    # kernel provider itself raises or returns broken, and each degraded
    # counter set the chain hands back.  With no retries, each injected
    # fault and each injected corruption costs exactly one fallback, and
    # no other fallback may happen.
    kernel_faults, fallbacks = [], []
    watch_lock = threading.Lock()
    kernel_collect, chain_collect = svc.kernel.collect, svc.provider.collect

    def watched_kernel(spec, device):
        try:
            cset = kernel_collect(spec, device)
        except Exception as exc:
            with watch_lock:
                kernel_faults.append(
                    f"{spec.label}: {type(exc).__name__}: {exc}")
            raise
        problem = counter_set_error(cset)
        if problem:
            with watch_lock:
                kernel_faults.append(f"{spec.label}: {problem}")
        return cset

    def watched_chain(spec, device):
        cset = chain_collect(spec, device)
        if is_degraded(cset):
            with watch_lock:
                fallbacks.append(cset.meta.get("fallback_provider"))
        return cset

    svc.kernel.collect = watched_kernel
    svc.provider.collect = watched_chain

    def post(job):
        try:
            return 200, ServiceClient("127.0.0.1", port,
                                      timeout_s=300).submit(job)
        except ServiceError as exc:
            return exc.status, exc.body

    try:
        jobs = mixed_burst(burst, np.random.default_rng(0),
                           sizes=(1 << 14, 1 << 15, 1 << 16), histogram=True,
                           validate_providers=None)
        before = launched()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            results_ = list(pool.map(post, jobs))
        seconds["service/chaos"] = time.perf_counter() - t0
        got = delta(before)
        degraded = [b for _, b in results_ if b.get("degraded")]
        faults = svc.fault.stats_snapshot()
        cache = svc.cache.stats()
        log(f"  service chaos: {len(jobs)} jobs from 8 threads, "
            f"{seconds['service/chaos']:.3f} s, launches {got}; "
            f"{len(degraded)} degraded, counters {svc.counters}, "
            f"faults {faults}, {len(fallbacks)} fallbacks, "
            f"{len(kernel_faults)} kernel errors, cache {cache['entries']} "
            f"entries, {cache['quarantined']} quarantined")
        _require([st for st, _ in results_] == [200] * len(jobs),
                 f"chaos statuses {sorted({st for st, _ in results_})}")
        _require(degraded and all(b["fallback_providers"] == ["trace"]
                                  for b in degraded),
                 f"chaos: degraded responses "
                 f"{[b['fallback_providers'] for b in degraded]}")
        _require(svc.counters["failed"] == 0 and faults["faults"] > 0
                 and cache["quarantined"] == 0
                 and all(got.get(k) for k in path_kernels),
                 f"chaos: counters {svc.counters}, faults {faults}, "
                 f"cache {cache}, launches {got}")
        _require(not kernel_faults, "chaos: the kernel provider failed "
                 f"{len(kernel_faults)} time(s): {kernel_faults[:5]}")
        _require(len(fallbacks) == faults["faults"] + faults["corrupt"]
                 and set(fallbacks) <= {"trace"},
                 f"chaos: {len(fallbacks)} fallbacks {sorted(set(fallbacks))}"
                 f" against {faults['faults']} injected faults and "
                 f"{faults['corrupt']} corruptions")
        warm = [j for j in jobs if j["kind"] in ("profile", "sweep")]
        stats = svc.session("v5e").stats_snapshot()
        before = launched()
        with ThreadPoolExecutor(max_workers=8) as pool:
            again = list(pool.map(post, warm))
        after = svc.session("v5e").stats_snapshot()
        log(f"  service chaos, warm: {len(warm)} profile/sweep jobs again, "
            f"{after['collected'] - stats['collected']} collected, "
            f"launches {delta(before)}")
        _require([st for st, _ in again] == [200] * len(warm)
                 and after["collected"] == stats["collected"]
                 and after["batch_calls"] == stats["batch_calls"]
                 and launched() == before,
                 f"chaos warm resubmission: {stats} -> {after}")
    finally:
        closed(svc, server)

    # (c) the real entry points, as processes
    env = {**os.environ, "PYTHONPATH": str(SRC),
           "REPRO_TORCH_RESULTS": str(results / "daemon")}
    port_file = results / "daemon.port"
    device_flag = [] if dev == "cuda" else ["--torch-device", dev]
    t0 = time.perf_counter()
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "serve", "--provider",
         "kernel", "--fallbacks", "trace", "--port", "0", "--port-file",
         str(port_file), "--workers", "2", *device_flag],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        while not port_file.exists() and daemon.poll() is None \
                and time.perf_counter() - t0 < 180:
            time.sleep(0.05)
        _require(port_file.exists(), f"serve did not bind: rc "
                 f"{daemon.poll()}")
        seconds["service/serve start"] = time.perf_counter() - t0
        job = {"kind": "validate",
               "workload": {"workload": "histogram", "pixels": px_main,
                            "dist": "solid", "waves_per_tile": 32}}
        bodies = []
        for argv in (["health"], ["submit", "--job", json.dumps(job)]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch", "client", "--port",
                 port_file.read_text(), *argv], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            seconds[f"service/client {argv[0]}"] = time.perf_counter() - t0
            _require(proc.returncode == 0,
                     f"client {argv[0]}: rc {proc.returncode} "
                     f"{proc.stderr[-2000:]}")
            bodies.append(json.loads(proc.stdout))
        health, body = bodies
        measured = body["result"]["comparisons"][1]
        _require(health == {"ok": True} and body["degraded"] is False
                 and measured["provider"] == "kernel"
                 and measured["rel_err"]["e"] == 0.0,
                 f"client submit: {body}")
    finally:
        t0 = time.perf_counter()
        daemon.send_signal(signal.SIGINT)
        try:
            rc = daemon.wait(10)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
            rc = None
    seconds["service/serve stop"] = time.perf_counter() - t0
    listening = daemon.stdout.read().strip()
    log(f"  serve and client as processes: {listening}; health and a "
        f"validate job (e rel err 0.0, not degraded); SIGINT -> rc {rc}")
    _require(rc == 0 and listening.startswith(
        "repro-serve: listening on http://127.0.0.1:"),
        f"serve exit: rc {rc}, {daemon.stderr.read()[-2000:]}")
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return seconds


def audit_path(dev, results: Path, cache_dir) -> int:
    """The static audit of HLO text, as ``python -m repro_torch audit
    --hlo-file`` runs it, on each HLO text of ``tests/data`` that
    ``tests/_audit_specs.PINNED`` lists with its findings: in-process
    through ``repro_torch.cli.main.main``, in json and SARIF, with
    ``--advise``, and gated by ``--fail-on error``; then ``profile
    --workload hlo`` (the ``hlo`` provider's verdict).  None of it may
    launch a kernel, and the findings and ``--fail-on error`` code must
    be the reference's.  Then each distinct finding spec (by fingerprint)
    through ``Session.validate(spec, ("trace", "kernel"))`` with the
    kernel on ``dev``: K6 once a spec, e relative error exactly 0.0.
    A spec whose segment axis K6 takes only widened to whole blocks is
    validated so (``tests/_audit_specs.py``), with the trace provider's
    counters of both held bit-equal.

    Returns the number of specs validated (K6's launches on this path).
    """
    import gzip

    sys.path.insert(0, str(ROOT / "tests"))
    from _audit_specs import PINNED, distinct_specs, kernel_ready

    from repro_torch.analysis import Session
    from repro_torch.analysis.providers import InstrumentedKernelProvider
    from repro_torch.cli.main import main as cli_main
    from repro_torch.core import counters
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk

    def launched() -> dict:
        return {**hk.LAUNCHES, **sk.LAUNCHES}

    def cli(name, *argv) -> tuple[int, str]:
        """One command's exit code and stdout; its host seconds logged."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([str(a) for a in argv]
                          + ["--torch-device", dev, "--cache-dir",
                             str(cache_dir)])
        log(f"  cli {name}: {time.perf_counter() - t0:.3f} s, rc {rc}")
        return rc, buf.getvalue()

    kernel = InstrumentedKernelProvider(torch_device=dev)
    hlo_dir = results / "hlo"
    hlo_dir.mkdir(parents=True, exist_ok=True)
    validated = 0
    for stem, (counts, n_specs) in PINNED.items():
        gate_rc = int(any(sev == "error" for _, sev in counts))
        text = gzip.decompress(
            (ROOT / "tests" / "data" / f"{stem}.hlo.gz").read_bytes()
        ).decode()
        path = hlo_dir / f"{stem}.hlo"
        path.write_text(text)
        before = launched()
        audit = ("audit", "--hlo-file", path)
        rc, out = cli(f"audit {stem} --format json", *audit, "--format",
                      "json", "--fail-on", "never")
        payload = json.loads(out)
        found = {}
        for row in payload["findings"]:
            key = (row["rule"], row["severity"])
            found[key] = found.get(key, 0) + 1
        _require(rc == 0 and found == counts,
                 f"audit {stem}: rc {rc}, findings {found}, want {counts}")
        log(f"    {stem}: {payload['sites_scanned']} sites from "
            f"{payload['instructions_scanned']} instructions, "
            f"{len(payload['findings'])} findings {payload['counts']}")
        rc, out = cli(f"audit {stem} --format sarif", *audit, "--format",
                      "sarif", "--fail-on", "never")
        doc = json.loads(out)
        (run,) = doc["runs"]
        ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
        _require(rc == 0 and doc["version"] == "2.1.0"
                 and len(run["results"]) == len(payload["findings"])
                 and all(ids[r["ruleIndex"]] == r["ruleId"]
                         for r in run["results"])
                 and ids[-5:] == [f"KERN00{i}" for i in range(1, 6)],
                 f"audit {stem} sarif: rc {rc}, rules {ids}")
        rc, out = cli(f"audit {stem} --advise", *audit, "--advise",
                      "--format", "sarif", "--fail-on", "never")
        (run,) = json.loads(out)["runs"]
        gating = [r for r in run["results"]
                  if r["level"] in ("warning", "error")]
        _require(rc == 0 and len(run["results"]) == len(payload["findings"])
                 and all("advise" in r["properties"] for r in gating),
                 f"audit {stem} --advise: rc {rc}, {gating}")
        best = max(gating, key=lambda r: r["properties"]["advise"][
            "predicted_speedup"])["properties"]["advise"]
        log(f"    --advise: {len(gating)} gating findings advised, best "
            f"x{best['predicted_speedup']:.3f} via {best['transforms']}")
        rc, _ = cli(f"audit {stem} --fail-on error", *audit, "--fail-on",
                    "error", "--no-artifact")
        _require(rc == gate_rc, f"audit {stem} --fail-on error: rc {rc}, "
                                f"want {gate_rc}")
        rc, out = cli(f"profile --workload hlo {stem}", "profile",
                      "--workload", "hlo", "--hlo-file", path, "--label",
                      stem, "--format", "json")
        (point,) = json.loads(out)["points"]
        meta = json.loads(out)["meta"][stem]
        _require(rc == 0 and point["bottleneck"] == "hbm"
                 and meta == {"unresolved_loops": 0},
                 f"profile --workload hlo {stem}: rc {rc}, {point}, {meta}")
        log(f"    hlo provider: hbm={point['U_hbm']!r} -> "
            f"{point['bottleneck']}{' (saturated)' * point['saturated']}")
        _require(launched() == before,
                 f"the audit of {stem} launched {launched()} (was {before})")

        # each finding's candidate stream through K6
        sess = Session("v5e", cache_dir=cache_dir)
        report = sess.audit(text, label=stem)
        _require(not any(sess.stats_snapshot().values())
                 and launched() == before,
                 f"Session.audit {stem}: {sess.stats_snapshot()}, "
                 f"launches {launched()}")
        specs = distinct_specs(report)
        _require(len(specs) == n_specs,
                 f"{stem}: {len(specs)} distinct specs, want {n_specs}")
        t0 = time.perf_counter()
        es = []
        for spec in specs.values():
            ready = kernel_ready(spec)
            if ready is not spec:
                _require(counters.bitwise_equal(
                    sess.collect(spec, "trace"),
                    sess.collect(ready, "trace")),
                    f"{spec.label}: widening the segment axis moved the "
                    f"counters")
            rep = sess.validate(ready, ("trace", kernel), check_batch=False)
            trace, measured = rep.comparisons
            _require(measured.rel_err["e"] == 0.0
                     and measured.counters["N"] == trace.counters["N"]
                     and measured.counters["O"] == trace.counters["O"],
                     f"validate {spec.label}: {rep.to_dict()}")
            es.append(measured.counters["e"])
            validated += 1
        if dev != "cpu":
            import torch
            torch.cuda.synchronize()
        log(f"    {len(specs)} finding specs through trace and K6 in "
            f"{time.perf_counter() - t0:.3f} s: e rel err 0.0, e "
            f"{sorted(set(es))}")
    return validated


def _serve_config(num_layers=None, dtype=None, arch=SERVE_ARCH, **changes):
    """``arch`` (qwen2-72b by default) with every width as published;
    depth, dtype and any other field as given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=num_layers or cfg.num_layers,
                               dtype=dtype or cfg.dtype, **changes)


def serving_reckoning(dev, cfg, n: int) -> dict:
    """The bytes a bf16 ``cfg`` of ``n`` layers holds at its peak in a
    prefill of PREFILL_B x PREFILL_T tokens, against the card's free
    memory.  The peak is the head: the weights, the bf16 logits and their
    f32 copy, and the last hidden state; the empty cache prefill makes is
    counted too, though it comes after the bf16 logits are freed.  A dense
    layer's own activations (about 2 GB at 8192 tokens) are freed before
    the head runs.  An MoE layer's are counted, and the larger of its peak
    and the head's counts: the expert-sorted rows, the (E, C, d) buffer,
    the three (E, C, f) products, the expert output, the rows gathered
    back (all bf16), the f32 combine values and the f32 combine."""
    import torch
    d, v = cfg.d_model, cfg.padded_vocab
    hd = cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    # bf16 bytes of one layer (projections, QKV bias, FFN or router and
    # experts, two norms), of its share of the empty cache, of the
    # embedding, head and final norm
    attn = d * (q + 2 * kv) + q * d + ((q + 2 * kv) if cfg.qkv_bias else 0)
    if cfg.is_moe:
        e, f = cfg.num_experts, cfg.d_expert
        ffn = 3 * d * f * (e + cfg.num_shared_experts) + d * e
    else:
        ffn = 3 * d * cfg.d_ff
    layer = (attn + ffn + 2 * d) * 2
    cache = 2 * PREFILL_B * kv * PREFILL_T * 2
    outside = ((1 if cfg.tie_embeddings else 2) * v * d + d) * 2
    tokens = PREFILL_B * PREFILL_T
    logits, hidden = tokens * v * (2 + 4), tokens * d * 2
    moe_layer = 0
    if cfg.is_moe:
        rows = tokens * cfg.top_k
        slots = e * max(1, int(rows / e * cfg.moe_capacity_factor))
        moe_layer = (rows * d * 2 * 2 + slots * (2 * d + 3 * f) * 2
                     + rows * d * 4 + tokens * d * 4)
    torch.cuda.empty_cache()  # what the allocator caches counts as free
    free, total = torch.cuda.mem_get_info(torch.device(dev))
    need = n * (layer + cache) + outside + max(logits, moe_layer) + hidden
    return {"free": free, "total": total, "layer": layer,
            "cache_per_layer": cache, "embed_and_head": outside,
            "logits": logits, "moe_layer": moe_layer, "hidden": hidden,
            "need": need, "margin": MEMORY_MARGIN}


def serving_path(dev) -> dict:
    """qwen2-72b served on one card: random weights drawn on the card from
    a seeded generator, ``make_prefill`` at 4 x 2048 tokens (each layer's
    attention through K8), ``generate``, and the decode route checked
    against the prefill route, in bf16 at the served depth and in f32 at
    two layers (the hard check, TF32 off).

    Returns the host-clock seconds of each step and what was measured.
    """
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.serve import step as serve_mod

    seconds, out = {}, {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    n = SERVE_LAYERS
    reckoning = serving_reckoning(dev, _serve_config(), n)
    _require(reckoning["need"] + MEMORY_MARGIN <= reckoning["free"],
             f"{n} qwen2-72b layers do not fit beside the prefill: "
             f"{reckoning}")
    cfg = _serve_config(num_layers=n)
    log(f"  {cfg.name}: {n} of {_serve_config().num_layers} layers (the rest "
        f"stand for further pipeline stages), widths as published: d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; memory "
        f"reckoning (bytes) {reckoning}")
    held_before = torch.cuda.memory_allocated()
    log(f"  allocated before the model: {held_before} bytes")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    tokens = make_batch(cfg, PREFILL_B, PREFILL_T, gen)["tokens"]
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    out.update(layers=n, weight_bytes=weight_bytes)
    log(f"  weights: {weight_bytes} bytes ({weight_bytes / 1e9:.2f} GB); "
        f"peak while drawing them {torch.cuda.max_memory_allocated()} bytes")
    step("init")
    torch.cuda.reset_peak_memory_stats()

    # prefill: the forward's logits and a fresh cache, K8 once per layer
    scfg = serve_mod.ServeConfig(max_len=PREFILL_T)
    before = fk.LAUNCHES["flash_attention"]
    with torch.no_grad():
        logits, cache = serve_mod.make_prefill(model, scfg)(params, tokens)
    step("prefill")
    launched = fk.LAUNCHES["flash_attention"] - before
    _require(launched == n, f"prefill launched K8 {launched} times for {n} "
                            f"layers")
    finite = _all_finite(logits)
    _require(logits.shape == (PREFILL_B, PREFILL_T, cfg.padded_vocab)
             and logits.dtype == torch.float32 and finite,
             f"prefill logits {tuple(logits.shape)} {logits.dtype}, finite "
             f"{finite}")
    peak = torch.cuda.max_memory_allocated()
    _require(peak - held_before <= reckoning["need"],
             f"prefill peak {peak - held_before} bytes above the reckoning "
             f"{reckoning['need']}")
    head = logits[:, :DECODE_PROMPT].clone()
    tail = logits[:, RAGGED_T - 100:RAGGED_T].clone()
    del logits, cache
    log(f"  prefill {PREFILL_B} x {PREFILL_T}: logits "
        f"{(PREFILL_B, PREFILL_T, cfg.padded_vocab)} f32, finite; K8 launched "
        f"{launched} times for {n} layers; peak memory {peak} bytes "
        f"(reckoned at most {held_before + reckoning['need']})")
    out["peak_memory_bytes"] = peak

    # decode: the normal entry point, prompt replayed then greedy tokens
    prompt = tokens[:, :DECODE_PROMPT]
    gen_scfg = serve_mod.ServeConfig(max_len=DECODE_PROMPT + DECODE_GEN)
    toks = serve_mod.generate(model, params, prompt, DECODE_GEN, gen_scfg)
    step("decode")
    _require(toks.shape == (PREFILL_B, DECODE_PROMPT + DECODE_GEN)
             and torch.equal(toks[:, :DECODE_PROMPT], prompt)
             and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
             f"generate returned {tuple(toks.shape)}")
    steps = DECODE_PROMPT + DECODE_GEN - 1
    log(f"  generate: {steps} decode steps of {PREFILL_B} tokens in "
        f"{seconds['decode']:.3f} s ({seconds['decode'] / steps * 1e3:.1f} ms "
        f"a step)")

    # the decode route (plain _sdpa over the cache) against the prefill
    # route (K8) at the same positions, teacher-forced, in bf16
    err, agree = _decode_vs_prefill(model, params, tokens, head)
    out.update(bf16_decode_max_abs=err, bf16_top1_agreement=agree)
    log(f"  bf16 at {n} layers, decode vs prefill logits over "
        f"{DECODE_PROMPT} positions: max |diff| {err:.4g}, top-1 agreement "
        f"{agree:.4f} (reported, not bounded: bf16 rounds differently on "
        f"the two routes)")
    step("agreement")

    # where the device time goes: one prefill, and one decode step at
    # context 1 and at the prefill's context (the last slot of a cache
    # of PREFILL_T slots filled with seeded values: the step's work
    # depends on the cache's size, not on what it holds)
    prefill_step = serve_mod.make_prefill(model, scfg)
    with torch.no_grad():
        out["profile_prefill"] = device_profile(
            lambda: prefill_step(params, tokens), f"prefill {PREFILL_B} x "
            f"{PREFILL_T}")
        small = model.init_cache(params, PREFILL_B, DECODE_PROMPT)
        out["profile_decode"] = device_profile(
            lambda: model.decode_step(params, tokens[:, :1], small, pos=0),
            f"decode step of {PREFILL_B} tokens at context 1")
        full = model.init_cache(params, PREFILL_B, PREFILL_T)
        fill = torch.Generator(device=dev).manual_seed(5)
        for c in full["layers"]:
            for name in ("k", "v"):
                c[name].copy_(torch.randn(c[name].shape, generator=fill,
                                          device=dev))
        out["profile_decode_full"] = device_profile(
            lambda: model.decode_step(params, tokens[:, -1:], full,
                                      pos=PREFILL_T - 1),
            f"decode step of {PREFILL_B} tokens at context {PREFILL_T}")
    del small, full
    step("profile")

    # T not a whole 128-key tile: K8 runs at the real T and masks its last
    # tile, and positions before the cut see the same keys as in the full
    # prefill, so their logits must be the same
    before = fk.LAUNCHES["flash_attention"]
    with torch.no_grad():
        ragged, _ = serve_mod.make_prefill(model, scfg)(
            params, tokens[:, :RAGGED_T])
    torch.cuda.synchronize()
    _require(fk.LAUNCHES["flash_attention"] - before == n
             and ragged.shape[1] == RAGGED_T
             and _all_finite(ragged),
             f"ragged prefill at T={RAGGED_T}")
    diff = _abs_err(ragged[:, -100:], tail)
    _require(diff == 0.0, f"ragged prefill T={RAGGED_T}: last 100 positions "
                          f"differ from the T={PREFILL_T} prefill by {diff}")
    log(f"  ragged prefill T={RAGGED_T}: finite, last 100 positions' "
        f"logits equal to the T={PREFILL_T} prefill's (max |diff| {diff!r})")
    out["ragged_vs_full_max_abs"] = diff
    del ragged, params, model, head, tail
    torch.cuda.empty_cache()
    step("ragged")

    # the hard check: f32 at full width, two layers, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = _serve_config(num_layers=F32_CHECK_LAYERS, dtype="float32")
    model = build_model(cfg32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = model.init(gen)
    tokens = make_batch(cfg32, F32_CHECK_B, F32_CHECK_T, gen)["tokens"]
    before = fk.LAUNCHES["flash_attention"]
    with torch.no_grad():
        fwd, _ = serve_mod.make_prefill(
            model, serve_mod.ServeConfig(max_len=F32_CHECK_T))(params, tokens)
    _require(fk.LAUNCHES["flash_attention"] - before == F32_CHECK_LAYERS,
             "f32 prefill did not run K8 once per layer")
    err, agree = _decode_vs_prefill(model, params, tokens, fwd)
    out.update(f32_decode_max_abs=err, f32_top1_agreement=agree)
    _require(err < DECODE_TOL, f"f32 decode vs prefill max |diff| {err} >= "
                               f"{DECODE_TOL}")
    log(f"  f32 at {F32_CHECK_LAYERS} layers, full width, TF32 off "
        f"(torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}): decode vs prefill logits "
        f"over {F32_CHECK_T} positions, max |diff| {err:.4g} < {DECODE_TOL}, "
        f"top-1 agreement {agree:.4f}")
    del params, model, fwd
    torch.cuda.empty_cache()
    step("f32 check")
    out["seconds"] = seconds
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    log(f"  serving: {json.dumps(out)}")
    return out


def _all_finite(x) -> bool:
    """``torch.isfinite(x).all()`` a slice at a time: on the whole of a
    5 GB f32 tensor it would hold about 9 GB of temporaries."""
    import torch
    flat = x.reshape(-1)
    return all(bool(torch.isfinite(part).all())
               for part in flat.split(1 << 26))


# an MoE step's device time by part: K5, K7 and K8 by their kernels'
# names, the rest by the torch operator that launched the kernels (each
# kernel under the outermost of them only: argsort runs aten::sort, an
# index_put_ runs aten::_index_put_impl_)
MOE_PROFILE_PARTS = {
    "K5 combine": ("kernel", ("scatter_owned_kernel", "scatter_tiles_kernel",
                              "scatter_rows_kernel")),
    "K7 dispatch count": ("kernel", ("bincount_kernel",
                                     "bincount_zero_kernel")),
    "K8 attention": ("kernel", ("flash_f32_kernel", "flash_bf16_kernel",
                                "flash_bf16_sm90_kernel")),
    "bmm (experts)": ("op", ("aten::bmm",)),
    "mm (projections, router, head)": ("op", ("aten::mm",)),
    "sort": ("op", ("aten::sort",)),
    "gather": ("op", ("aten::index",)),
    "index_put": ("op", ("aten::index_put_",)),
}


def device_profile(fn, label: str, top: int = 6, parts=None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host wall time, device
    time (the sum of the CUDA kernels' own times, which one stream runs one
    after another), the idle share 1 - device / wall, and the kernels that
    took most of it.  The profiler's own host cost lengthens the wall
    time, so the idle share is an upper bound.  ``parts`` (name -> kind,
    patterns) adds each part's device ms and share: ``"kernel"`` parts sum
    the kernels whose names hold a pattern, ``"op"`` parts the device time
    of the torch operators of those names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [(e.key[:70], e.count, e.self_device_time_total / 1e3)
            for e in kernels[:top]]
    if device_ms == 0:
        log(f"  profile {label}: the profiler saw no device time: not "
            f"measured")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}
    log(f"  profile {label}: wall {wall_ms:.2f} ms, device "
        f"{device_ms:.2f} ms, idle share <= {1 - device_ms / wall_ms:.3f}; "
        f"top kernels:")
    for name, count, ms in rows:
        log(f"    {ms:9.3f} ms {ms / device_ms:6.1%} x{count:<5d} {name}")
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1 - device_ms / wall_ms,
           "top": [{"kernel": n, "count": c, "ms": m} for n, c, m in rows]}
    if parts:
        ops = [e for e in events
               if e.device_type != torch.autograd.DeviceType.CUDA]
        shares = {}
        for name, (kind, patterns) in parts.items():
            if kind == "kernel":
                us = sum(e.self_device_time_total for e in kernels
                         if any(p in e.key for p in patterns))
            else:
                us = sum(e.device_time_total for e in ops
                         if e.key in patterns)
            shares[name] = {"ms": us / 1e3, "share": us / 1e3 / device_ms}
        rest = 1 - sum(v["share"] for v in shares.values())
        log("    by part: " + ", ".join(
            f"{n} {v['ms']:.3f} ms ({v['share']:.1%})"
            for n, v in shares.items()) + f", the rest {rest:.1%}")
        out["parts"] = shares
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _decode_vs_prefill(model, params, tokens, prefill_logits):
    """Teacher-forced ``decode_step`` logits at positions 0..P-1 against
    the prefill's: max |diff| and the share of equal argmaxes."""
    import torch
    positions = prefill_logits.shape[1]
    cache = model.init_cache(params, tokens.shape[0], positions)
    err, same = 0.0, 0
    with torch.no_grad():
        for t in range(positions):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1],
                                              cache, pos=t)
            want = prefill_logits[:, t]
            err = max(err, _abs_err(logits[:, 0], want))
            same += int((logits[:, 0].argmax(-1) == want.argmax(-1)).sum())
    return err, same / (positions * tokens.shape[0])


# ---------------------------------------------------------------------------
# 3. the MoE serving path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording_moe():
    """While open, ``moe.apply_local`` keeps its first call's (params, x,
    config, dispatch ids) — layer 0's of the first step run — and K7's
    launcher every count it returns, with the number of ids it counted.
    Both run and count their launches as they otherwise do."""
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.models import moe
    rec = {"first": None, "counts": []}
    apply_local, bincount = moe.apply_local, sk.bincount_launch

    def recorded_apply(p, x, cfg):
        out = apply_local(p, x, cfg)
        if rec["first"] is None:
            rec["first"] = (p, x, cfg, out[2])
        return out

    def recorded_bincount(ids, num_segments):
        counts = bincount(ids, num_segments)
        rec["counts"].append((ids.numel(), counts))
        return counts

    moe.apply_local, sk.bincount_launch = recorded_apply, recorded_bincount
    try:
        yield rec
    finally:
        moe.apply_local, sk.bincount_launch = apply_local, bincount


@contextlib.contextmanager
def uncounted():
    """The launches inside leave every count as it was: a kernel held
    against its plain version is not the path's launch."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk
    saved = [(m, dict(m.LAUNCHES)) for m in (fk, hk, sk)]
    try:
        yield
    finally:
        for m, counts in saved:
            m.LAUNCHES.update(counts)


def _moe_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.scatter_add import kernel as sk
    every = {**fk.LAUNCHES, **sk.LAUNCHES}
    return {k: every[k] for k in MOE_KERNELS}


def drop_shares(counted, num_experts: int, capacity_factor: float) -> list:
    """Each counted dispatch stream's share of rows past its capacity,
    from K7's counts (``recording_moe``'s ``counts``)."""
    shares = []
    for n, counts in counted:
        cap = max(1, int(n / num_experts * capacity_factor))
        shares.append(float((counts.long() - cap).clamp(min=0).sum()) / n)
    return shares


def live_moe_layer(p, x, mcfg, err: dict) -> dict:
    """One MoE layer's dispatch and combine recomputed on the card from
    its live input ``x`` (T, d): K7's counts against ``bincount_plain``
    bit for bit, and K5's combine within F32_TOL of ``scatter_add_plain``
    and of the reference's composition (the unsort, then the f32 einsum
    over the k slots).  Raises ``err``'s K5 entry; returns K7's and K5's
    inputs, the live shapes of phase 4's MoE rows."""
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.models import moe

    t, d = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    with torch.no_grad():
        gates, ids, _ = moe.route(p, x, mcfg)
        _, order, sorted_ids, xs, capacity = moe.dispatch(x, ids, mcfg)
        counts = sk.bincount_launch(sorted_ids, e)
        torch.cuda.synchronize()
        _require(torch.equal(counts, sk.bincount_plain(sorted_ids, e)),
                 f"K7 counts on the live dispatch, {t * k} -> {e}")
        y_sorted = moe._expert_ffn_grouped(p, xs, sorted_ids, e, capacity,
                                           mcfg)
        del xs
        vals, tok = moe.combine_inputs(y_sorted, gates, order, k)
        got = sk.scatter_add_launch(vals, tok, t)
        torch.cuda.synchronize()
        case = f"{tuple(vals.shape)} f32 -> {t}"
        plain = sk.scatter_add_plain(vals, tok, t)
        torch.testing.assert_close(got, plain, **F32_TOL,
                                   msg=f"K5 vs plain, live combine {case}")
        err_plain = _abs_err(got, plain)
        del plain
        y = y_sorted[torch.argsort(order, stable=True)]
        del y_sorted
        want = torch.einsum("tkd,tk->td", y.reshape(t, k, d).float(), gates)
        del y
        torch.testing.assert_close(got, want, **F32_TOL,
                                   msg=f"K5 vs the reference's composition, "
                                       f"live combine {case}")
        err_ref = _abs_err(got, want)
    err["scatter_add"] = max(err["scatter_add"], err_plain, err_ref)
    log(f"    layer 0 live: K7 {t * k} ids -> {e} bit-equal (largest count "
        f"{int(counts.max())}, capacity {capacity}); K5 "
        f"{sk.scatter_add_route(vals, t)} {case} max |err| {err_plain:.3g} "
        f"vs plain, {err_ref:.3g} vs unsort + einsum")
    return {"dispatch": (sorted_ids, e), "combine": (vals, tok, t),
            "largest": int(counts.max()), "capacity": capacity}


def moe_serving_model(dev, arch: str, n, sess, err: dict):
    """One MoE model at every published width, ``n`` layers (None: all),
    random bf16 weights drawn on the card (seed 0), weights and prefill
    reckoned against the free memory first: ``make_prefill`` at 4 x 2048
    and at the ragged 2000, ``generate`` 16 + 16, K8, K7 and K5 counted
    per step; layer 0's live dispatch and combine held against their
    plain versions; layer 0's dispatch stream validated through the
    paper's tool (K6); a profile of a prefill and of a decode step; then
    the hard check in f32 at two layers, TF32 off, with a capacity
    factor at which nothing drops.

    Returns (what was measured, the live rows for phase 4).
    """
    import torch

    from repro_torch.analysis import WorkloadSpec
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.serve import step as serve_mod

    seconds, out, live = {}, {}, {}
    t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    def run(what, fn, want):
        """``fn()`` recorded, its launches held to ``want``."""
        before = _moe_launches()
        with recording_moe() as rec, torch.no_grad():
            result = fn()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _moe_launches().items()
               if v != before[k]}
        _require(got == want, f"{arch} {what}: launches {got}, expected "
                              f"{want}")
        return result, rec

    full = _serve_config(arch=arch)
    n = n or full.num_layers
    e, k = full.num_experts, full.top_k
    cfg = _serve_config(num_layers=n, arch=arch)
    reckoning = serving_reckoning(dev, cfg, n)
    _require(reckoning["need"] + MEMORY_MARGIN <= reckoning["free"],
             f"{n} {arch} layers do not fit beside the prefill: {reckoning}")
    log(f"  {arch}: {n} of {full.num_layers} layers, widths as published: "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.head_dim}, {e} experts x {cfg.d_expert} top-{k}, vocab "
        f"{cfg.padded_vocab}, capacity factor {cfg.moe_capacity_factor}; "
        f"memory reckoning (bytes) {reckoning}")
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    tokens = make_batch(cfg, PREFILL_B, PREFILL_T, gen)["tokens"]
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    out.update(layers=n, weight_bytes=weight_bytes)
    log(f"  weights: {weight_bytes} bytes ({weight_bytes / 1e9:.2f} GB); "
        f"peak while drawing them {torch.cuda.max_memory_allocated()} bytes")
    step("init")
    torch.cuda.reset_peak_memory_stats()

    # prefill: K8, K7 and K5 once a layer
    per_layer = {"flash_attention": n, "bincount": n, "scatter_add": n}
    prefill = serve_mod.make_prefill(model,
                                     serve_mod.ServeConfig(max_len=PREFILL_T))
    (logits, cache), rec = run("prefill", lambda: prefill(params, tokens),
                               per_layer)
    step("prefill")
    finite = _all_finite(logits)
    _require(logits.shape == (PREFILL_B, PREFILL_T, cfg.padded_vocab)
             and logits.dtype == torch.float32 and finite,
             f"{arch} prefill logits {tuple(logits.shape)} {logits.dtype}, "
             f"finite {finite}")
    peak = torch.cuda.max_memory_allocated()
    _require(peak - held_before <= reckoning["need"],
             f"{arch} prefill peak {peak - held_before} bytes above the "
             f"reckoning {reckoning['need']}")
    drops = drop_shares(rec["counts"], e, cfg.moe_capacity_factor)
    head = logits[:, :DECODE_PROMPT].clone()
    tail = logits[:, RAGGED_T - 100:RAGGED_T].clone()
    del logits, cache
    out.update(peak_memory_bytes=peak, prefill_drop_share=drops)
    log(f"  prefill {PREFILL_B} x {PREFILL_T}: logits "
        f"{(PREFILL_B, PREFILL_T, cfg.padded_vocab)} f32, finite; launches "
        f"{per_layer}; peak memory {peak} bytes (reckoned at most "
        f"{held_before + reckoning['need']}); rows dropped past the capacity "
        f"a layer: {min(drops):.4f}-{max(drops):.4f} of {PREFILL_B * PREFILL_T * k}")
    p0, x0, mcfg, flat0 = rec["first"]
    del rec
    with uncounted():
        rows = live_moe_layer(p0, x0, mcfg, err)
    del p0, x0
    tag = f"{MOE_SHORT[arch]} {PREFILL_B * PREFILL_T * k // 1024}Ki"
    live[f"{tag} -> {e} (live dispatch)"] = ("bincount", *rows["dispatch"])
    live[f"{tag} x {cfg.d_model} f32 -> {PREFILL_B * PREFILL_T} (live "
         f"combine)"] = ("scatter_add", *rows["combine"])
    step("layer 0")

    # the live dispatch through the paper's tool: layer 0's stream, its
    # counters read from K6, against the trace provider's
    ids_np = flat0.cpu().numpy()
    before = sk.LAUNCHES["scatter_add_instrumented"]
    spec = WorkloadSpec.from_scatter_add(
        ids_np, np.ones((ids_np.size, 1), np.float32), e,
        label=f"{arch} layer 0 dispatch", waves_per_tile=32)
    rep = sess.validate(spec, providers=("trace", "kernel"))
    e_err = rep.rel_err("kernel", "e")
    prof = sess.profile(spec)
    verdict = sess.last.verdicts[0]
    k6 = sk.LAUNCHES["scatter_add_instrumented"] - before
    _require(e_err == 0.0 and rep.max_rel_err == 0.0 and k6 > 0,
             f"{arch} live dispatch validate: e rel err {e_err}, max rel err "
             f"{rep.max_rel_err}, K6 launches {k6}")
    out["live_dispatch"] = {"ids": int(ids_np.size), "e": prof.e,
                            "U": prof.scatter_utilization,
                            "bottleneck": prof.bottleneck,
                            "verdict": verdict.comment}
    log(f"  live dispatch {ids_np.size} ids -> {e} through Session.validate "
        f"(trace, kernel): e rel err {e_err!r}, max rel err 0.0, K6 launched "
        f"{k6}; e {prof.e!r}, U {prof.scatter_utilization!r}, "
        f"{prof.bottleneck}: {verdict.comment}")
    step("validate")

    # T not a whole 128-key tile; the capacity follows the tokens, so the
    # logits before the cut are reported beside the full prefill's
    (ragged, _), _ = run("ragged prefill",
                         lambda: prefill(params, tokens[:, :RAGGED_T]),
                         per_layer)
    _require(ragged.shape[1] == RAGGED_T and _all_finite(ragged),
             f"{arch} ragged prefill at T={RAGGED_T}")
    diff = _abs_err(ragged[:, -100:], tail)
    del ragged, tail
    out["ragged_vs_full_max_abs"] = diff
    log(f"  ragged prefill T={RAGGED_T}: finite, launches {per_layer}; last "
        f"100 positions' logits against the T={PREFILL_T} prefill's: max "
        f"|diff| {diff!r} (reported: another capacity drops other rows)")
    step("ragged")

    # decode: the normal entry point, prompt replayed then greedy tokens
    prompt = tokens[:, :DECODE_PROMPT]
    steps = DECODE_PROMPT + DECODE_GEN - 1
    toks, rec = run("generate", lambda: serve_mod.generate(
        model, params, prompt, DECODE_GEN,
        serve_mod.ServeConfig(max_len=DECODE_PROMPT + DECODE_GEN)),
        {"bincount": steps * n, "scatter_add": steps * n})
    step("decode")
    _require(toks.shape == (PREFILL_B, DECODE_PROMPT + DECODE_GEN)
             and torch.equal(toks[:, :DECODE_PROMPT], prompt)
             and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
             f"{arch} generate returned {tuple(toks.shape)}")
    drops = drop_shares(rec["counts"], e, cfg.moe_capacity_factor)
    del rec
    out["decode_drop_share_mean"] = statistics.fmean(drops)
    log(f"  generate: {steps} decode steps of {PREFILL_B} tokens in "
        f"{seconds['decode']:.3f} s ({seconds['decode'] / steps * 1e3:.1f} ms "
        f"a step); K7 and K5 {steps * n} launches each; rows dropped past "
        f"the capacity {max(1, int(PREFILL_B * k / e * cfg.moe_capacity_factor))}"
        f": {out['decode_drop_share_mean']:.4f} of {PREFILL_B * k} a layer "
        f"and step, on average")
    err_bf16, agree = _decode_vs_prefill(model, params, tokens, head)
    out.update(bf16_decode_max_abs=err_bf16, bf16_top1_agreement=agree)
    log(f"  bf16 at {n} layers, decode vs prefill logits over "
        f"{DECODE_PROMPT} positions: max |diff| {err_bf16:.4g}, top-1 "
        f"agreement {agree:.4f} (reported, not bounded: a decode step's "
        f"capacity drops other rows, as in the reference)")
    step("agreement")

    # a decode step's layer 0 live, and where the device time goes
    small = model.init_cache(params, PREFILL_B, DECODE_PROMPT)
    with recording_moe() as rec, torch.no_grad():
        model.decode_step(params, tokens[:, :1], small, pos=0)
    p0, x0, mcfg, _ = rec["first"]
    del rec
    with uncounted():
        rows = live_moe_layer(p0, x0, mcfg, err)
    del p0, x0
    ids = PREFILL_B * k
    live[f"{MOE_SHORT[arch]} decode {ids} -> {e} (live dispatch)"] = (
        "bincount", *rows["dispatch"])
    live[f"{MOE_SHORT[arch]} decode {ids} x {cfg.d_model} f32 -> "
         f"{PREFILL_B} (live combine)"] = ("scatter_add", *rows["combine"])
    with torch.no_grad():
        out["profile_prefill"] = device_profile(
            lambda: prefill(params, tokens),
            f"{arch} prefill {PREFILL_B} x {PREFILL_T}",
            parts=MOE_PROFILE_PARTS)
        out["profile_decode"] = device_profile(
            lambda: model.decode_step(params, tokens[:, :1], small, pos=0),
            f"{arch} decode step of {PREFILL_B} tokens at context 1",
            parts=MOE_PROFILE_PARTS)
    del small, head, toks, params, model
    torch.cuda.empty_cache()
    step("profile")

    # the hard check: f32 at two layers, TF32 off, capacity factor E so
    # that the capacity is every row and nothing drops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = _serve_config(num_layers=F32_CHECK_LAYERS, dtype="float32",
                          arch=arch, moe_capacity_factor=float(e))
    model = build_model(cfg32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = model.init(gen)
    tokens = make_batch(cfg32, F32_CHECK_B, F32_CHECK_T, gen)["tokens"]
    two = {"flash_attention": F32_CHECK_LAYERS,
           "bincount": F32_CHECK_LAYERS, "scatter_add": F32_CHECK_LAYERS}
    (fwd, _), rec = run("f32 prefill", lambda: serve_mod.make_prefill(
        model, serve_mod.ServeConfig(max_len=F32_CHECK_T))(params, tokens),
        two)
    counted = list(rec["counts"])
    p0, x0, mcfg, _ = rec["first"]
    del rec
    with uncounted():
        rows = live_moe_layer(p0, x0, mcfg, err)
    del p0, x0, rows
    with recording_moe() as rec:
        err32, agree32 = _decode_vs_prefill(model, params, tokens, fwd)
    counted += rec["counts"]
    del rec
    dropped = drop_shares(counted, e, float(e))
    _require(max(dropped) == 0.0, f"{arch} f32 check dropped rows: {dropped}")
    _require(err32 < DECODE_TOL, f"{arch} f32 decode vs prefill max |diff| "
                                 f"{err32} >= {DECODE_TOL}")
    out.update(f32_decode_max_abs=err32, f32_top1_agreement=agree32)
    log(f"  f32 at {F32_CHECK_LAYERS} layers, full width, TF32 off, capacity "
        f"factor {float(e)}: no row dropped in {len(counted)} K7 counts; "
        f"decode vs prefill logits over {F32_CHECK_T} positions, max |diff| "
        f"{err32:.4g} < {DECODE_TOL}, top-1 agreement {agree32:.4f}")
    del params, model, fwd
    torch.cuda.empty_cache()
    step("f32 check")
    out["seconds"] = seconds
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return out, live


def moe_serving_path(dev, tables_dir, err: dict):
    """Both MoE models through ``moe_serving_model``, one after the
    other, with one ``Session`` (the ``"kernel"`` provider on the card)
    for the live dispatch.  Returns (what was measured by model, the live
    rows of both)."""
    from repro_torch.analysis import Session

    sess = Session("v5e", cache_dir=tables_dir, provider="kernel")
    measured, live = {}, {}
    for arch, _, n in MOE_SERVE:
        measured[arch], rows = moe_serving_model(dev, arch, n, sess, err)
        live.update(rows)
        log(f"  {arch}: {json.dumps(measured[arch])}")
    return measured, live


# ---------------------------------------------------------------------------
# 4. times
# ---------------------------------------------------------------------------


COLD_BYTES = 128 << 20     # written before a cold call: more than L2's 50 MB


def time_ms(fn, reps: int, warmup: int = 3, cold: bool = False) -> float:
    """Median device time of one call, by CUDA events around each call.

    A short sleep on the stream before the start event lets the host
    enqueue the call before the card reaches it, so the events time the
    card's work and not the wrapper's host overhead.  ``cold``: a 128 MB
    buffer is written on the stream before the sleep, untimed, so that
    the call finds its inputs in device memory and not in L2.
    """
    import torch
    evict = (torch.empty(COLD_BYTES // 4, dtype=torch.int32, device="cuda")
             if cold else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for rep in range(reps):
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


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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
    cold = f" (cold {row['cold_ms']:.4f})" if "cold_ms" in row else ""
    log(f"  {name:18s} {case:14s} kernel {row['ms']:.4f} ms{cold}  "
        f"plain {row['plain_ms']:.4f} ms  library {lib} ms  "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


def time_scatter_kernels(dev, live=None) -> dict:
    """Times of K5-K7 at the scatter path's shapes (K6 also at the audit
    path's), and of K5 and K7 on the MoE serving path's live inputs (``live``: case -> ("bincount",
    ids, S) or ("scatter_add", f32 values, ids, S)).

    Bytes: each value and id read once, each output written once.
    Operations: one f32 add per (row, d) update that lands.  The library
    yardsticks: ``Tensor.index_add_`` on f32 values (cast outside the
    timed call; every id here is in range, which it needs) for K5,
    ``torch.bincount`` for K7, none for K6.  K7's rows are also timed
    cold (``cold_ms``: its ids in device memory, not in L2).
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
        if name == "bincount":  # and with its ids in device memory
            row["cold_ms"] = time_ms(kernel, reps=25, cold=True)
        out[name][case] = row
        _log_row(name, case, row)

    def k7(case, ids_np, segments):
        ids = torch.as_tensor(ids_np, device=dev)  # a tensor stays as it is
        ids64 = ids.to(torch.int64)
        record("bincount", case,
               lambda: sk.bincount_launch(ids, segments),
               lambda: sk.bincount_plain(ids, segments),
               lambda: torch.bincount(ids64, minlength=segments),
               ids.numel() * 4 + segments * 4, ids.numel())

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
        k7(f"{kind} 4Mi -> 8192", scatter_ids(kind, segments=8192), 8192)
    for case, ids_np, segments in audit_streams():
        n = ids_np.size
        stream = torch.as_tensor(ops.committed_id_stream(ids_np, segments),
                                 device=dev)
        ones = torch.ones((n, 1), device=dev)
        record("scatter_add_instrumented", case,
               lambda: sk.scatter_add_instrumented_launch(ones, stream,
                                                          segments),
               lambda: sk.scatter_add_instrumented_plain(ones, stream,
                                                         segments),
               None, n * 4 + n * 4 + segments * 4 + n // 1024 * 4, n)
    ids_np = scatter_ids("skewed")
    ids = torch.as_tensor(ids_np, device=dev)
    ids64 = ids.to(torch.int64)
    vals = torch.as_tensor(rng.random((ids_np.size, 1), np.float32),
                           device=dev)
    n = ids_np.size
    record("scatter_add", "skewed 4Mi x 1 f32",
           lambda: sk.scatter_add_launch(vals, ids, segs),
           lambda: sk.scatter_add_plain(vals, ids, segs),
           lambda: torch.zeros((segs, 1), device=dev).index_add_(
               0, ids64, vals),
           n * 4 + n * 4 + segs * 4, n)
    k7("skewed 4Mi -> 8192", scatter_ids("skewed", segments=8192), 8192)
    k7("dispatch 64Ki -> 128", dispatch_ids("balanced"), EXPERTS)
    k7("dispatch collapsed 64Ki -> 128", dispatch_ids("collapsed"), EXPERTS)
    k7(f"decode {DECODE_IDS} -> 128", dispatch_ids("balanced")[:DECODE_IDS],
       EXPERTS)
    for case, (name, *args) in (live or {}).items():
        if name == "bincount":
            k7(case, *args)
            continue
        vals, ids, segments = args
        ids64 = ids.to(torch.int64)
        rows, d = vals.shape
        record("scatter_add", case,
               lambda: sk.scatter_add_launch(vals, ids, segments),
               lambda: sk.scatter_add_plain(vals, ids, segments),
               lambda: torch.zeros((segments, d), device=dev).index_add_(
                   0, ids64, vals),
               rows * d * 4 + rows * 4 + segments * d * 4, rows * d)
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


def time_flash_kernel(dev) -> dict:
    """K8 at the serving paths' prefill shapes (bf16, causal, 4 x 2048
    tokens): qwen2-72b's (GQA 64/8, d = 128), qwen3-moe's (64/4, d = 128)
    and granite-moe's (16/8, d = 64), the Hopper route at both head
    sizes.

    Operations: the useful causal products, 2 flop per multiply-add for
    QK^T and for P V over the T (T + 1) / 2 visible (query, key) pairs,
    against the dense bf16 tensor-core rate.  Bytes: q, k, v read once,
    the output written once.  The library yardstick is
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``,
    timed here only; the port never calls it.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    out = {}
    for arch in (SERVE_ARCH,) + tuple(arch for arch, _, _ in MOE_SERVE):
        cfg = _serve_config(arch=arch)
        b, h, kv, t, d = (PREFILL_B, cfg.num_heads, cfg.num_kv_heads,
                          PREFILL_T, cfg.head_dim)
        q, k, v = flash_case(b, h, kv, t, d, torch.bfloat16, dev, seed=5)
        group = h // kv
        flops = 4.0 * b * h * d * (t * (t + 1) / 2)
        nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
        bound_ms, bound_by = bound(nbytes, flops, BF16_OPS_PER_S)
        case = f"prefill {b}x{h}/{kv}x{t}x{d} bf16 causal"
        row = {
            "ms": time_ms(lambda: fk.flash_attention_launch(
                q, k, v, causal=True, group=group), reps=25),
            "plain_ms": time_ms(lambda: fk.attention_plain(
                q, k, v, causal=True, group=group), reps=5, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=25),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        _log_row("flash_attention", case, row)
        log(f"  K8 bound ({cfg.name}): {flops:.4g} useful flop / "
            f"{BF16_OPS_PER_S:.3g} flop/s = "
            f"{flops / BF16_OPS_PER_S * 1e3:.4f} ms; {nbytes:.4g} bytes / "
            f"{HBM_BYTES_PER_S:.3g} B/s = "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
            f"kernel at {flops / row['ms'] / 1e9:.1f} TFLOP/s useful, "
            f"{bound_ms / row['ms']:.3f} of the bound")
        out[case] = row
        del q, k, v
    return {"flash_attention": out}


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
    from repro_torch.kernels.flash_attention import kernel as fk
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
        func = name
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                func = _template_args(entry.group(1))
            elif any(w in line for w in ("registers", "spill", "warning")):
                log(f"  ptxas {func}: {line.split(':', 1)[-1].strip()}")
                # K4 and K5 (this design's warp sums) and K7 (its loads in
                # flight) must not spill
                spills = re.findall(r"(\d+) bytes spill", line)
                _require(not (func.startswith(("hist_weighted_kernel",
                                               "scatter_rows_kernel",
                                               "scatter_tiles_kernel",
                                               "scatter_owned_kernel",
                                               "bincount_"))
                              and any(int(b) for b in spills)),
                         f"{func} spills registers: {line.strip()}")
    for d in (64, 128):
        log(f"  flash_bf16_sm90_kernel<{d}>: {fk.shared_memory_bytes(d)} "
            f"bytes of dynamic shared memory a block")
    sass = {}
    for lib in sorted(logs):
        sass.update(sass_atomics(_build.library_path(lib)))
    for func, ops in sass.items():
        log(f"  SASS {func}: {' '.join(ops)}")
    # K2 keeps one shared atomic per pixel and step: no warp aggregation
    # (K4 and K5 aggregate f32 adds; K5's global route adds 16-byte parts)
    for func, ops in sass.items():
        if func.split("<")[0] == "hist_kernel":
            _require([op for op in ops if op.startswith(("ATOM", "RED"))]
                     == ["ATOMS.POPC.INC.32", "REDG.E.ADD.STRONG.GPU"]
                     and not any(op.startswith(("MATCH", "SHFL"))
                                 for op in ops), f"K2 {func}: SASS {ops}")
        if func.startswith("scatter_tiles_kernel<") and "vector" in func:
            _require(any(op.startswith("REDG") and "F32x4" in op
                         for op in ops), f"K5 {func}: no vector add in {ops}")
        # K7 counts with the POPC increment (no CAS loop); the grid route
        # adds each count to L2 once, the one-block route stores them
        if func.split("<")[0] == "bincount_kernel":
            atomics = [op for op in ops if op.startswith(("ATOM", "RED"))]
            flush = [] if "store" in func else ["REDG.E.ADD.STRONG.GPU"]
            _require(atomics == ["ATOMS.POPC.INC.32"] + flush,
                     f"K7 {func}: SASS {ops}")
    # K3 and K6 take K1's degree by a sort of shuffles, not MATCH.ANY
    for func, ops in sass.items():
        if func.split("<")[0] in ("hist_instrumented_kernel",
                                  "scatter_instrumented_kernel"):
            match = [op for op in ops if op.startswith("MATCH")]
            log(f"  {func}: MATCH {'present: ' + ' '.join(match) if match else 'absent'}")
    # K8's routes: f32 on no tensor-core op (a TF32 product would not be
    # f32); bf16 at d = 16, 32 on mma.sync; bf16 at d = 64, 128 on bf16
    # wgmma fed by TMA loads
    routes = {"flash_f32_kernel": 0, "flash_bf16_kernel": 0,
              "flash_bf16_sm90_kernel": 0}
    for func, ops in sass.items():
        name = func.split("<")[0]
        if name == "flash_f32_kernel":
            _require(not any(op.startswith(("HMMA", "HGMMA")) for op in ops),
                     f"{func} compiled to tensor-core ops {ops}")
        elif name == "flash_bf16_kernel":
            _require("HMMA.16816.F32.BF16" in ops, f"{func}: SASS {ops}")
        elif name == "flash_bf16_sm90_kernel":
            _require(any(op.startswith("HGMMA") and "F32.BF16" in op
                         for op in ops)
                     and any(op.startswith("UTMALDG") for op in ops),
                     f"{func}: SASS {ops}")
        routes[name] = routes.get(name, 0) + 1
    _require(all(routes[r] == n for r, n in (
        ("flash_f32_kernel", 4), ("flash_bf16_kernel", 2),
        ("flash_bf16_sm90_kernel", 2))), f"K8 instantiations {routes}")

    t0 = phase("kernels against their plain versions")
    err = check_kernels(dev, [(MAIN_PX, 4)] + [(n, 4) for n in PAD_PX]
                        + [(5000, 3), (70000, 3)])
    err.update(check_scatter_kernels(dev))
    check_adversarial(dev, err)
    err.update(check_flash_kernel(dev))
    log(f"  ok in {time.perf_counter() - t0:.1f} s; max |err| {err}")

    launches = {}
    by_path = {k: {} for k in KERNELS}   # each path's own launches
    with tempfile.TemporaryDirectory() as tmp:
        tables = Path(tmp) / "tables"
        # the CLI's artifacts and counter cache stay out of the checkout
        os.environ["REPRO_TORCH_RESULTS"] = str(Path(tmp) / "results")
        t0 = phase("main path: the histogram case study and the CLI")
        hk.reset_launches()
        sk.reset_launches()
        main_path(dev, "kernel", 1 << 18, MAIN_PX, COMPARE_PX, tables)
        torch.cuda.synchronize()
        launches.update({k: hk.LAUNCHES[k] for k in HIST_KERNELS})
        for k in HIST_KERNELS:
            by_path[k]["histogram"] = hk.LAUNCHES[k]
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{dict(hk.LAUNCHES)}")

        t0 = phase("main path: scatter-add, Tool 1 and the sweep cache")
        hk.reset_launches()
        sk.reset_launches()
        scatter_path(dev, "kernel", Path(tmp) / "cache", tables)
        torch.cuda.synchronize()
        launches.update({k: sk.LAUNCHES[k] for k in SCATTER_KERNELS})
        for k in SCATTER_KERNELS:
            by_path[k]["scatter"] = sk.LAUNCHES[k]
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{dict(sk.LAUNCHES)}")

        t0 = phase("main path: the profiling service")
        hk.reset_launches()
        sk.reset_launches()
        service_path(dev, Path(tmp), MAIN_PX, SCATTER_IDS, SCATTER_SEGMENTS)
        torch.cuda.synchronize()
        service = {k: {**hk.LAUNCHES, **sk.LAUNCHES}[k]
                   for k in SERVICE_KERNELS}
        _require(all(service.values()),
                 f"service path launched {service}")
        for k, n in service.items():
            by_path[k]["service"] = n
            launches[k] += n
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{dict(hk.LAUNCHES)} {dict(sk.LAUNCHES)}")

        t0 = phase("main path: the static audit of HLO text")
        hk.reset_launches()
        sk.reset_launches()
        n_specs = audit_path(dev, Path(tmp), tables)
        torch.cuda.synchronize()
        audit = {k: n for k, n in {**hk.LAUNCHES, **sk.LAUNCHES}.items()
                 if n}
        _require(audit == {k: n_specs for k in AUDIT_KERNELS}
                 and n_specs == 29,    # 4 + 4 + 10 + 11, the reference's
                 f"audit path launched {audit} for {n_specs} specs")
        for k in AUDIT_KERNELS:
            by_path[k]["audit"] = audit[k]
            launches[k] += audit[k]
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches {audit}")

    t0 = phase(f"main path: serving {SERVE_ARCH} prefill and decode")
    hk.reset_launches()
    sk.reset_launches()
    fk.reset_launches()
    serving = serving_path(dev)
    torch.cuda.synchronize()
    launches.update({k: fk.LAUNCHES[k] for k in SERVE_KERNELS})
    for k in SERVE_KERNELS:
        by_path[k]["serving"] = fk.LAUNCHES[k]
    log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
        f"{dict(fk.LAUNCHES)}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = phase("main path: serving MoE (qwen3-moe-235b-a22b, "
                   "granite-moe-1b-a400m) prefill and decode")
        hk.reset_launches()
        sk.reset_launches()
        fk.reset_launches()
        moe_serving, live = moe_serving_path(dev, Path(tmp) / "tables", err)
        torch.cuda.synchronize()
        moe_launches = {k: {**fk.LAUNCHES, **sk.LAUNCHES}[k]
                        for k in MOE_KERNELS}
        _require(all(moe_launches.values()),
                 f"MoE serving path launched {moe_launches}")
        for k, n in moe_launches.items():
            by_path[k]["moe"] = n
            launches[k] += n
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{moe_launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    _require(not missing, f"kernels not launched on the main path: {missing}")

    t0 = phase("times at the main paths' shapes")
    log(f"  card: {card}")
    # the floor of a launch-bound row: one launch of a kernel that does
    # nothing (the sleep kernel for 0 cycles), timed as every row is
    log(f"  empty kernel launch: "
        f"{time_ms(lambda: torch.cuda._sleep(0), reps=25):.4f} ms")
    times = time_kernels(dev)
    times.update(time_scatter_kernels(dev, live))
    del live
    times.update(time_flash_kernel(dev))
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
    cfg = _serve_config()
    heads["flash_attention"] = (
        f"prefill {PREFILL_B}x{cfg.num_heads}/{cfg.num_kv_heads}x{PREFILL_T}x"
        f"{cfg.head_dim} bf16 causal",
        f"q ({PREFILL_B}, {cfg.num_heads}, {PREFILL_T}, {cfg.head_dim}), k/v "
        f"({PREFILL_B}, {cfg.num_kv_heads}, {PREFILL_T}, {cfg.head_dim}) "
        f"bf16, causal; launches over {serving['layers']}-layer prefills "
        f"(bf16 T={PREFILL_T} and T={RAGGED_T}) and the f32 "
        f"{F32_CHECK_LAYERS}-layer check")
    heads["hist_instrumented"] = heads["hist_weighted"] = heads["hist"]
    heads["scatter_add_instrumented"] = heads["scatter_add"]
    # K1 has no launch of its own: it is a device function that K3 and K6
    # run inline, on every one of their launches
    k1 = {"name": "wave_degrees",
          "source": "src/repro_torch/kernels/csrc/wave_degrees.cuh",
          "replaces": "src/repro/kernels/instrumentation.py:24"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        case, shape = heads[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": by_path[name],
            "max_abs_err": err[name], **times[name][case],
            "shape": shape, "cases": times[name],
            **({"inlines": k1} if name.endswith("_instrumented") else {}),
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
