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
flash attention) and ``generate``; then two MoE LMs, then gemma2-27b
(local/global softcapped layers, all on the plain ``_sdpa``),
llama-3.2-vision-11b (gated image cross-attention; its self-attention in
K8) and whisper-small (its bidirectional encoder and causal decoder
prefill in K8), then rwkv6-7b (attention-free: no kernel launches) and
zamba2-1.2b (Mamba-2 layers; its shared attention block in K8 while the
prompt fits its window).  Last it trains: granite-moe-1b-a400m whole
through ``repro_torch.launch.train`` (each MoE layer's dispatch count in
K7 and its combine in K5 under autograd; attention on the plain path,
since K8 has no backward), its restart from a checkpoint, one step each
of whisper-small and zamba2-1.2b, and the training batch's tokens as the
embedding gradient's scatter through K6.  Last the multi-device paths
run on one-rank meshes: the MoE layers' expert-parallel and
tensor-parallel bodies, and granite's train step and prefill with
DTensor state.  Phases, each of which must pass:

0. the environment: the card's name and power limit, torch and CUDA;
1. build every kernel with nvcc (one process per source, in parallel),
   list the atomic and warp-wide opcodes each compiled to, and require
   that K2 kept one shared atomic per pixel and step, that K5's vector
   route adds 16 bytes at once, and that K4 and K5 spill no register;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at padded and odd shapes (K3-K6 also on the
   designed commit groups of ``repro_torch.data.streams``, K5 on each of
   its routes; K8 also at the reference test's shapes, blocks and bounds,
   on its Hopper route at ragged T, and at every serving path's shapes,
   Whisper's non-causal encoder at T = 1500 among them, before any model
   is on the card);
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
   then the zoo audit, then the kernel lint (``python -m repro_torch
   lint`` as processes with no card visible, ``lint_registry`` in process
   with no launch, K3's degrees on each static probe bit-equal to the
   lint's derivation, each KERN005 spec through K6, each declaration's
   combine classes against its kernel's SASS, and K2's times on the solid
   probe beside the lint's predicted speedup, printed only),
   then serving, then MoE serving
   (K7 and K5 on each model's live layer-0 tensors held against their
   plain versions there, outside the counts), then the families' serving
   (K8's launches held to each step's count; gemma2's window and ring at
   full width against their oracles), then rwkv6's and zamba2's (no
   launch for rwkv6; K8 held to zamba2's shared-attention invocations),
   then training (outside the counts first: K5 under autograd against
   its plain version forward and backward, every gradient leaf with K5
   against the plain combine, blockwise attention against dense; then
   granite's steps, K5 and K7 held to twice a layer a step and K8 to 0,
   the loss falling, one step profiled, the restart's replayed steps
   against their first pass, whisper-small's and zamba2's step moving
   every leaf, and the Zipf and uniform token streams through
   ``Session.validate``), then the mesh: a one-rank NCCL group on the
   card, qwen3-moe-235b-a22b's MoE layer at every published width
   through ``moe.apply_ep`` on a (1, 1, 1) ("pod", "data", "model") mesh
   and granite-moe-1b-a400m's through ``moe.apply_sharded`` on a (1, 1)
   mesh, each against ``apply_local`` on the same inputs (K7's counts
   on both bit-equal to ``bincount_plain``, the outputs within a bf16
   bound where both drop the same rows, each route's drop share), then
   granite whole with its train state as DTensors on the mesh: a step
   against the same step without one (xent within the spread that K5's
   atomic order gives repeated runs, and equal with a deterministic
   combine; K5 = K7 = 48 and K8 0 a step; the seconds of each), and a
   prefill (K8's launches equal, the argmax agreeing);
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
# the families' serving path: gemma2-27b at every published width with as
# many whole local/global pairs as the reckoning admits, llama-3.2-vision-11b
# and whisper-small whole, each with the serving path's prefill and decode;
# Whisper's decoder prompt is its own 448-token text context
# (arXiv:2212.04356) against its config's 1500 frames
FAMILY_SERVE = ("gemma2-27b", "llama-3.2-vision-11b", "whisper-small")
WHISPER_T = 448
# the families with O(1) state a token, whole, on the same path:
# rwkv6-7b (attention-free, arXiv:2404.05892) and zamba2-1.2b (38 Mamba-2
# layers and a shared attention block after every 6, arXiv:2411.15242)
SSM_SERVE = ("rwkv6-7b", "zamba2-1.2b")
# llama-vision's cross layers start with closed tanh gates, which would
# make them add nothing: every run here opens them (tanh 0.46 and -0.66)
GATES_OPEN = {"gate_attn": 0.5, "gate_ffn": -0.8}
# the RWKV and Mamba leaves that init sets to constants (RWKV's bonus u,
# its lerps; Mamba's A = -exp(a_log), dt bias, skip and conv bias), under
# which a dropped bonus diagonal or a per-head slip would pass: every run
# here sets each to a ramp (first, last) over its elements after init,
# with A in [-0.78, -0.14] so that a 64-token chunk's summed log-decay
# stays far inside the f32 range of the chunked SSD's exp(-cum)
SSM_LEAVES = {"mix": {"bonus": (-0.5, 0.5), "mix_base": (-0.3, 0.3),
                      "mix_x": (0.1, 0.4), "cm_mix_k": (0.2, 0.8),
                      "cm_mix_r": (0.8, 0.2)},
              "ssm": {"a_log": (-2.0, -0.25), "dt_bias": (0.5, -0.5),
                      "d_skip": (0.5, 1.5), "conv_b": (-0.1, 0.1)}}
# the f32 check's depths: one local/global pair, one group of 5 + 1 (a
# cross layer in it), 2 + 2 Whisper layers, 2 RWKV layers, and zamba2's
# first group of 6 Mamba layers, its shared block and 1 tail layer
F32_CHECK_DEPTH = {"gemma2-27b": dict(num_layers=2),
                   "llama-3.2-vision-11b": dict(num_layers=5),
                   "whisper-small": dict(num_layers=2, encoder_layers=2),
                   "rwkv6-7b": dict(num_layers=2),
                   "zamba2-1.2b": dict(num_layers=7)}
# gemma2's 4096-slot window at full width on one local layer: attention
# over T = 4608 tokens against a banded f64 oracle, and 4160 decode steps
# through a ring of 4096 slots against a buffer of 4160 (the reference's
# tests/test_models_decode.py::test_ring_buffer_window_cache)
WINDOW_T, WINDOW_TOL = 4608, 2e-4
RING_STEPS, RING_TOL = 4160, 1e-5
# K8's launches on the families' path: llama-vision's self-attention (GQA
# group 4, d = 128, causal), Whisper's encoder (1500 frames, not causal:
# only the key-length check masks its last tile of 92 keys) and decoder
# prefill (448 tokens, causal), and zamba2's shared attention (32/32,
# d = 64, causal: its window of 4096 masks nothing at T = 2048);
# (label, arch, T, causal)
FAMILY_K8_SHAPES = (
    ("llama-vision self-attention", "llama-3.2-vision-11b", PREFILL_T, True),
    ("whisper encoder", "whisper-small", 1500, False),
    ("whisper decoder", "whisper-small", WHISPER_T, True),
    ("zamba2 shared attention", "zamba2-1.2b", PREFILL_T, True))
# the training path: granite-moe-1b-a400m (examples/train_lm.py's model)
# whole at every published width, bf16 with an f32 master, TRAIN_STEPS
# steps of TRAIN_B x TRAIN_T tokens (the reference launcher's batch of 8 at
# the serving path's 2048), step TRAIN_PROFILE_STEP profiled; its
# restart at RESTART_LAYERS layers; one step each of whisper-small (448
# tokens over its 1500 frames) and zamba2-1.2b
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_PROFILE_STEP = 8, 2048, 10, 5
RESTART_LAYERS, RESTART_STEPS = 4, 12
RESTART_SAVE_EVERY, RESTART_FAIL_AT = 4, 10
REPLAY_RTOL = 1e-3                   # replayed xent against the first pass
ONE_STEP = (("whisper-small", TRAIN_B, WHISPER_T),
            ("zamba2-1.2b", PREFILL_B, PREFILL_T))
# the gradient check: granite at 2 layers in f32 on 4 x 2048 tokens; each
# leaf within GRAD_TOL x its largest |g| (K5 sums in no fixed order)
GRAD_CHECK_LAYERS, GRAD_CHECK_B, GRAD_TOL = 2, 4, 1e-4
K5_FWD_RTOL = 1e-5                   # K5 forward, of the largest sum
BLOCKWISE_TOL = 1e-5                 # blockwise against dense, f32
# the embedding gradient's rows: the 49,155 ids of granite's vocab into
# whole 4096-segment blocks, the scatter-add ops' rule
EMBED_SEGMENTS = 13 * 4096
TRAIN_KERNELS = ("scatter_add", "bincount", "scatter_add_instrumented")
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
    # the families' shapes, in bf16 as served and in f32 at the f32
    # check's size (its batch; Whisper's encoder keeps its 1500 frames)
    for label, arch, t, causal in FAMILY_K8_SHAPES:
        cfg = _serve_config(arch=arch)
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        t32 = t if not causal else F32_CHECK_T
        for dtype, b, tt in ((torch.bfloat16, PREFILL_B, t),
                             (torch.float32, F32_CHECK_B, t32)):
            check(f"{label} ({b}, {h}/{kv}, {tt}, {d}) {str(dtype)[6:]} "
                  f"causal={causal}", *flash_case(b, h, kv, tt, d, dtype, dev,
                                                  seed=8), causal, None, None)
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


ZOO_HOST_S = 180.0          # the zoo phase's host seconds, at most


def zoo_path(dev, results: Path, cache_dir) -> int:
    """The zoo audit at the production shapes (``train_4k``,
    ``prefill_32k``, ``decode_32k``), every config at full width: first
    as a user runs it, ``python -m repro_torch audit --all`` in a process
    of its own; then each config through ``audit_config`` in this
    process, its host seconds, sites and findings by rule and severity
    logged and its counts held to the process's report.  Each step is
    captured on meta tensors: none of it may launch a kernel.  Then each
    distinct finding spec (by fingerprint, over the zoo) through
    ``Session.validate(spec, ("trace", "kernel"))`` with the kernel on
    ``dev``: K6 once a spec (its segment axis in whole blocks,
    ``tests/_audit_specs.kernel_ready``), e relative error exactly 0.0.
    The phase's host seconds stay under ZOO_HOST_S.

    Returns the number of specs validated (K6's launches on this path).
    """
    import subprocess

    sys.path.insert(0, str(ROOT / "tests"))
    from _audit_specs import distinct_specs, kernel_ready

    from repro_torch.analysis import Session
    from repro_torch.analysis.providers import InstrumentedKernelProvider
    from repro_torch.audit import audit_config
    from repro_torch.configs import ARCHS
    from repro_torch.core import counters
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk

    def launched() -> dict:
        return {**hk.LAUNCHES, **sk.LAUNCHES}

    start = time.perf_counter()
    before = launched()
    env = dict(os.environ, PYTHONPATH=str(SRC),
               REPRO_TORCH_RESULTS=str(results / "zoo"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "audit", "--all",
         "--format", "json", "--fail-on", "error"],
        capture_output=True, text=True, env=env, timeout=600)
    cli_s = time.perf_counter() - t0
    _require(proc.returncode in (0, 1) and proc.stdout,
             f"audit --all: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    everything = json.loads(proc.stdout)
    graphs = sorted((results / "zoo" / "cli" / "audit" / "graph").iterdir())
    _require(len(graphs) == len(everything["steps"]),
             f"audit --all wrote {len(graphs)} graphs for "
             f"{len(everything['steps'])} steps")
    log(f"  python -m repro_torch audit --all: {cli_s:.3f} s host, rc "
        f"{proc.returncode}, {everything['sites_scanned']} sites from "
        f"{everything['instructions_scanned']} nodes, "
        f"{len(everything['findings'])} findings {everything['counts']}")

    sess = Session("v5e", cache_dir=cache_dir)
    specs = {}
    n_findings = 0
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        rep = audit_config(arch, session=sess)
        host = time.perf_counter() - t0
        by = {}
        for f in rep.findings:
            by[f"{f.rule_id}/{f.severity}"] = \
                by.get(f"{f.rule_id}/{f.severity}", 0) + 1
        kinds = {f.site.kind for f in rep.findings if f.site is not None}
        _require(rep.findings and "kv_cache_write" in kinds
                 or arch == "rwkv6-7b",
                 f"zoo audit {arch}: findings {by}, kinds {kinds}")
        if "moe" in arch:
            _require({"dispatch_scatter", "histogram_scatter"} <= kinds,
                     f"zoo audit {arch}: kinds {kinds}")
        log(f"    {arch}: {host:.3f} s host, steps {rep.steps}, "
            f"{rep.sites_scanned} sites from {rep.instructions_scanned} "
            f"nodes, findings {dict(sorted(by.items()))}")
        n_findings += len(rep.findings)
        for key, spec in distinct_specs(rep).items():
            specs.setdefault(key, spec)
    _require(n_findings == len(everything["findings"]),
             f"in process {n_findings} findings, audit --all "
             f"{len(everything['findings'])}")
    _require(not any(sess.stats_snapshot().values())
             and launched() == before,
             f"the zoo audit collected {sess.stats_snapshot()} and "
             f"launched {launched()} (was {before})")

    kernel = InstrumentedKernelProvider(torch_device=dev)
    t0 = time.perf_counter()
    es = []
    for spec in specs.values():
        ready = kernel_ready(spec)
        if ready is not spec:
            _require(counters.bitwise_equal(sess.collect(spec, "trace"),
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
    if dev != "cpu":
        import torch
        torch.cuda.synchronize()
    log(f"    {len(specs)} distinct finding specs through trace and K6 in "
        f"{time.perf_counter() - t0:.3f} s: e rel err 0.0, e "
        f"{sorted(set(es))}")
    host = time.perf_counter() - start
    log(f"  the zoo phase: {host:.3f} s host (at most {ZOO_HOST_S})")
    _require(host <= ZOO_HOST_S, f"the zoo phase took {host:.1f} s host")
    return len(specs)


LINT_HOST_S = 30.0          # the lint phase's host seconds, at most
# the lint launches nothing; K3 checks its static derivations, K6 its
# KERN005 specs
LINT_KERNELS = ("hist_instrumented", "scatter_add_instrumented")


def lint_path(dev, results: Path, cache_dir, sass: dict) -> dict:
    """The kernel lint: ``lint_registry`` in this process, which may
    neither launch a kernel nor collect a counter, then as a user runs
    it, ``python -m repro_torch lint`` as processes with no card visible
    to them, all four at once: text, json and SARIF at the default gate
    (exit code 1: KERN001 is an error on ``hist``) and ``--kernel hist2
    --fail-on warning`` (exit code 0).  All read the service-time table
    from ``cache_dir``, which the first builds if it must.  Then the lint
    held to the kernels it models (``tests/_lint_card.py``): K3 once on
    each static probe (``hist``, ``hist2``, ``hist_weighted`` on the
    solid image), its degrees bit-equal to the static derivation and its
    counters to the lint's; each KERN005 finding's spec through
    ``Session.validate(spec, ("trace", kernel))``, K6 once a spec, e
    relative error exactly 0.0; and each declaration's combine classes
    against the SASS of the instantiation its launcher runs.  Last, K2's
    times of ``hist`` and ``hist2`` on the solid probe, beside the lint's
    ``--advise`` predicted speedup (modeled for the TPU devices; printed,
    not gated), outside the counts.  The phase's host seconds stay under
    LINT_HOST_S.

    Returns the launches of the checks, by kernel.
    """
    sys.path.insert(0, str(ROOT / "tests"))
    import _lint_card

    import torch

    from repro_torch import audit as audit_mod
    from repro_torch.analysis import Session
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.lint import lint_kernel, lint_registry, registry

    def launched() -> dict:
        return {**hk.LAUNCHES, **sk.LAUNCHES, **fk.LAUNCHES}

    start = time.perf_counter()
    before = launched()
    sess = Session("v5e", cache_dir=cache_dir)
    hosts = []
    for _ in range(2):                   # cold (imports, table), then warm
        t0 = time.perf_counter()
        report = lint_registry(session=sess)
        hosts.append(time.perf_counter() - t0)
    by = {}
    for f in report.findings:
        key = f"{f.rule_id}/{f.severity}" + ("/suppressed" * f.suppressed)
        by[key] = by.get(key, 0) + 1
    _require(launched() == before and not any(sess.stats_snapshot().values()),
             f"linting launched {launched()} (was {before}), collected "
             f"{sess.stats_snapshot()}")
    log(f"  lint_registry in process: {hosts[0]:.3f} s host cold, "
        f"{hosts[1]:.3f} s warm, "
        f"{report.sites_scanned} sites, findings {dict(sorted(by.items()))}, "
        f"no launch, no collection")

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               REPRO_TORCH_RESULTS=str(results / "lint"))
    argvs = {"text": [], "json": ["--format", "json"],
             "sarif": ["--format", "sarif"],
             "hist2 --fail-on warning": ["--kernel", "hist2", "--fail-on",
                                         "warning"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "lint", *argv,
         "--cache-dir", str(cache_dir)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, argv in argvs.items()}
    outs = {}
    for k, proc in procs.items():
        out, errs = proc.communicate(timeout=120)
        outs[k] = (proc.returncode, out, errs)
    rcs = {k: rc for k, (rc, _, _) in outs.items()}
    _require(rcs == {"text": 1, "json": 1, "sarif": 1,
                     "hist2 --fail-on warning": 0},
             f"python -m repro_torch lint: rc {rcs}\n"
             + "\n".join(e[-2000:] for _, _, e in outs.values()))
    payload = json.loads(outs["json"][1])
    (run,) = json.loads(outs["sarif"][1])["runs"]
    ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    _require(payload["counts"] == {"error": 3, "warning": 0, "note": 2}
             and any(f["rule"] == "KERN001" and f["severity"] == "error"
                     and f["label"].startswith("hist-solid")
                     for f in payload["findings"])
             and len(run["results"]) == len(payload["findings"])
             and all(ids[r["ruleIndex"]] == r["ruleId"]
                     for r in run["results"])
             and "no findings" in outs["hist2 --fail-on warning"][1],
             f"lint reports: {payload['counts']}, {len(run['results'])} "
             f"SARIF results")
    log(f"  python -m repro_torch lint x4 (text, json, sarif, hist2 "
        f"--fail-on warning), no card visible: "
        f"{time.perf_counter() - t0:.3f} s host, rc {rcs}; "
        f"{payload['sites_scanned']} sites from "
        f"{payload['instructions_scanned']} operations, findings "
        f"{payload['counts']}")

    t0 = time.perf_counter()
    for row in _lint_card.k3_against_derivation(dev):
        log(f"    K3 {row['name']}-solid: {row['waves']} waves, degrees "
            f"bit-equal to the static derivation (mean {row['mean_degree']},"
            f" floor {row['floor_degree']}); N {row['N']!r}, O "
            f"{row['O']!r}, e {row['e']!r} equal to the lint's")
    for row in _lint_card.kern005_through_k6(sess, dev):
        log(f"    K6 {row['label']}: e rel err 0.0, e {row['e']!r}, "
            f"N {row['N']!r}")
    if dev != "cpu":
        torch.cuda.synchronize()
    log(f"  the lint's static derivations and KERN005 specs on K3 and K6: "
        f"{time.perf_counter() - t0:.3f} s")
    for row in _lint_card.declared_combines(sass):
        log(f"    {row['name']}: {row['kernel']} declares and compiled to "
            f"{row['combines']}")
    counted = {k: n for k, n in launched().items() if n}

    # K2 on the solid probe, outside the counts: printed beside the
    # model's prediction for the v5e, not gated
    hist = lint_kernel("hist", session=sess)
    audit_mod.attach_advice(hist, sess)
    advice = next(f.advice for f in hist.findings if f.rule_id == "KERN001")
    img = torch.as_tensor(registry.build_target("hist").operands[0],
                          device=dev)
    t = {v: time_ms(lambda r=(v == "hist2"): hk.histogram_launch(
        img, reorder=r), reps=50) for v in ("hist", "hist2")}
    log(f"  K2 on the solid probe ({img.shape[0]} px x {img.shape[1]}): "
        f"hist {t['hist']:.4f} ms, hist2 {t['hist2']:.4f} ms, measured "
        f"hist/hist2 x{t['hist'] / t['hist2']:.3f}; the lint's --advise "
        f"predicts x{advice['predicted_speedup']:.3f} via "
        f"{advice['transforms']} on the v5e model (not gated)")
    host = time.perf_counter() - start
    log(f"  the lint phase: {host:.3f} s host (at most {LINT_HOST_S})")
    _require(host <= LINT_HOST_S, f"the lint phase took {host:.1f} s host")
    return counted


def _serve_config(num_layers=None, dtype=None, arch=SERVE_ARCH, **changes):
    """``arch`` (qwen2-72b by default) with every width as published;
    depth, dtype and any other field as given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=num_layers or cfg.num_layers,
                               dtype=dtype or cfg.dtype, **changes)


def serving_reckoning(dev, cfg, n: int, t: int = PREFILL_T) -> dict:
    """The bytes a bf16 ``cfg`` of ``n`` layers holds at its peak in a
    prefill of PREFILL_B x ``t`` tokens, against the card's free memory.
    The peak is the head: the weights, the bf16 logits and their f32 copy
    (a final softcap caps that copy in place when no gradient is kept, so
    it adds no temporary; Whisper's logits stay bf16), and the last hidden
    state; the cache prefill makes is counted too, though it comes
    after the bf16 logits are freed.  A dense layer's own activations
    (about 2 GB at 8192 tokens) are freed before the head runs.  An MoE
    layer's are counted, and so are the f32 score tensors of a layer on
    ``_sdpa`` (softcapped, or attending to an image), three of them (the
    scores, their quotient by the cap and its tanh live at once; the
    masked and softmaxed successors two at a time), and the larger of
    these peaks and the head's counts.  The MoE layer's: the
    expert-sorted rows, the (E, C, d) buffer, the three (E, C, f)
    products, the expert output, the rows gathered back (all bf16), the
    f32 combine values and the f32 combine.  llama-vision's cross layers
    (``n // cross_attn_every``, each a dense layer with two f32 gates)
    hold their image K/V in the cache; Whisper's ``encoder_layers`` and
    decoder layers (self and cross attention, LayerNorms with a bias, QKV
    bias) hold their self-attention buffers and the cross K/V of the
    encoder states.  An RWKV-6 layer (no attention) holds its six d x d
    projections, its channel mix (2 d d_ff), its LoRAs and two f32
    vectors, and carries an f32 state of d x 64 a sequence; a Mamba-2
    layer holds its in_proj, conv and out_proj and carries its (H, 64, N)
    f32 state and conv ring; zamba2's shared block is held once, with a
    window cache for each of its ``n // attn_every`` invocations.  Their
    chunked WKV and SSD hold f32 intermediates of B x T x d (RWKV) or
    B x T x d_inner (Mamba; the (B, c, H, 64, 64) scores are as large):
    about 12 and 10 of them at once, counted as one layer's
    ``ssm_scratch``."""
    import torch
    d, v = cfg.d_model, cfg.padded_vocab
    hd = cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    # bf16 bytes of one layer (projections, QKV bias, FFN or router and
    # experts, two norms), of its share of the empty cache, of the
    # embedding, head and final norm
    attn = d * (q + 2 * kv) + q * d + ((q + 2 * kv) if cfg.qkv_bias else 0)
    norm = 2 * d if cfg.norm == "layernorm" else d
    dense_ffn = 3 * d * cfg.d_ff
    if cfg.is_moe:
        e, f = cfg.num_experts, cfg.d_expert
        ffn = 3 * d * f * (e + cfg.num_shared_experts) + d * e
    else:
        ffn = dense_ffn
    layer = (attn + ffn + 2 * norm) * 2
    cache = 2 * PREFILL_B * kv * t * 2
    outside = ((1 if cfg.tie_embeddings else 2) * v * d + norm) * 2
    tokens = PREFILL_B * t
    logits = tokens * v * (2 + 4)
    hidden = tokens * d * 2
    moe_layer = attn_scores = fixed = ssm_scratch = 0
    if cfg.rwkv:
        f = cfg.d_ff
        layer = ((6 * d * d + 2 * d * f + 2 * 5 * 32 * d + 2 * 64 * d
                  + 10 * d + 2 * d) * 2 + 2 * d * 4)
        cache = PREFILL_B * (d * 64 * 4 + 2 * d * 2)
        ssm_scratch = 12 * tokens * d * 4
    elif cfg.ssm_state:
        di, st = 2 * d, cfg.ssm_state
        heads, conv = di // cfg.ssm_head_dim, di + 2 * st
        layer = ((d * (2 * di + 2 * st + heads) + 5 * conv + di + di * d
                  + norm) * 2 + 3 * heads * 4)
        cache = PREFILL_B * (heads * cfg.ssm_head_dim * st * 4 + 3 * conv * 2)
        ssm_scratch = 10 * tokens * di * 4
        if cfg.attn_every:
            fixed = ((attn + dense_ffn + 2 * norm) * 2 + n // cfg.attn_every
                     * 2 * PREFILL_B * kv * min(t, cfg.window) * 2)
    if cfg.is_moe:
        rows = tokens * cfg.top_k
        slots = e * max(1, int(rows / e * cfg.moe_capacity_factor))
        moe_layer = (rows * d * 2 * 2 + slots * (2 * d + 3 * f) * 2
                     + rows * d * 4 + tokens * d * 4)
    if cfg.attn_softcap:
        attn_scores = 3 * tokens * cfg.num_heads * t * 4
    if cfg.cross_attn_every:
        images = PREFILL_B * cfg.image_tokens
        fixed = n // cfg.cross_attn_every * (
            (attn + dense_ffn + 2 * norm) * 2 + 2 * 4 + 2 * images * kv * 2)
        attn_scores = 3 * tokens * cfg.num_heads * cfg.image_tokens * 4
    if cfg.family == "audio":
        frames = PREFILL_B * cfg.encoder_frames
        logits = tokens * v * 2
        # each decoder layer also holds a cross attention, its norm and
        # the cross K/V of the encoder states
        layer += (attn + norm) * 2
        cache += 2 * frames * kv * 2
        fixed = cfg.encoder_layers * (attn + dense_ffn + 2 * norm) * 2 \
            + norm * 2 + frames * d * 2 * 2
        attn_scores = 3 * tokens * cfg.num_heads * cfg.encoder_frames * 4
    torch.cuda.empty_cache()  # what the allocator caches counts as free
    free, total = torch.cuda.mem_get_info(torch.device(dev))
    need = (n * (layer + cache) + fixed + outside
            + max(logits, moe_layer, attn_scores, ssm_scratch) + hidden)
    return {"free": free, "total": total, "layer": layer,
            "cache_per_layer": cache, "embed_and_head": outside,
            "cross_or_encoder_or_shared": fixed, "logits": logits,
            "moe_layer": moe_layer, "attn_scores": attn_scores,
            "ssm_scratch": ssm_scratch, "hidden": hidden, "need": need,
            "margin": MEMORY_MARGIN}


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


# a train step's device time by part, by the kernels' names: K5, K7, K8;
# the backward of the MoE's bf16 row gathers (PyTorch's sort-based index
# backward); cuBLAS's bf16 GEMMs; the f32 GEMMs of ``_sdpa``'s einsums
# (TF32 off); the softmax forward and backward
TRAIN_PROFILE_PARTS = {
    **{k: MOE_PROFILE_PARTS[k] for k in ("K5 combine", "K7 dispatch count",
                                         "K8 attention")},
    "index backward": ("kernel", ("indexing_backward_kernel",)),
    "bf16 GEMMs": ("kernel", ("nvjet", "gemm_bf16")),
    "f32 GEMMs (attention)": ("kernel", ("gemm_f32f32",)),
    "softmax": ("kernel", ("softmax", "SoftMax")),
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
    # a named range (``record_function``) also spans its kernels on the
    # device: it is not a kernel, and would count them twice
    ranges = {e.key for e in events if getattr(e, "is_user_annotation",
                                               False)}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
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


def _decode_vs_prefill(model, params, tokens, prefill_logits, extras=None):
    """Teacher-forced ``decode_step`` logits at positions 0..P-1 against
    the prefill's: max |diff| and the share of equal argmaxes.  ``extras``:
    the family's stub, for its cache (``serve.step``)."""
    import torch
    positions = prefill_logits.shape[1]
    cache = model.init_cache(params, tokens.shape[0], positions,
                             **(extras or {}))
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
    # held only where the reckoning picked the depth: the other two run
    # whole, and their peak is reported beside it
    picked = full.attn_pattern == "local_global"
    _require(not picked or peak - held_before <= reckoning["need"],
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
# 3. the families' serving path: gemma2, llama-3.2-vision, whisper-small
# ---------------------------------------------------------------------------


# a step's device time by part: K8 by its kernels' names, the rest by the
# torch operator that launched the kernels; the einsums and the softmax
# are the plain _sdpa's (every gemma2 layer, the cross layers, decode)
FAMILY_PROFILE_PARTS = {
    "K8 attention": MOE_PROFILE_PARTS["K8 attention"],
    "mm (projections, FFN, head)": ("op", ("aten::mm",)),
    "einsum (_sdpa QK^T, P V)": ("op", ("aten::einsum",)),
    "softmax (_sdpa)": ("op", ("aten::softmax",)),
    "tanh (softcaps)": ("op", ("aten::tanh", "aten::tanh_")),
}
# rwkv6's and zamba2's, disjoint: the WKV and SSD einsums (and zamba2's
# decode _sdpa), the chunks' cumsum, and the inter-chunk loop (its exp,
# mul, add and the stack of its states, under the name the models give
# it); the rest is elementwise work, casts and concatenations
SSM_PROFILE_PARTS = {
    "K8 attention": MOE_PROFILE_PARTS["K8 attention"],
    "mm (projections, FFN, LoRAs, head)": ("op", ("aten::mm",)),
    "einsum (WKV/SSD, _sdpa)": ("op", ("aten::einsum",)),
    "cumsum": ("op", ("aten::cumsum",)),
    "chunk loop": ("op", ("rwkv6 WKV chunk loop", "mamba2 SSD chunk loop")),
}


def _launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk
    return {**fk.LAUNCHES, **hk.LAUNCHES, **sk.LAUNCHES}


def _open_gates(model, params) -> int:
    """Sets every cross layer's gates to GATES_OPEN; returns their
    count."""
    cross = [p for kind, p in zip(getattr(model, "kinds", ()),
                                  params.get("layers", ())) if kind == "cross"]
    for p in cross:
        for name, value in GATES_OPEN.items():
            p[name].fill_(value)
    return len(cross)


def _set_ssm_leaves(params) -> int:
    """Sets every RWKV and Mamba layer's SSM_LEAVES to their ramps;
    returns the count of layers set."""
    import torch
    done = 0
    for p in params.get("layers", ()):
        for block, leaves in SSM_LEAVES.items():
            if block not in p:
                continue
            for name, (first, last) in leaves.items():
                leaf = p[block][name]
                leaf.copy_(torch.linspace(first, last, leaf.numel(),
                                          device=leaf.device).reshape(
                                              leaf.shape))
            done += 1
    return done


def _k8_per_prefill(cfg, t: int) -> int:
    """K8 launches of one ``prefill_step`` over ``t`` tokens: each
    self-attention sub-block of the plan that ``attention.flash_route``
    takes at ``t`` (no softcap; a window, if any, that ``t`` fits inside);
    Whisper's encoder twice (``forward`` and ``init_cache``) and its
    decoder once."""
    from repro_torch.models import attention, transformer
    if cfg.family == "audio":
        return 2 * cfg.encoder_layers + cfg.num_layers
    plan = transformer.layer_plan(cfg)
    kinds = plan.group_kinds * plan.n_groups + plan.tail_kinds
    return sum(attention.flash_route(transformer._attn_cfg(cfg, kind), t=t)
               for kind in kinds if kind not in ("rwkv", "mamba", "cross"))


def gemma2_window_checks(dev) -> dict:
    """One gemma2-27b local layer at every published width, in f32 with
    TF32 off (``tests/_gemma2_window.py``: seeded weights, inputs x 2):
    ``attend`` over WINDOW_T tokens against attention in f64 whose band
    (key j seen by query i where i - 4096 < j <= i) is built from index
    arithmetic, not ``_mask_bias``; then RING_STEPS single-token decode
    steps through the 4096-slot ring and through a RING_STEPS-slot buffer,
    equal within RING_TOL on every step."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from _gemma2_window import (banded_attention_f64, local_layer,
                                ring_against_full)

    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    acfg, p, gen, x = local_layer(dev, WINDOW_T)
    out = {}
    with torch.no_grad():
        got, _ = attention.attend(p, x, acfg)
        want, full = banded_attention_f64(p, x, acfg)
    err = _abs_err(got, want)
    late = slice(acfg.window, None)     # rows whose band drops keys
    moved = _abs_err(want[:, late], full[:, late])
    del want, full
    _require(err <= WINDOW_TOL and moved > 100 * WINDOW_TOL,
             f"gemma2 local layer T={WINDOW_T}: max |err| {err} against the "
             f"banded f64 oracle (bound {WINDOW_TOL}); the window moves the "
             f"later rows by {moved}")
    out.update(window_max_abs=err, window_effect_max_abs=moved)
    log(f"  gemma2 local layer (d_model {x.shape[-1]}, {acfg.num_heads}/"
        f"{acfg.num_kv_heads} x {acfg.head_dim}, window {acfg.window}, "
        f"softcap {acfg.logit_softcap}) f32, T={WINDOW_T}: max |err| "
        f"{err:.3g} against the banded f64 oracle (bound {WINDOW_TOL}); the "
        f"window moves rows past {acfg.window} by up to {moved:.3g}")

    x = torch.randn((1, RING_STEPS, x.shape[-1]), generator=gen, device=dev)
    slots, worst, wrapped = ring_against_full(p, x, acfg)
    _require(worst <= RING_TOL, f"gemma2 ring of {slots[0]} slots against "
                                f"{slots[1]}: max |diff| {worst}")
    out.update(ring_slots=slots, ring_max_abs=worst,
               ring_wrapped_max_abs=wrapped)
    log(f"  gemma2 ring: {RING_STEPS} decode steps through {slots[0]} slots "
        f"and through {slots[1]}: max |diff| {worst:.3g} (past the wrap "
        f"{wrapped:.3g}), bound {RING_TOL}")
    return out


def family_serving_model(dev, arch: str) -> dict:
    """One of FAMILY_SERVE or SSM_SERVE at every published width, random
    bf16 weights drawn on the card (seed 0), its depth and prefill
    reckoned against the free memory first: ``make_prefill`` at 4 x 2048 tokens (Whisper: 448
    tokens against 1500 frames), a ragged 2000 (not Whisper, whose 1500
    frames are ragged already), ``generate`` 16 + 16, K8's launches held
    to each step's count; decode against prefill in bf16, reported; a
    profile of a prefill and of a decode step; the hard check in f32 at
    F32_CHECK_DEPTH, TF32 off; for gemma2, its window at full width
    (``gemma2_window_checks``).  llama-vision's gates are opened
    (GATES_OPEN), and the RWKV and Mamba layers' constant leaves set to
    SSM_LEAVES, after ``init`` in every run.  Returns what was measured.
    """
    import torch

    from repro_torch.models import layers, transformer
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

    def run(what, fn, k8):
        """``fn()`` under no_grad, its launches held to ``k8`` of K8 and
        none of any other kernel."""
        before = _launches()
        with torch.no_grad():
            result = fn()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _launches().items()
               if v != before[k]}
        want = {"flash_attention": k8} if k8 else {}
        _require(got == want, f"{arch} {what}: launches {got}, expected "
                              f"{want}")
        return result

    def draw(cfg, seed):
        model = build_model(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen)
        return (model, params, gen, _open_gates(model, params),
                _set_ssm_leaves(params))

    full = _serve_config(arch=arch)
    t = WHISPER_T if full.family == "audio" else PREFILL_T
    n = full.num_layers
    reckoning = serving_reckoning(dev, full, n, t)
    if full.attn_pattern == "local_global":   # whole pairs that fit
        while n > 2 and reckoning["need"] + MEMORY_MARGIN > reckoning["free"]:
            n -= 2
            reckoning = serving_reckoning(dev, _serve_config(
                num_layers=n, arch=arch), n, t)
    _require(reckoning["need"] + MEMORY_MARGIN <= reckoning["free"],
             f"{n} {arch} layers do not fit beside the prefill: {reckoning}")
    cfg = _serve_config(num_layers=n, arch=arch)
    extra = (f", {cfg.encoder_layers} encoder layers over "
             f"{cfg.encoder_frames} frames" if cfg.family == "audio" else "")
    extra += (f", a gated cross layer after every {cfg.cross_attn_every} "
              f"over {cfg.image_tokens} image tokens"
              if cfg.cross_attn_every else "")
    extra += (f", window {cfg.window}, softcaps {cfg.attn_softcap}/"
              f"{cfg.final_softcap}" if cfg.attn_softcap else "")
    extra += (f", RWKV-6 time and channel mix ({cfg.d_model // 64} heads of "
              f"64, {cfg.rwkv_impl} WKV, chunk 64), no attention"
              if cfg.rwkv else "")
    if cfg.ssm_state and not cfg.rwkv:
        plan = transformer.layer_plan(cfg)
        extra += (f", Mamba-2 (d_inner {2 * cfg.d_model}, "
                  f"{2 * cfg.d_model // cfg.ssm_head_dim} heads of "
                  f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                  f"{cfg.ssm_chunk}) with a shared attention block after "
                  f"every {cfg.attn_every} ({plan.n_groups} invocations, "
                  f"window {cfg.window}) and a tail of "
                  f"{len(plan.tail_kinds)}")
    heads = ("" if cfg.rwkv else f", heads {cfg.num_heads}/"
             f"{cfg.num_kv_heads} x {cfg.resolved_head_dim}")
    log(f"  {arch}: {n} of {full.num_layers} layers"
        f"{'' if n == full.num_layers else ' (cut: the rest stand for further pipeline stages)'}"
        f", widths as published: d_model {cfg.d_model}{heads}, "
        f"d_ff {cfg.d_ff} {cfg.activation}, vocab {cfg.padded_vocab}{extra}; "
        f"memory reckoning (bytes) {reckoning}")
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, params, gen, opened, ssm_set = draw(cfg, 0)
    batch = make_batch(cfg, PREFILL_B, t, gen)
    tokens = batch["tokens"]
    extras = {k: v for k, v in batch.items()
              if k in ("frames", "image_embeds")}
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    out.update(layers=n, of=full.num_layers, weight_bytes=weight_bytes)
    log(f"  weights: {weight_bytes} bytes ({weight_bytes / 1e9:.2f} GB); "
        f"peak while drawing them {torch.cuda.max_memory_allocated()} bytes"
        + (f"; {opened} cross layers' gates opened to {GATES_OPEN} (init "
           f"closes them)" if opened else "")
        + (f"; {ssm_set} layers' constant leaves set to ramps {SSM_LEAVES}"
           if ssm_set else "")
        + "; stubs " + ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                                 for k, v in extras.items()))
    step("init")
    torch.cuda.reset_peak_memory_stats()

    k8 = _k8_per_prefill(cfg, t)
    parts = (SSM_PROFILE_PARTS if cfg.rwkv or cfg.ssm_state
             else FAMILY_PROFILE_PARTS)
    prefill = serve_mod.make_prefill(model, serve_mod.ServeConfig(max_len=t))
    logits, cache = run("prefill", lambda: prefill(params, tokens, extras), k8)
    step("prefill")
    # CausalLM's logits are f32; Whisper's stay in its dtype
    dtype = (layers.torch_dtype(cfg.dtype) if cfg.family == "audio"
             else torch.float32)
    finite = _all_finite(logits)
    _require(logits.shape == (PREFILL_B, t, cfg.padded_vocab)
             and logits.dtype == dtype and finite,
             f"{arch} prefill logits {tuple(logits.shape)} {logits.dtype}, "
             f"finite {finite}")
    peak = torch.cuda.max_memory_allocated()
    # held only where the reckoning picked the depth: the other two run
    # whole, and their peak is reported beside it
    picked = full.attn_pattern == "local_global"
    _require(not picked or peak - held_before <= reckoning["need"],
             f"{arch} prefill peak {peak - held_before} bytes above the "
             f"reckoning {reckoning['need']}")
    head = logits[:, :DECODE_PROMPT].clone()
    tail = logits[:, RAGGED_T - 100:RAGGED_T].clone() if t > RAGGED_T else None
    del logits, cache
    out.update(peak_memory_bytes=peak, k8_per_prefill=k8)
    log(f"  prefill {PREFILL_B} x {t}: logits {(PREFILL_B, t, cfg.padded_vocab)}"
        f" {str(dtype)[6:]}, finite; K8 launched {k8} times"
        + (f" ({cfg.encoder_layers} encoder layers, not causal, in forward "
           f"and again in init_cache; {cfg.num_layers} decoder layers, "
           f"causal)" if cfg.family == "audio" else "")
        + f"; peak memory {peak} bytes (reckoned "
        f"{held_before + reckoning['need']}"
        + (", held to it)" if picked else ", reported: the depth is whole)"))

    # profiled next, while the allocator's cached blocks are the ones this
    # prefill's shapes just freed: once the ragged prefill has split them,
    # gemma2's 8.4 GB logits found no block on an 80 GB H100 (out of memory
    # with 8.6 GiB reserved but unallocated)
    with torch.no_grad():
        out["profile_prefill"] = device_profile(
            lambda: prefill(params, tokens, extras),
            f"{arch} prefill {PREFILL_B} x {t}", parts=parts)
    step("profile prefill")

    if tail is not None:
        k8_ragged = _k8_per_prefill(cfg, RAGGED_T)
        ragged, _ = run("ragged prefill", lambda: prefill(
            params, tokens[:, :RAGGED_T], extras), k8_ragged)
        _require(ragged.shape[1] == RAGGED_T and _all_finite(ragged),
                 f"{arch} ragged prefill at T={RAGGED_T}")
        diff = _abs_err(ragged[:, -100:], tail)
        del ragged, tail
        out["ragged_vs_full_max_abs"] = diff
        log(f"  ragged prefill T={RAGGED_T}: finite, K8 launched "
            f"{k8_ragged} times; "
            f"last 100 positions' logits against the T={PREFILL_T} "
            f"prefill's: max |diff| {diff!r} (reported)")
        step("ragged")

    prompt = tokens[:, :DECODE_PROMPT]
    steps = DECODE_PROMPT + DECODE_GEN - 1
    k8_gen = cfg.encoder_layers if cfg.family == "audio" else 0
    toks = run("generate", lambda: serve_mod.generate(
        model, params, prompt, DECODE_GEN,
        serve_mod.ServeConfig(max_len=DECODE_PROMPT + DECODE_GEN), extras),
        k8_gen)
    step("decode")
    _require(toks.shape == (PREFILL_B, DECODE_PROMPT + DECODE_GEN)
             and torch.equal(toks[:, :DECODE_PROMPT], prompt)
             and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
             f"{arch} generate returned {tuple(toks.shape)}")
    log(f"  generate: {steps} decode steps of {PREFILL_B} tokens in "
        f"{seconds['decode']:.3f} s ({seconds['decode'] / steps * 1e3:.1f} ms "
        f"a step); K8 launched {k8_gen} times"
        + (" (the encoder, in init_cache)" if k8_gen else ""))
    err_bf16, agree = _decode_vs_prefill(model, params, tokens, head, extras)
    out.update(k8_per_generate=k8_gen, bf16_decode_max_abs=err_bf16,
               bf16_top1_agreement=agree)
    log(f"  bf16 at {n} layers, decode vs prefill logits over "
        f"{DECODE_PROMPT} positions: max |diff| {err_bf16:.4g}, top-1 "
        f"agreement {agree:.4f} (reported, not bounded: bf16 rounds "
        f"differently on the two routes)")
    step("agreement")

    small = model.init_cache(params, PREFILL_B, DECODE_PROMPT, **extras)
    with torch.no_grad():
        out["profile_decode"] = device_profile(
            lambda: model.decode_step(params, tokens[:, :1], small, pos=0),
            f"{arch} decode step of {PREFILL_B} tokens at context 1",
            parts=parts)
    del small, head, toks, params, model, extras, batch, tokens
    torch.cuda.empty_cache()
    step("profile decode")

    # the hard check: f32 at full width, TF32 off, the gates open
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = _serve_config(arch=arch, dtype="float32", **F32_CHECK_DEPTH[arch])
    model, params, gen, opened, ssm_set = draw(cfg32, 1)
    batch = make_batch(cfg32, F32_CHECK_B, F32_CHECK_T, gen)
    tokens = batch["tokens"]
    extras = {k: v for k, v in batch.items()
              if k in ("frames", "image_embeds")}
    fwd, _ = run("f32 prefill", lambda: serve_mod.make_prefill(
        model, serve_mod.ServeConfig(max_len=F32_CHECK_T))(
            params, tokens, extras), _k8_per_prefill(cfg32, F32_CHECK_T))
    err32, agree32 = _decode_vs_prefill(model, params, tokens, fwd, extras)
    _require(err32 < DECODE_TOL, f"{arch} f32 decode vs prefill max |diff| "
                                 f"{err32} >= {DECODE_TOL}")
    out.update(f32_decode_max_abs=err32, f32_top1_agreement=agree32)
    depth = ", ".join(f"{k} {v}" for k, v in F32_CHECK_DEPTH[arch].items())
    log(f"  f32 at {depth}, full width, TF32 off"
        + (f", {opened} cross layer's gates open" if opened else "")
        + (f", {ssm_set} layers' constant leaves on their ramps"
           if ssm_set else "")
        + f": decode vs prefill logits over {F32_CHECK_T} positions, max "
        f"|diff| {err32:.4g} < {DECODE_TOL}, top-1 agreement {agree32:.4f}")
    del params, model, fwd, extras, batch
    torch.cuda.empty_cache()
    step("f32 check")

    if cfg.attn_pattern == "local_global":
        out.update(gemma2_window_checks(dev))
        torch.cuda.empty_cache()
        step("window")
    out["seconds"] = seconds
    log("  host seconds by step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return out


def family_serving_path(dev, archs=FAMILY_SERVE) -> dict:
    """Each of ``archs`` through ``family_serving_model``, one after the
    other.  Returns what was measured by model."""
    measured = {}
    for arch in archs:
        measured[arch] = family_serving_model(dev, arch)
        log(f"  {arch}: {json.dumps(measured[arch])}")
    return measured


# ---------------------------------------------------------------------------
# 3. the training path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording_train(profile_step=None, parts=None):
    """While open, every step that ``train.step.make_train_step`` makes
    records its launches by kernel and its device-synchronised seconds,
    and step ``profile_step`` (0-based) runs under ``device_profile``;
    ``rec["bytes"]`` holds the bytes of the first step's parameters and
    optimizer state.  Steps run and count their launches as they
    otherwise do."""
    import torch

    from repro_torch import tree
    from repro_torch.train import step as train_mod
    rec = {"launches": [], "seconds": [], "profile": None, "bytes": None}
    make = train_mod.make_train_step

    def recorded_make(model, tcfg, ocfg):
        step = make(model, tcfg, ocfg)

        def recorded(state, batch):
            if rec["bytes"] is None:
                rec["bytes"] = {part: sum(
                    t.numel() * t.element_size()
                    for t in tree.leaves(state[part]))
                    for part in ("params", "opt")}
            before = _launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(rec["seconds"]) == profile_step:
                box = {}
                rec["profile"] = device_profile(
                    lambda: box.update(out=step(state, batch)),
                    f"{model.cfg.name} train step {profile_step}", top=10,
                    parts=parts)
                out = box["out"]
            else:
                out = step(state, batch)
            torch.cuda.synchronize()
            rec["seconds"].append(time.perf_counter() - t0)
            rec["launches"].append({k: v - before[k]
                                    for k, v in _launches().items()
                                    if v != before[k]})
            return out

        return recorded

    train_mod.make_train_step = recorded_make
    try:
        yield rec
    finally:
        train_mod.make_train_step = make


@contextlib.contextmanager
def recording_dispatch(n: int):
    """While open, K7's launcher keeps copies of the ids and the counts
    of its first ``n`` calls (``rec``: a list of pairs).  Every call runs
    and counts its launch as it otherwise does."""
    from repro_torch.kernels.scatter_add import kernel as sk
    rec = []
    bincount = sk.bincount_launch

    def recorded(ids, num_segments):
        counts = bincount(ids, num_segments)
        if len(rec) < n:
            rec.append((ids.clone(), counts.clone()))
        return counts

    sk.bincount_launch = recorded
    try:
        yield rec
    finally:
        sk.bincount_launch = bincount


def check_train_dispatch(rec, cfg) -> str:
    """K7 at the train step's shape: each recorded dispatch of the first
    step (``recording_dispatch``), TRAIN_B x TRAIN_T x top-k sorted ids
    into the experts, its count from the path and a launch on the same
    ids (outside the counts) both bit for bit ``bincount_plain``."""
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk

    n_ids = TRAIN_B * TRAIN_T * cfg.top_k
    _require(len(rec) == 2 * cfg.num_layers,
             f"{len(rec)} K7 calls recorded in the first step")
    largest = 0
    for i, (ids, counts) in enumerate(rec):
        _require(ids.numel() == n_ids and bool((ids[1:] >= ids[:-1]).all()),
                 f"K7 call {i}: {ids.numel()} ids, sorted "
                 f"{bool((ids[1:] >= ids[:-1]).all())}")
        plain = sk.bincount_plain(ids, cfg.num_experts)
        with uncounted():
            again = sk.bincount_launch(ids, cfg.num_experts)
            torch.cuda.synchronize()
        _require(torch.equal(counts, plain) and torch.equal(again, plain),
                 f"K7 at the train step's dispatch, call {i}: {n_ids} ids "
                 f"-> {cfg.num_experts}, path or relaunch != bincount_plain")
        largest = max(largest, int(plain.max()))
    return (f"K7 on the first step's {len(rec)} dispatches ({n_ids} sorted "
            f"ids -> {cfg.num_experts} experts each; forward and recompute): "
            f"the path's counts and a relaunch bit-equal to bincount_plain "
            f"(largest count {largest})")


@contextlib.contextmanager
def plain_combine():
    """While open, the MoE combine is ``scatter_add_plain`` (an
    ``index_add`` that autograd differentiates by itself) in place of K5
    under autograd."""
    from repro_torch.kernels.scatter_add import kernel as sk
    fn = sk.scatter_add_autograd
    sk.scatter_add_autograd = sk.scatter_add_plain
    try:
        yield
    finally:
        sk.scatter_add_autograd = fn


def check_k5_autograd(dev, err: dict) -> None:
    """K5 under autograd (``scatter_add_autograd``) on the card at the
    train step's combine, TRAIN_B x TRAIN_T tokens x top-8 rows of
    d_model f32, and at a decode step's, 4 tokens: some ids dropped (-1
    and S + 3).  The forward within K5_FWD_RTOL of ``scatter_add_plain``
    relative to its largest sum, the backward bit for bit autograd's own
    gradient of that ``index_add``, zero on the dropped rows."""
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk

    cfg = _serve_config(arch=TRAIN_ARCH)
    for tokens in (TRAIN_B * TRAIN_T, PREFILL_B):
        n, d = tokens * cfg.top_k, cfg.d_model
        gen = torch.Generator(device=dev).manual_seed(tokens)
        vals = torch.randn((n, d), generator=gen, device=dev)
        ids = torch.div(torch.randperm(n, generator=gen, device=dev),
                        cfg.top_k, rounding_mode="floor").to(torch.int32)
        ids[::97] = -1
        ids[5::89] = tokens + 3
        w = torch.randn((tokens, d), generator=gen, device=dev)
        got = vals.clone().requires_grad_()
        with uncounted():
            out = sk.scatter_add_autograd(got, ids, tokens)
            (out * w).sum().backward()
            torch.cuda.synchronize()
        want = vals.clone().requires_grad_()
        plain = sk.scatter_add_plain(want, ids, tokens)
        (plain * w).sum().backward()
        out, plain = out.detach(), plain.detach()
        abs_err = _abs_err(out, plain)
        rel = abs_err / float(plain.abs().max())
        dropped = (ids < 0) | (ids >= tokens)
        case = f"({n}, {d}) f32 -> {tokens}, {int(dropped.sum())} dropped"
        _require(rel <= K5_FWD_RTOL,
                 f"K5 under autograd {case}: forward rel err {rel}")
        _require(torch.equal(got.grad, want.grad),
                 f"K5 under autograd {case}: backward not the plain gather")
        _require(bool(dropped.any()) and not got.grad[dropped].any(),
                 f"K5 under autograd {case}: dropped rows got a gradient")
        err["scatter_add"] = max(err["scatter_add"], abs_err)
        log(f"  K5 under autograd {case} ({sk.scatter_add_route(vals, tokens)}"
            f" route): forward max |err| {abs_err:.3g} ({rel:.3g} of the "
            f"largest sum), backward bit-equal to autograd's index_add "
            f"gradient, dropped rows 0")


def check_training_grads(dev) -> dict:
    """Every gradient leaf of granite at every published width, cut to
    GRAD_CHECK_LAYERS layers, f32 (TF32 off), on GRAD_CHECK_B x TRAIN_T
    tokens of the step's data: with K5 as the combine, then with the plain
    combine (``plain_combine``), each leaf within GRAD_TOL x max|g|; the
    expert weights' gradients non-zero (K5's own result has no
    ``grad_fn``: without ``scatter_add_autograd`` they would be 0)."""
    import torch

    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _serve_config(num_layers=GRAD_CHECK_LAYERS, dtype="float32",
                        arch=TRAIN_ARCH)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    toks = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
        global_batch=GRAD_CHECK_B)).global_batch_at(0)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    grad_fn = train_mod.make_grad_fn(model, train_mod.TrainConfig())
    before = _launches()
    with uncounted():
        g_k5, m_k5 = grad_fn(params, batch)
        torch.cuda.synchronize()
        k5 = _launches()["scatter_add"] - before["scatter_add"]
        with plain_combine():
            g_pl, m_pl = grad_fn(params, batch)
            torch.cuda.synchronize()
        _require(_launches()["scatter_add"] - before["scatter_add"] == k5
                 == 2 * GRAD_CHECK_LAYERS,
                 f"K5 launches {k5} with K5, then more with the plain "
                 f"combine")
    worst, leaves = 0.0, 0
    for a, b in zip(tree.leaves(g_k5), tree.leaves(g_pl)):
        scale = float(b.abs().max())
        e = _abs_err(a, b)
        _require(e <= GRAD_TOL * scale, f"gradient leaf {tuple(b.shape)}: "
                                        f"max |err| {e} > {GRAD_TOL} x {scale}")
        worst = max(worst, e / scale if scale else 0.0)
        leaves += 1
    experts = [float(p["ffn"][w].abs().max()) for p in g_k5["layers"]
               for w in ("w_gate", "w_up", "w_down")]
    _require(min(experts) > 0, f"expert gradients {experts}")
    xent_gap = abs(float(m_k5["xent"]) - float(m_pl["xent"]))
    log(f"  gradients at {GRAD_CHECK_LAYERS} layers, full width, f32, "
        f"{GRAD_CHECK_B} x {TRAIN_T} tokens: {leaves} leaves, K5 against the "
        f"plain combine within {worst:.3g} x max|g| (bound {GRAD_TOL}); "
        f"expert gradients' max |g| {min(experts):.3g}-{max(experts):.3g}, "
        f"none zero; xent {float(m_k5['xent'])!r} vs {float(m_pl['xent'])!r}")
    del g_k5, g_pl, params, model
    torch.cuda.empty_cache()
    return {"leaves": leaves, "worst_rel": worst, "xent_gap": xent_gap,
            "expert_grad_max_min": min(experts)}


def check_blockwise(dev) -> dict:
    """Blockwise attention (``kv_block`` = the config's 1024, and with
    512-query blocks) against the dense plain ``_sdpa`` at granite's
    attention shape, TRAIN_B x TRAIN_T, f32: within BLOCKWISE_TOL."""
    import torch

    from repro_torch.models import attention, transformer

    cfg = _serve_config(arch=TRAIN_ARCH, dtype="float32")
    acfg = transformer._attn_cfg(cfg, "attn")
    gen = torch.Generator(device=dev).manual_seed(3)
    p = attention.init(gen, acfg)
    x = torch.randn((TRAIN_B, TRAIN_T, cfg.d_model), generator=gen,
                    device=dev)
    pos = torch.arange(TRAIN_T, device=dev)   # positions given: not K8
    out = {}
    with torch.no_grad():
        dense, _ = attention.attend(p, x, acfg, positions=pos)
        for q_block in (None, 512):
            got, _ = attention.attend(p, x, acfg, positions=pos,
                                      kv_block=cfg.kv_block, q_block=q_block)
            torch.testing.assert_close(
                got, dense, rtol=BLOCKWISE_TOL, atol=BLOCKWISE_TOL,
                msg=f"blockwise (q_block {q_block}) vs dense")
            out[f"q_block {q_block}"] = _abs_err(got, dense)
    log(f"  blockwise attention, {TRAIN_B} x {acfg.num_heads}/"
        f"{acfg.num_kv_heads} x {TRAIN_T} x {acfg.head_dim} f32, kv_block "
        f"{cfg.kv_block}, against dense _sdpa: max |err| {out} (bound "
        f"{BLOCKWISE_TOL})")
    return out


def train_reckoning(cfg, state_bytes: dict) -> dict:
    """Bytes of a train step of ``cfg`` at TRAIN_B x TRAIN_T: the state
    (bf16 parameters; f32 m, v and master), the step's transients (bf16
    gradients and the new parameters), and the activations under remat:
    each layer's bf16 input, kept for the recompute; one layer's
    recompute, the MoE's (the expert-sorted rows and the (E, C, d) buffer,
    bf16; the three (E, C, f) products and the expert output; the f32
    combine values) or the attention's f32 scores three at a time
    (scores, probabilities and their gradient), whichever is larger; and
    the head's logits (bf16, their f32 copy and its gradient).
    ``state_bytes``: the parameters' and the optimizer state's bytes."""
    n_tok = TRAIN_B * TRAIN_T
    p_bytes, opt_bytes = state_bytes["params"], state_bytes["opt"]
    rows = n_tok * cfg.top_k
    cap = int(rows / cfg.num_experts * cfg.moe_capacity_factor)
    slots = cfg.num_experts * cap
    moe = (rows * cfg.d_model * 2 + slots * cfg.d_model * 2
           + 3 * slots * cfg.d_expert * 2 + slots * cfg.d_model * 2
           + rows * cfg.d_model * 4)
    scores = 3 * TRAIN_B * cfg.num_heads * TRAIN_T * TRAIN_T * 4
    act = (cfg.num_layers * n_tok * cfg.d_model * 2 + max(moe, scores)
           + n_tok * cfg.padded_vocab * (2 + 4 + 4))
    return {"state": p_bytes + opt_bytes, "transients": 2 * p_bytes,
            "activations": act,
            "total": p_bytes + opt_bytes + 2 * p_bytes + act}


def train_whole(dev, tmp: Path) -> dict:
    """granite-moe-1b-a400m whole at every published width: bf16
    parameters with an f32 master, TRAIN_STEPS steps of TRAIN_B x TRAIN_T
    tokens through ``launch.train.main`` in-process, no checkpoints.  Each
    step's launches (K5 and K7 twice a layer: forward and recompute; K8
    never), seconds and xent; one step profiled; the peak memory beside
    the reckoning; K7's counts of the first step against
    ``bincount_plain`` (``check_train_dispatch``).  ``launch.train``
    raises where the loss did not fall."""
    import torch

    from repro_torch.launch import train as launch_train

    cfg = _serve_config(arch=TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with recording_train(TRAIN_PROFILE_STEP, TRAIN_PROFILE_PARTS) as rec, \
            recording_dispatch(2 * cfg.num_layers) as dispatched:
        hist = launch_train.main([
            "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_T),
            "--save-every", "0", "--ckpt-dir", str(tmp / "unused"),
            "--device", dev])["history"]
    peak = torch.cuda.max_memory_allocated() - held
    k7 = check_train_dispatch(dispatched, cfg)
    del dispatched
    reckoned = train_reckoning(cfg, rec["bytes"])
    xent = [h["xent"] for h in hist]
    per_layer = 2 * cfg.num_layers
    want = {"bincount": per_layer, "scatter_add": per_layer}
    _require(all(n == want for n in rec["launches"]),
             f"train step launches {rec['launches']}, expected {want} "
             f"each (K8 0)")
    _require(all(np.isfinite(xent)) and xent[-1] < xent[0],
             f"xent {xent}")
    # the first step warms up, the profiled one carries the profiler
    steady = statistics.median(
        [s for i, s in enumerate(rec["seconds"])
         if i not in (0, TRAIN_PROFILE_STEP)])
    out = {"steps": len(hist), "xent": xent,
           "step_seconds": rec["seconds"], "median_step_s": steady,
           "tokens_per_s": TRAIN_B * TRAIN_T / steady,
           "launches_per_step": rec["launches"][0],
           "peak_memory_bytes": peak, "reckoning": reckoned,
           "profile": rec["profile"]}
    log(f"  {TRAIN_ARCH} whole: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts x {cfg.d_expert} top-"
        f"{cfg.top_k}, vocab {cfg.padded_vocab}; bf16 params, f32 master, "
        f"{TRAIN_B} x {TRAIN_T} tokens a step, remat {cfg.remat}")
    log(f"  memory: reckoned (bytes) {reckoned}; peak {peak} "
        f"({peak / 1e9:.2f} GB)")
    log(f"  launches a step (every step): {rec['launches'][0]} (K8 0)")
    log(f"  {k7}")
    log(f"  xent by step: {', '.join(f'{x:.4f}' for x in xent)}")
    log(f"  step seconds: {', '.join(f'{s:.3f}' for s in rec['seconds'])}; "
        f"median of steps 1-{TRAIN_STEPS - 1} but {TRAIN_PROFILE_STEP} "
        f"(profiled) {steady:.4f} s "
        f"({out['tokens_per_s']:.0f} tokens/s)")
    return out


def train_restart(dev) -> dict:
    """The same widths at RESTART_LAYERS layers: RESTART_STEPS steps,
    checkpoints every RESTART_SAVE_EVERY steps into a temporary directory
    (removed after), the failure at RESTART_FAIL_AT: exactly one restart,
    and the replayed steps' xent within REPLAY_RTOL of their first pass
    (K5's atomic order is not fixed, so they need not be equal)."""
    from repro_torch.launch import train as launch_train

    real = launch_train.get_config
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        cfg = dataclasses.replace(real(TRAIN_ARCH), num_layers=RESTART_LAYERS)
        n = int(cfg.param_count())
        ckpt_bytes = n * (2 + 12)     # bf16 parameters, f32 m, v, master
        saves = RESTART_FAIL_AT // RESTART_SAVE_EVERY
        log(f"  free disk in {tmp}: {free} bytes; {saves} checkpoints of "
            f"about {ckpt_bytes} bytes each ({n} parameters)")
        _require(free > 2 * saves * ckpt_bytes,
                 f"{free} bytes free for {saves} checkpoints of "
                 f"{ckpt_bytes}")
        launch_train.get_config = lambda arch: dataclasses.replace(
            real(arch), num_layers=RESTART_LAYERS)
        try:
            t0 = time.perf_counter()
            out = launch_train.main([
                "--arch", TRAIN_ARCH, "--steps", str(RESTART_STEPS),
                "--batch", str(TRAIN_B), "--seq", str(TRAIN_T),
                "--save-every", str(RESTART_SAVE_EVERY),
                "--simulate-failure-at", str(RESTART_FAIL_AT),
                "--ckpt-dir", tmp, "--device", dev])
            seconds = time.perf_counter() - t0
        finally:
            launch_train.get_config = real
    hist = out["history"]
    steps = [h["step"] for h in hist]
    resumed = RESTART_FAIL_AT // RESTART_SAVE_EVERY * RESTART_SAVE_EVERY
    _require(out["restarts"] == 1 and steps == list(range(RESTART_FAIL_AT))
             + list(range(resumed, RESTART_STEPS)),
             f"restarts {out['restarts']}, steps {steps}")
    first = {h["step"]: h["xent"] for h in hist[:RESTART_FAIL_AT]}
    gaps = [abs(h["xent"] - first[h["step"]]) / first[h["step"]]
            for h in hist[RESTART_FAIL_AT:] if h["step"] in first]
    _require(gaps and max(gaps) <= REPLAY_RTOL,
             f"replayed xent gaps {gaps}")
    xent = ", ".join(f"{h['xent']:.4f}" for h in hist)
    log(f"  restart at {RESTART_LAYERS} layers: {len(hist)} steps run in "
        f"{seconds:.1f} s, 1 restart from step {resumed}; replayed steps "
        f"{list(range(resumed, RESTART_FAIL_AT))}: xent relative gaps "
        f"{gaps} (bound {REPLAY_RTOL}); xent by step run: {xent}")
    return {"steps": steps, "replay_rel_gaps": gaps, "seconds": seconds,
            "free_disk_bytes": free, "checkpoint_bytes": ckpt_bytes}


def train_one_step(dev, arch: str, b: int, t: int) -> dict:
    """One train step of ``arch`` whole at every published width, bf16
    with an f32 master, on ``make_batch``'s b x t tokens (and stub): the
    xent and grad norm finite, every leaf moved (its f32 master no longer
    the bf16 parameter it started from), K8 never launched.  The
    constant SSM leaves take their SSM_LEAVES ramps first, as in
    serving."""
    import torch

    from repro_torch import tree
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod

    cfg = _serve_config(arch=arch)
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = model.init(gen)
    _set_ssm_leaves(params)
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    batch = make_batch(cfg, b, t, gen, dev)
    step = train_mod.make_train_step(
        model, train_mod.TrainConfig(),
        adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10))
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, metrics = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _launches().items()
                if v != before[k]}
    xent, gnorm = float(metrics["xent"]), float(metrics["grad_norm"])
    still = [i for i, (p, m) in enumerate(zip(tree.leaves(params),
                                              tree.leaves(new["opt"]["master"])))
             if torch.equal(p.to(torch.float32), m)]
    n_leaves = len(tree.leaves(params))
    _require(np.isfinite(xent) and np.isfinite(gnorm),
             f"{arch} train step xent {xent}, grad norm {gnorm}")
    _require(not still, f"{arch}: leaves {still} of {n_leaves} did not move")
    _require("flash_attention" not in launched,
             f"{arch} train step launched {launched}")
    stub = {"audio": f" over {cfg.encoder_frames} frames",
            "vlm": f" with {cfg.image_tokens} image tokens"}.get(
                cfg.family, "")
    log(f"  {arch} whole, one step of {b} x {t} tokens{stub}: xent "
        f"{xent:.4f}, grad norm {gnorm:.4g}, {n_leaves} leaves all moved, "
        f"launches {launched or 'none'}, {seconds:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated()} bytes")
    del new, state, params, model
    torch.cuda.empty_cache()
    return {"xent": xent, "grad_norm": gnorm, "leaves": n_leaves,
            "launches": launched, "seconds": seconds}


def embedding_stream(dev, tables_dir) -> dict:
    """The training batch's token stream as the embedding gradient's
    scatter through the paper's tool: TRAIN_B x TRAIN_T tokens of the
    data pipeline, Zipf(1.1) (the step's) and uniform, over the 49,155
    ids of the vocab into EMBED_SEGMENTS rows, each through
    ``Session.validate`` (trace against kernel: K6's counters, e rel err
    0.0) and ``Session.profile``: e for Zipf more than 1.5 x e for
    uniform (the reference's ``tests/test_optim_serve_misc.py``)."""
    from repro_torch.analysis import Session, WorkloadSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.scatter_add import kernel as sk

    cfg = _serve_config(arch=TRAIN_ARCH)
    sess = Session("v5e", cache_dir=tables_dir, provider="kernel")
    out = {}
    for name, alpha in (("zipf", 1.1), ("uniform", 0.0)):
        toks = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
            global_batch=TRAIN_B, zipf_alpha=alpha)).global_batch_at(0)
        ids = toks.reshape(-1).astype(np.int32)
        before = sk.LAUNCHES["scatter_add_instrumented"]
        spec = WorkloadSpec.from_scatter_add(
            ids, np.ones((ids.size, 1), np.float32), EMBED_SEGMENTS,
            label=f"embedding grad, {name}", waves_per_tile=32)
        rep = sess.validate(spec, providers=("trace", "kernel"))
        e_err = rep.rel_err("kernel", "e")
        prof = sess.profile(spec)
        k6 = sk.LAUNCHES["scatter_add_instrumented"] - before
        _require(e_err == 0.0 and k6 > 0,
                 f"embedding stream {name}: e rel err {e_err}, K6 {k6}")
        out[name] = {"e": prof.e, "U": prof.scatter_utilization,
                     "bottleneck": prof.bottleneck, "e_rel_err": e_err,
                     "k6_launches": k6}
        log(f"  embedding-gradient stream, {name}: {ids.size} ids over "
            f"{cfg.vocab_size} -> {EMBED_SEGMENTS} rows; validate e rel err "
            f"{e_err!r}, K6 launched {k6}; e {prof.e!r}, U "
            f"{prof.scatter_utilization!r}, {prof.bottleneck}")
    _require(out["zipf"]["e"] > 1.5 * out["uniform"]["e"],
             f"embedding stream e: Zipf {out['zipf']['e']}, uniform "
             f"{out['uniform']['e']}")
    return out


def training_path(dev, tmp: Path, err: dict) -> dict:
    """The training phase: K5 under autograd against its plain version,
    the gradients with K5 against the plain combine, blockwise attention
    against dense (these three outside the counts), then the counted
    path: granite-moe-1b-a400m trained whole, its restart at
    RESTART_LAYERS layers, one step each of whisper-small and
    zamba2-1.2b, and the embedding-gradient stream through K6.  Returns
    what was measured."""
    out = {}
    check_k5_autograd(dev, err)
    out["grad_check"] = check_training_grads(dev)
    out["blockwise"] = check_blockwise(dev)
    out["whole"] = train_whole(dev, tmp)
    out["restart"] = train_restart(dev)
    for arch, b, t in ONE_STEP:
        out[arch] = train_one_step(dev, arch, b, t)
    out["embedding_stream"] = embedding_stream(dev, tmp / "tables")
    return out


# ---------------------------------------------------------------------------
# 3. the mesh path: one-rank NCCL meshes on the card
# ---------------------------------------------------------------------------


# the mesh phase: qwen3-moe-235b-a22b's MoE layer at every published width
# through apply_ep on a (1, 1, 1) ("pod", "data", "model") mesh, and
# granite-moe-1b-a400m's through apply_sharded on a (1, 1) mesh, each
# against apply_local on the same inputs; then granite whole: one train
# step of TRAIN_B x TRAIN_T tokens with its state as DTensors, and a
# prefill of PREFILL_B x PREFILL_T, each against the same without a mesh.
# One card is one rank: the collectives run, over one rank.  At capacity
# factor 8.0, where nothing drops, the EP body's buffers grow as tokens x
# cf^2 on one rank (the capacity applies at the dispatch and again at
# each expert: 34 GB for its (E, C, d) buffer alone at 4 x 2048 tokens),
# so that comparison takes MESH_NODROP_B x MESH_NODROP_T tokens; capacity
# 1.25 (the configs') takes the full PREFILL_B x PREFILL_T
MESH_NODROP_B, MESH_NODROP_T = 4, 512
MESH_CFS = (8.0, 1.25)
# the layer's tokens: unit normals plus one shared normal direction of
# half their scale, which skews the router towards some experts (a
# router on unit normals alone is nearly balanced and drops nothing)
MESH_SHARED_SCALE = 0.5
# bf16 against bf16 on another route: each element within MESH_BF16_RTOL
# of |want| (two bf16 ulps) plus MESH_BF16_RTOL x mean |want|, and the
# mean |err| at most MESH_BF16_MEAN x the mean |want|
MESH_BF16_RTOL, MESH_BF16_MEAN = 1.6e-2, 2.0 ** -8
# the step's xent against the unmeshed step's, both on K5: the spread of
# step 0's xent (these tokens and weights) over nine unmeshed runs on an
# H100, six of tools/train_repeat.py and three of this phase (11.158946
# to 11.159167): K5's atomic order alone moves it that far.  With the
# combine's plain version in PyTorch's deterministic mode (outside the
# counts) the two forward losses hold to MESH_XENT_DET
MESH_XENT_SPREAD = 2.21e-4
MESH_XENT_DET = 1e-6
# the meshed prefill's logits against the unmeshed prefill's, both on K5:
# the share of positions whose argmax agrees.  K5's atomic order alone
# moves granite's bf16 logits at random weights (argmaxes of nearly flat
# logits), as two unmeshed prefills show; the deterministic comparison
# (the plain combine, outside the counts) holds the arithmetic to
# MESH_XENT_DET of the mean |logit|
MESH_TOP1 = 0.9
MESH_STEPS = 2                       # each way: the second is timed warm
MESH_KERNELS = ("flash_attention", "bincount", "scatter_add")


def _bf16_close(got, want, what: str) -> dict:
    """``got`` against ``want`` within the bf16 bound; returns the max
    and mean |err| and the mean |want|."""
    import torch
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs()
    mean_want = float(scale.mean())
    worst = float((diff - MESH_BF16_RTOL * (scale + mean_want)).max())
    mean_err = float(diff.mean())
    _require(worst <= 0 and mean_err <= MESH_BF16_MEAN * mean_want,
             f"{what}: max |err| {float(diff.max())}, mean |err| {mean_err} "
             f"against mean |want| {mean_want}")
    del diff, scale
    torch.cuda.synchronize()
    return {"max_abs_err": float((got.float() - want.float()).abs().max()),
            "mean_abs_err": mean_err, "mean_abs_want": mean_want}


@contextlib.contextmanager
def recording_counts():
    """While open, K7's launcher keeps each call's (ids, counts, number
    of segments); every call runs and counts its launch as it otherwise
    does."""
    from repro_torch.kernels.scatter_add import kernel as sk
    rec = []
    bincount = sk.bincount_launch

    def recorded(ids, num_segments):
        counts = bincount(ids, num_segments)
        rec.append((ids, counts, num_segments))
        return counts

    sk.bincount_launch = recorded
    try:
        yield rec
    finally:
        sk.bincount_launch = bincount


def _k7_bit_equal(rec, what: str) -> None:
    """Each recorded K7 count against ``bincount_plain`` on its ids."""
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk
    for i, (ids, counts, n) in enumerate(rec):
        _require(torch.equal(counts, sk.bincount_plain(ids, n)),
                 f"{what}: K7 call {i} ({ids.numel()} ids -> {n}) != "
                 f"bincount_plain")


def _dropped(counts, capacity: int) -> int:
    return int((counts.long() - capacity).clamp(min=0).sum())


def mesh_moe_layer(dev, mesh, arch: str, path: str) -> dict:
    """``arch``'s MoE layer at every published width, bf16 weights drawn
    on the card (seed 0), through ``moe.apply_ep`` (``path`` "ep") or
    ``moe.apply_sharded`` on ``mesh``, against ``apply_local`` on the same
    inputs (outside the counts) at each capacity factor: K7's counts on
    both routes bit-equal to ``bincount_plain``, the outputs within the
    bf16 bound where the two drop the same rows (EP at 8.0, where nothing
    drops; TP at any factor), and each route's drop share."""
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.models import moe, transformer
    from repro_torch.parallel import ctx as pctx

    cfg = _serve_config(arch=arch)
    base = transformer._moe_cfg(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init(gen, base)
    d, e, k = base.d_model, base.num_experts, base.top_k
    n_tok = PREFILL_B * PREFILL_T
    x = (torch.randn((n_tok, d), generator=gen, device=dev)
         + MESH_SHARED_SCALE * torch.randn((1, d), generator=gen, device=dev)
         ).to(torch.bfloat16)
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    cfs = MESH_CFS if path == "ep" else (base.capacity_factor,)
    out = {}
    for cf in cfs:
        mcfg = dataclasses.replace(base, capacity_factor=cf)
        b, t = ((MESH_NODROP_B, MESH_NODROP_T) if path == "ep" and cf > 2
                else (PREFILL_B, PREFILL_T))
        xs = x[:b * t]
        tk = b * t * k
        with torch.no_grad():
            with uncounted(), recording_counts() as local_rec:
                want, _, want_disp = moe.apply_local(p, xs, mcfg)
            torch.cuda.synchronize()
            before = dict(sk.LAUNCHES)
            t0 = time.perf_counter()
            with pctx.use_mesh(mesh, data_axes=data_axes, tp_axis="model"), \
                    recording_counts() as mesh_rec:
                if path == "ep":
                    got, aux, disp = moe.apply_ep(
                        p, xs.view(b, t, d), mcfg, mesh, data_axes=data_axes,
                        tp_axis="model", ep_axis=data_axes[-1])
                else:
                    got, aux, disp = moe.apply_sharded(
                        p, xs.view(b, t, d), mcfg, mesh, data_axes=data_axes,
                        tp_axis="model")
                got = got.full_tensor().reshape(b * t, d)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = {n: sk.LAUNCHES[n] - before[n] for n in sk.LAUNCHES
                    if sk.LAUNCHES[n] != before[n]}
        _k7_bit_equal(local_rec, f"{arch} apply_local cf {cf}")
        _k7_bit_equal(mesh_rec, f"{arch} {path} cf {cf}")
        capacity = max(1, int(tk / e * cf))
        local_drop = _dropped(local_rec[0][1], capacity) / tk
        if path == "ep":
            # one rank: every row goes to shard 0; then its experts
            cap = max(1, int(tk * cf))
            cap2 = max(1, int(cap / e * cf))
            _require(len(mesh_rec) == 2 and launches == {
                "bincount": 2, "scatter_add": 1},
                f"{arch} apply_ep cf {cf}: launches {launches}, K7 calls "
                f"{len(mesh_rec)}")
            mesh_drop = (_dropped(mesh_rec[0][1], cap)
                         + _dropped(mesh_rec[1][1], cap2)) / tk
        else:
            _require(len(mesh_rec) == 1 and launches == {
                "bincount": 1, "scatter_add": 1},
                f"{arch} apply_sharded cf {cf}: launches {launches}")
            mesh_drop = _dropped(mesh_rec[0][1], capacity) / tk
        row = {"tokens": b * t, "seconds": seconds, "launches": launches,
               "drop_share_local": local_drop, "drop_share_mesh": mesh_drop,
               "k7_calls_bit_equal": len(local_rec) + len(mesh_rec),
               "largest_count": int(local_rec[0][1].max()),
               "capacity_local": capacity}
        same_drops = path != "ep" or (local_drop == 0 and mesh_drop == 0)
        if path == "ep" and cf > 2:
            _require(same_drops, f"{arch} cf {cf}: rows dropped "
                     f"({local_drop}, {mesh_drop}) where none should")
        if same_drops:
            row.update(_bf16_close(got, want, f"{arch} {path} cf {cf}"))
        _require(_all_finite(got) and torch.equal(
            disp.full_tensor().reshape(-1), want_disp),
            f"{arch} {path}: outputs not finite, or another dispatch than "
            f"apply_local's")
        del want, want_disp, got, aux, disp, local_rec, mesh_rec
        out[cf] = row
        log(f"  {arch} {path} on {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names}: {b} x {t} tokens x top-{k} -> {e} "
            f"experts, capacity factor {cf}: launches {launches}; K7 "
            f"{row['k7_calls_bit_equal']} counts bit-equal to bincount_plain "
            f"(largest {row['largest_count']}, apply_local's capacity "
            f"{capacity}); drop share apply_local {local_drop:.6f}, {path} "
            f"{mesh_drop:.6f}"
            + (f"; out vs apply_local max |err| {row['max_abs_err']:.4g}, "
               f"mean {row['mean_abs_err']:.4g} (mean |want| "
               f"{row['mean_abs_want']:.4g})" if same_drops else
               " (different drops by design: outputs not compared)")
            + f"; {seconds:.3f} s")
    del p, x
    torch.cuda.empty_cache()
    return out


def _mesh_state(params, mesh, cfg):
    """A train state on ``mesh``: ``params`` placed by
    ``parallel.sharding``, AdamW's state from them."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    ps = shd.distribute(params, shd.param_shardings(params, cfg, mesh))
    return {"params": ps, "opt": adamw.init(ps),
            "step": torch.zeros((), dtype=torch.int32, device=params[
                "embed"]["table"].device)}


def mesh_train_and_prefill(dev, mesh) -> dict:
    """granite-moe-1b-a400m whole at every published width (seed 0, the
    training phase's tokens of step 0): MESH_STEPS steps unmeshed, then
    the same from the same weights with the state as DTensors on
    ``mesh`` and the batch sharded over its data axis; then a prefill of
    PREFILL_B x PREFILL_T unmeshed and on the mesh.  The first step's
    xent within MESH_XENT_SPREAD (and, outside the counts, the forward
    loss with the plain combine in deterministic mode within
    MESH_XENT_DET), K5 = K7 = 2 a layer and K8 0 a step on both, each
    step's seconds (the second of each: DTensor's host cost),
    the peak memory beside the reckoning; the prefill's K8 launches equal
    and its logits' argmax agreeing at MESH_TOP1 of the positions (with
    the deterministic combine, outside the counts, the logits within
    MESH_XENT_DET of the mean |logit|; and two unmeshed prefills
    compared, for K5's own spread)."""
    import torch

    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as train_mod

    cfg = _serve_config(arch=TRAIN_ARCH)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_T, global_batch=TRAIN_B))
    toks = torch.from_numpy(data.global_batch_at(0)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=10)
    step = train_mod.make_train_step(model, train_mod.TrainConfig(), ocfg)
    per_layer = {"bincount": 2 * cfg.num_layers,
                 "scatter_add": 2 * cfg.num_layers}
    out = {}
    for name in ("unmeshed", "meshed"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        if name == "unmeshed":
            state = {"params": tree.map(lambda t: t.clone(), params),
                     "opt": adamw.init(params),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
            # the baseline: its launches are not the mesh path's
            scope, b = uncounted(), batch
        else:
            state = _mesh_state(params, mesh, cfg)
            b = shd.distribute(batch, shd.shardings_of(
                shd.batch_pspecs(batch, ("data",)), mesh))
            scope = pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model")
        state_bytes = {part: sum(t.numel() * t.element_size()
                                 for t in tree.leaves(state[part]))
                       for part in ("params", "opt")}
        rows = []
        with scope:
            for _ in range(MESH_STEPS):
                before = _launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                xent = float(metrics["xent"].full_tensor()
                             if hasattr(metrics["xent"], "full_tensor")
                             else metrics["xent"])
                torch.cuda.synchronize()
                rows.append({"seconds": time.perf_counter() - t0,
                             "xent": xent,
                             "launches": {k: v - before[k] for k, v in
                                          _launches().items()
                                          if v != before[k]}})
        peak = torch.cuda.max_memory_allocated() - held
        del state, metrics
        _require(all(r["launches"] == per_layer for r in rows),
                 f"{name} step launches {[r['launches'] for r in rows]}, "
                 f"expected {per_layer} (K8 0)")
        out[name] = {"steps": rows, "peak_memory_bytes": peak,
                     "reckoning": train_reckoning(cfg, state_bytes)}
        xents = ", ".join(repr(r["xent"]) for r in rows)
        secs = ", ".join(f"{r['seconds']:.4f}" for r in rows)
        log(f"  {TRAIN_ARCH} whole, {name}"
            + (f" on {tuple(mesh.shape)} {mesh.mesh_dim_names}"
               if name == "meshed" else "")
            + f": {TRAIN_B} x {TRAIN_T} tokens a step; xent {xents}; "
            f"seconds {secs}; launches a "
            f"step {rows[0]['launches']} (K8 0); peak {peak} bytes against "
            f"{out[name]['reckoning']['total']} reckoned")
    gap = abs(out["meshed"]["steps"][0]["xent"]
              - out["unmeshed"]["steps"][0]["xent"])
    _require(gap <= MESH_XENT_SPREAD,
             f"meshed step's xent {gap} from the unmeshed step's")
    out["xent_gap"] = gap
    # the same forward loss with a deterministic combine (outside the
    # counts): the meshed path's arithmetic against the unmeshed path's
    det = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad(), uncounted(), plain_combine():
            det["unmeshed"] = float(model.loss(params, batch)[1]["xent"])
            with pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model"):
                ps = shd.distribute(params, shd.param_shardings(
                    params, cfg, mesh))
                b = shd.distribute(batch, shd.shardings_of(
                    shd.batch_pspecs(batch, ("data",)), mesh))
                det["meshed"] = float(
                    model.loss(ps, b)[1]["xent"].full_tensor())
                del ps, b
    finally:
        torch.use_deterministic_algorithms(False)
    det_gap = abs(det["meshed"] - det["unmeshed"])
    _require(det_gap <= MESH_XENT_DET * det["unmeshed"],
             f"deterministic xent: meshed {det['meshed']!r}, unmeshed "
             f"{det['unmeshed']!r}")
    out["deterministic_xent"] = det
    host = (out["meshed"]["steps"][-1]["seconds"]
            - out["unmeshed"]["steps"][-1]["seconds"])
    log(f"  the first step's xent: meshed - unmeshed {gap!r} (within "
        f"{MESH_XENT_SPREAD}); with the plain combine in deterministic "
        f"mode {det['meshed']!r} meshed, {det['unmeshed']!r} unmeshed "
        f"(|diff| {det_gap!r}, within {MESH_XENT_DET} relative); step "
        f"{MESH_STEPS} "
        f"{out['meshed']['steps'][-1]['seconds']:.4f} s meshed against "
        f"{out['unmeshed']['steps'][-1]['seconds']:.4f} s unmeshed "
        f"({host:+.4f} s: DTensor's host cost)")

    tokens = toks[:PREFILL_B]
    ps = shd.distribute(params, shd.param_shardings(params, cfg, mesh))
    tok_dt = shd.distribute({"t": tokens}, shd.shardings_of(
        shd.batch_pspecs({"t": tokens}, ("data",)), mesh))["t"]

    def prefill(meshed: bool):
        with torch.no_grad():
            if not meshed:
                return model.forward(params, tokens)[0]
            with pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model"):
                return model.forward(ps, tok_dt)[0].full_tensor()

    def agreement(got, want) -> dict:
        diff = (got - want).abs()
        return {"top1_agreement": float(
                    (got.argmax(-1) == want.argmax(-1)).float().mean()),
                "max_abs_err": float(diff.max()),
                "mean_abs_err": float(diff.mean()),
                "mean_abs_want": float(want.abs().mean())}

    # the arithmetic: with the combine's plain version in deterministic
    # mode (outside the counts), meshed against unmeshed
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with uncounted(), plain_combine():
            want = prefill(False)
            got = prefill(True)
            det = agreement(got, want)
            del got, want
    finally:
        torch.use_deterministic_algorithms(False)
    _require(det["max_abs_err"] <= MESH_XENT_DET * det["mean_abs_want"],
             f"meshed prefill, deterministic combine: {det}")
    # on K5: the unmeshed prefill twice (outside the counts), then meshed
    k8 = {}
    with uncounted():
        before = _launches()["flash_attention"]
        want = prefill(False)
        k8["unmeshed"] = _launches()["flash_attention"] - before
        again = agreement(prefill(False), want)
    torch.cuda.synchronize()
    before = _launches()["flash_attention"]
    t0 = time.perf_counter()
    got = prefill(True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k8["meshed"] = _launches()["flash_attention"] - before
    _require(k8["meshed"] == k8["unmeshed"] == cfg.num_layers,
             f"prefill K8 launches {k8}")
    _require(got.shape == want.shape and _all_finite(got),
             f"meshed prefill logits {tuple(got.shape)}")
    meshed = agreement(got, want)
    _require(meshed["top1_agreement"] >= MESH_TOP1,
             f"meshed prefill: {meshed}")
    out["prefill"] = {"k8": k8["meshed"], "seconds": seconds,
                      "deterministic": det, "meshed": meshed,
                      "unmeshed_twice": again}
    log(f"  prefill {PREFILL_B} x {PREFILL_T}: K8 {k8['meshed']} meshed, "
        f"{k8['unmeshed']} unmeshed; meshed {seconds:.3f} s")
    for label, row in (("deterministic combine, meshed vs unmeshed", det),
                       ("K5, unmeshed twice", again),
                       ("K5, meshed vs unmeshed", meshed)):
        log(f"  prefill logits, {label}: top-1 agreement "
            f"{row['top1_agreement']:.4f}, max |diff| "
            f"{row['max_abs_err']:.4g}, mean {row['mean_abs_err']:.4g} "
            f"against mean |logit| {row['mean_abs_want']:.4g}")
    del got, want
    out["decode"] = mesh_decode(model, cfg, mesh, params, ps, tokens,
                                agreement)
    del ps, tok_dt, params, model
    torch.cuda.empty_cache()
    return out


MESH_DECODE_STEPS = 4
MESH_DECODE_LEN = 64                 # cache slots, over the model axis


def mesh_decode(model, cfg, mesh, params, ps, tokens, agreement) -> dict:
    """granite's decode on the mesh: a cache of MESH_DECODE_LEN slots laid
    out by ``cache_pspecs`` (DTensors, the KV sequence over the model
    axis), MESH_DECODE_STEPS steps from an empty cache teacher-forced with
    the prefill's tokens, against the same steps unmeshed.  K7 and K5
    launch once a layer a step both ways (the unmeshed run outside the
    counts); with the plain combine in deterministic mode (outside the
    counts) the logits are bit-equal; on K5 their agreement is logged."""
    import torch

    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as shd

    b = tokens.shape[0]
    tok_dt = shd.distribute({"t": tokens}, shd.shardings_of(
        shd.batch_pspecs({"t": tokens}, ("data",)), mesh))["t"]

    def run(meshed: bool):
        with torch.no_grad():
            cache = model.init_cache(params, b, MESH_DECODE_LEN)
            p, toks, ctx = params, tokens, contextlib.nullcontext()
            if meshed:
                cache = shd.distribute(cache, shd.shardings_of(
                    shd.cache_pspecs(cache, cfg, data_axes=("data",),
                                     seq_axis="model"), mesh))
                p, toks = ps, tok_dt
                ctx = pctx.use_mesh(mesh, data_axes=("data",),
                                    tp_axis="model")
            logits = []
            with ctx:
                for i in range(MESH_DECODE_STEPS):
                    lg, cache = model.decode_step(p, toks[:, i:i + 1],
                                                  cache, pos=i)
                    logits.append(lg.full_tensor() if meshed else lg)
            return torch.cat(logits, dim=1)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with uncounted(), plain_combine():
            det = agreement(run(True), run(False))
    finally:
        torch.use_deterministic_algorithms(False)
    _require(det["max_abs_err"] == 0.0,
             f"meshed decode, deterministic combine: {det}")
    want_n = cfg.num_layers * MESH_DECODE_STEPS
    counts = {}
    with uncounted():
        before = dict(sk.LAUNCHES)
        t0 = time.perf_counter()
        want = run(False)
        torch.cuda.synchronize()
        unmeshed_s = time.perf_counter() - t0
        counts["unmeshed"] = {k: sk.LAUNCHES[k] - before[k]
                              for k in ("bincount", "scatter_add")}
    before = dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    got = run(True)
    torch.cuda.synchronize()
    meshed_s = time.perf_counter() - t0
    counts["meshed"] = {k: sk.LAUNCHES[k] - before[k]
                        for k in ("bincount", "scatter_add")}
    _require(all(n == want_n for c in counts.values() for n in c.values()),
             f"decode K7/K5 launches {counts}, want {want_n} each")
    _require(got.shape == want.shape and _all_finite(got),
             f"meshed decode logits {tuple(got.shape)}")
    k5 = agreement(got, want)
    log(f"  decode {b} x {MESH_DECODE_STEPS} steps from a "
        f"{MESH_DECODE_LEN}-slot cache: K7 = K5 = {want_n} both ways; "
        f"deterministic combine max |diff| {det['max_abs_err']!r} "
        f"(bit-equal); on K5 top-1 agreement {k5['top1_agreement']:.4f}, "
        f"max |diff| {k5['max_abs_err']:.4g}; {meshed_s:.3f} s meshed, "
        f"{unmeshed_s:.3f} s unmeshed")
    return {"launches": counts, "deterministic": det, "k5": k5,
            "meshed_s": meshed_s, "unmeshed_s": unmeshed_s}


def mesh_path(dev) -> dict:
    """The mesh phase: a one-rank NCCL group (no network: a ``HashStore``
    and the loopback interface), a (1, 1, 1) ("pod", "data", "model") mesh
    and a (1, 1) ("data", "model") mesh on the card; qwen3-moe's layer
    through ``apply_ep``, granite's through ``apply_sharded``, then
    granite whole: a train step and a prefill on the mesh.  The group is
    destroyed at the end."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh3 = mesh_mod.compat_make_mesh((1, 1, 1), ("pod", "data", "model"))
        mesh2 = mesh_mod.compat_make_mesh((1, 1), ("data", "model"))
        out = {"qwen3-moe layer": mesh_moe_layer(
            dev, mesh3, "qwen3-moe-235b-a22b", "ep")}
        out["granite-moe layer"] = mesh_moe_layer(
            dev, mesh2, "granite-moe-1b-a400m", "sharded")
        out["granite-moe whole"] = mesh_train_and_prefill(dev, mesh2)
    finally:
        dist.destroy_process_group()
    return out


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
    sizes; then at the families' shapes (FAMILY_K8_SHAPES, batch 4):
    llama-vision's (32/8, d = 128), Whisper's encoder (12/12 x 1500, d =
    64, not causal) and decoder (12/12 x 448, causal), and zamba2's shared
    attention (32/32 x 2048, d = 64, causal).

    Operations: the useful products, 2 flop per multiply-add for QK^T and
    for P V over the visible (query, key) pairs (T (T + 1) / 2 causal,
    T^2 not), against the dense bf16 tensor-core rate.  Bytes: q, k, v
    read once, the output written once.  The library yardstick is
    ``scaled_dot_product_attention(is_causal=..., enable_gqa=True)``,
    timed here only; the port never calls it.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    cases = [(f"prefill {PREFILL_B}x{{h}}/{{kv}}x{PREFILL_T}x{{d}} bf16 causal",
              arch, PREFILL_T, True)
             for arch in (SERVE_ARCH,) + tuple(a for a, _, _ in MOE_SERVE)]
    cases += [(f"{label} {PREFILL_B}x{{h}}/{{kv}}x{t}x{{d}} bf16 "
               f"{'causal' if causal else 'not causal'}", arch, t, causal)
              for label, arch, t, causal in FAMILY_K8_SHAPES]
    out = {}
    for name, arch, t, causal in cases:
        cfg = _serve_config(arch=arch)
        b, h, kv, d = (PREFILL_B, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim)
        q, k, v = flash_case(b, h, kv, t, d, torch.bfloat16, dev, seed=5)
        group = h // kv
        pairs = t * (t + 1) / 2 if causal else t * t
        flops = 4.0 * b * h * d * pairs
        nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
        bound_ms, bound_by = bound(nbytes, flops, BF16_OPS_PER_S)
        case = name.format(h=h, kv=kv, d=d)
        row = {
            "ms": time_ms(lambda: fk.flash_attention_launch(
                q, k, v, causal=causal, group=group), reps=25),
            "plain_ms": time_ms(lambda: fk.attention_plain(
                q, k, v, causal=causal, group=group), reps=5, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=25),
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

        t0 = phase("main path: the zoo audit (every config captured at "
                   "its production shapes) and its finding specs on K6")
        hk.reset_launches()
        sk.reset_launches()
        n_zoo = zoo_path(dev, Path(tmp), tables)
        torch.cuda.synchronize()
        zoo = {k: n for k, n in {**hk.LAUNCHES, **sk.LAUNCHES}.items()
               if n}
        _require(zoo == {k: n_zoo for k in AUDIT_KERNELS},
                 f"zoo path launched {zoo} for {n_zoo} specs")
        for k in AUDIT_KERNELS:
            by_path[k]["zoo"] = zoo[k]
            launches[k] += zoo[k]
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches {zoo}")

        t0 = phase("main path: the kernel lint (python -m repro_torch "
                   "lint), K3 and K6 against it, its declarations against "
                   "the SASS")
        hk.reset_launches()
        sk.reset_launches()
        fk.reset_launches()
        lint = lint_path(dev, Path(tmp), tables, sass)
        torch.cuda.synchronize()
        _require(lint == {"hist_instrumented": 3,
                          "scatter_add_instrumented": 2},
                 f"lint path launched {lint}")
        for k in LINT_KERNELS:
            by_path[k]["lint"] = lint[k]
            launches[k] += lint[k]
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches {lint}")

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
    t0 = phase("main path: serving gemma2, llama-3.2-vision and "
               "whisper-small prefill and decode")
    hk.reset_launches()
    sk.reset_launches()
    fk.reset_launches()
    family_serving_path(dev)
    torch.cuda.synchronize()
    family_launches = {k: n for k, n in _launches().items() if n}
    _require(family_launches.keys() == set(SERVE_KERNELS),
             f"families' serving path launched {family_launches}")
    for k, n in family_launches.items():
        by_path[k]["families"] = n
        launches[k] += n
    log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
        f"{family_launches}")
    t0 = phase("main path: serving rwkv6-7b and zamba2-1.2b prefill and "
               "decode")
    hk.reset_launches()
    sk.reset_launches()
    fk.reset_launches()
    family_serving_path(dev, SSM_SERVE)
    torch.cuda.synchronize()
    ssm_launches = {k: n for k, n in _launches().items() if n}
    _require(ssm_launches.keys() == set(SERVE_KERNELS),
             f"rwkv6/zamba2 serving path launched {ssm_launches}")
    for k, n in ssm_launches.items():
        by_path[k]["ssm"] = n
        launches[k] += n
    log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
        f"{ssm_launches}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = phase(f"main path: training {TRAIN_ARCH} whole, its restart, "
                   f"one step of whisper-small and zamba2-1.2b")
        hk.reset_launches()
        sk.reset_launches()
        fk.reset_launches()
        training_path(dev, Path(tmp), err)
        torch.cuda.synchronize()
        train_launches = {k: n for k, n in _launches().items() if n}
        _require(train_launches.keys() == set(TRAIN_KERNELS),
                 f"training path launched {train_launches}")
        for k, n in train_launches.items():
            by_path[k]["training"] = n
            launches[k] += n
        log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
            f"{train_launches}")
    t0 = phase("main path: the mesh (one-rank NCCL meshes): qwen3-moe's "
               "layer through apply_ep, granite-moe's through "
               "apply_sharded, granite whole: a train step, a prefill and "
               "decode steps on a sharded cache")
    hk.reset_launches()
    sk.reset_launches()
    fk.reset_launches()
    mesh_path(dev)
    torch.cuda.synchronize()
    mesh_launches = {k: n for k, n in _launches().items() if n}
    _require(mesh_launches.keys() == set(MESH_KERNELS),
             f"mesh path launched {mesh_launches}")
    for k, n in mesh_launches.items():
        by_path[k]["mesh"] = n
        launches[k] += n
    log(f"  ok in {time.perf_counter() - t0:.1f} s; launches "
        f"{mesh_launches}")
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
