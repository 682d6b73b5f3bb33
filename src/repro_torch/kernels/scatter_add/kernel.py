"""Hopper scatter-add and bincount kernels (K5-K7), with plain versions.

The production faces of the paper's hot spot: MoE token->expert dispatch
counting (bincount), expert-output combine and embedding-gradient
accumulation (scatter-add).  ``csrc/scatter_add.cu`` holds three kernels,
each the counterpart of a Pallas kernel of
``repro/kernels/scatter_add/kernel.py``:

  * K5 ``scatter_add``: segment sums of (N, D) f32/bf16/f16 values by (N,)
    int32 ids into (S, D) f32, through a shared-memory copy of the result
    when it fits ``SHARED_BUDGET`` and with global atomics otherwise,
    16-byte vector adds where the rows allow, and for wide rows with no
    atomics, each output row summed by one block (``scatter_add_route``);
    equal ids are summed within a warp before they are added,
  * K6 ``scatter_add_instrumented``: K5's sums on a committed id stream,
    plus the stream's per-wave degrees (K1, ``csrc/wave_degrees.cuh``), in
    one pass of a warp per wave that adds once per distinct id of each
    commit group,
  * K7 ``bincount``: int32 occurrence counts, S <= 8192, by the POPC
    increment into a shared copy a block, reading 16-byte words where the
    grid has fewer threads than ids; one block stores every count of a
    short stream (one launch), one block an SM adds its counts into an
    output that a kernel it overlaps zeroes for a longer one
    (``bincount_route``).

K5 and K7 are ``torch.library`` operators, ``repro_torch::scatter_add``
and ``repro_torch::bincount``: the CUDA implementation launches the
kernel, the CPU one runs the plain torch version, and a fake
implementation gives the result's shape on the meta device or under
``FakeTensorMode``, so that a captured step holds each as one node.
Each launcher runs its kernel for a CUDA tensor and the plain version for
a CPU tensor; it never falls back from one to the other.
``scatter_add_autograd`` is K5 under autograd (the MoE combine in
training): its forward is ``scatter_add_launch``, its backward the
gather ``scatter_add_grad_plain``, plain torch, as the reference's
gradient of the segment sum is XLA's transpose and no Pallas kernel.  All
keep the Pallas kernels' drop rule: an id outside [0, S), negative or not,
adds nothing.  Unlike the Pallas launchers they take N unpadded: the
kernels stop at the last row themselves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import instrumentation as instr

DEFAULT_TILE = 2048
DEFAULT_SEG_BLOCK = 4096
MAX_BINCOUNT_SEGMENTS = 8192
# K7's one-block route takes streams up to this many ids: where it saves
# the output's zeroing kernel and one SM still reads the ids in about the
# time that many would (tools/bench_bincount.py --candidates, PERF.md)
BINCOUNT_BLOCK_IDS = 1 << 13
# the shared route's per-block budget: two such blocks share one SM's
# 227 KB of shared memory
SHARED_BUDGET = 96 * 1024
VALUE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# K5's routes as its C entry point numbers them
K5_ROUTES = {"global": 0, "shared": 1, "global-vector": 2, "global-owned": 3}
# the owned route's least row, in values: vector tiles pay an L2 add per
# value, owned rows pay their bytes and every block's read of every id;
# owned rows won from 2048 values a row (f32 and bf16) and lost at 1024
# (tools/bench_cas_kernels.py --routes, PERF.md)
OWNED_MIN_COLUMNS = 2048

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"scatter_add": 0, "scatter_add_instrumented": 0, "bincount": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "repro_scatter_add": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_scatter_add_instrumented": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P],
    "repro_bincount": [_P, _P, _I, _I, _P],
    "repro_bincount_block": [_P, _P, _I, _I, _P],
}


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind("scatter_add", _ARGTYPES)


def scatter_route(num_segments: int, d: int) -> str:
    """``"shared"`` when the (S, D) f32 result fits one block's shared
    budget, else ``"global"``."""
    return "shared" if num_segments * d * 4 <= SHARED_BUDGET else "global"


def scatter_add_route(values: torch.Tensor, num_segments: int) -> str:
    """K5's route for ``values``: ``scatter_route``'s, and on the global
    route, where each row splits into 16-byte parts (D a multiple of 4,
    every row and the base 16-byte aligned) that the kernel loads whole,
    ``"global-owned"`` for rows of ``OWNED_MIN_COLUMNS`` values or more
    (each output row summed by one block, no atomics) and
    ``"global-vector"`` (f32 vector adds) for narrower ones."""
    return _scatter_add_route(num_segments, values.shape[1],
                              values.element_size(),
                              values.data_ptr() % 16 == 0)


def _scatter_add_route(num_segments: int, d: int, element_size: int,
                       aligned: bool) -> str:
    route = scatter_route(num_segments, d)
    if (route == "global" and d % 4 == 0 and d * element_size % 16 == 0
            and aligned):
        return ("global-owned" if d >= OWNED_MIN_COLUMNS
                else "global-vector")
    return route


def bincount_route(n: int, num_segments: int) -> str:
    """K7's route for ``n`` ids into ``num_segments`` bins: ``"block"`` (one
    block stores every count: one launch) up to ``BINCOUNT_BLOCK_IDS`` ids,
    else ``"grid"`` (a kernel zeroes the output while one block an SM
    counts, then adds its counts into it).  Refuses more than ``MAX_BINCOUNT_SEGMENTS`` bins."""
    if not 0 <= num_segments <= MAX_BINCOUNT_SEGMENTS:
        raise ValueError(f"bincount takes at most {MAX_BINCOUNT_SEGMENTS} "
                         f"segments, got {num_segments}; use scatter_add")
    return "block" if n <= BINCOUNT_BLOCK_IDS else "grid"


def check_segment_blocking(num_segments: int, seg_block: int) -> None:
    """The reference's refusal: a segment axis wider than one block must
    be a whole number of blocks (``scatter_add_pallas``)."""
    if not (num_segments % seg_block == 0 or num_segments < seg_block):
        raise ValueError(f"{num_segments} segments is not a whole number of "
                         f"{seg_block}-segment blocks")


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _kept(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_segments)


def scatter_add_plain(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """(S, D) sums of ``values`` rows by id, accumulated in f64, returned
    f32; out-of-range ids drop."""
    keep = _kept(ids, num_segments)
    out = torch.zeros((num_segments, values.shape[1]), dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, ids[keep].to(torch.int64),
                   values[keep].to(torch.float64))
    return out.to(torch.float32)


def scatter_add_grad_plain(grad_out: torch.Tensor, ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    """The segment sum's gradient with respect to its values: row i is
    ``grad_out[ids[i]]``, zero where ``ids[i]`` is outside [0, S) (the
    row was dropped, so it moved nothing)."""
    keep = _kept(ids, num_segments)
    if num_segments == 0:
        return grad_out.new_zeros((ids.shape[0], grad_out.shape[1]))
    rows = grad_out[ids.clamp(0, num_segments - 1).to(torch.int64)]
    return torch.where(keep[:, None], rows, 0.0)


def bincount_plain(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(S,) int32 counts; out-of-range ids drop."""
    kept = ids[_kept(ids, num_segments)].to(torch.int64)
    return torch.bincount(kept, minlength=num_segments).to(torch.int32)


def committed_ids_plain(ids: torch.Tensor) -> torch.Tensor:
    """The ids K5-K7 add at, in the order their warps commit them: as
    given, 32 consecutive ids a warp."""
    return ids.reshape(-1)


def scatter_add_instrumented_plain(values: torch.Tensor, ids: torch.Tensor,
                                   num_segments: int):
    """Plain K6: sums of the rows ``values`` has, degrees of the whole
    committed stream ``ids``."""
    return (scatter_add_plain(values, ids[:values.shape[0]], num_segments),
            instr.wave_degrees_plain(committed_ids_plain(ids)))


# ---------------------------------------------------------------------------
# The launches as the kernel lint models them
# ---------------------------------------------------------------------------

_TYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16"}
# csrc/scatter_add.cu: the segments an owned-route block sorts its rows
# into at a time
OWNED_SEGMENTS = 1024


def _id_stream(n: int, tile: int):
    """The grid (tiles of ``tile`` ids) and the ids' operand."""
    from repro_torch.lint.tracing import Operand

    return (-(-n // tile),), Operand("ids", (tile,), (0,))


def scatter_add_lint_declaration(n: int, d: int, num_segments: int,
                                 dtype: torch.dtype = torch.float32,
                                 tile: int = DEFAULT_TILE):
    """What ``scatter_add_launch`` runs on n ids and (n, d) ``dtype``
    values, declared for the kernel lint
    (``repro_torch.lint.tracing.LaunchDecl``), on the route the launcher
    takes (``scatter_add_route``, for values as the card allocates them,
    16-byte aligned).

    The shared route adds each value into a block's shared copy of the
    (S, d) result, zeroed before ``__syncthreads`` (an
    ``atomicAdd(float)``: a CAS loop on Hopper), and adds the copy's
    non-zero entries into the result; the global routes add into the
    result, zeroed by the launcher, at L2 (``RED``: a native f32 add,
    four values at once on the vector route); the owned route counts and
    places each block's rows by segment in shared memory (the POPC
    increment, then an ``atomicAdd(int)`` whose result it reads) and
    stores each segment's sum.  The grid is the ids' tiles; the committed
    stream is the ids (``committed_ids_plain``, the function K6's degrees
    are held to).  Refs are numbered as the reference's: ids, values.
    """
    from repro_torch.lint.tracing import (Accumulator, LaunchDecl, Operand,
                                          Store)

    route = _scatter_add_route(num_segments, d,
                               torch.empty((), dtype=dtype).element_size(),
                               aligned=True)
    grid, ids = _id_stream(n, tile)
    values = Operand("values", (tile, d), (0, None))
    rows = dict(name="sums", shape=(num_segments, d), bins=num_segments,
                row_elems=d, kind="one_hot_matmul")
    kernel, stores = "scatter_tiles_kernel", ()
    if route == "shared":
        accs = (Accumulator(**rows, memory="shared", init="block",
                            combine="cas", flush="add"),)
    elif route in ("global", "global-vector"):
        accs = (Accumulator(**rows, memory="global", init="caller",
                            combine="fao", flush="",
                            vector=4 if route == "global-vector" else 1),)
    else:
        kernel = "scatter_owned_kernel"
        bins = min(num_segments, OWNED_SEGMENTS)
        accs = tuple(Accumulator(
            name=name, shape=(OWNED_SEGMENTS + 1,), bins=bins,
            memory="shared", init="block", combine=combine, flush="")
            for name, combine in (("segment_rows", "popc"),
                                  ("placements", "fao")))
        stores = (Store("sums", (num_segments, d), (None, None)),)
    if d == 1 and kernel == "scatter_tiles_kernel":
        kernel = "scatter_rows_kernel"
    flags = {"shared": ",shared", "global-vector": ",vector"}.get(route, "")
    return LaunchDecl(
        kernel=f"{kernel}<{_TYPE_NAMES[dtype]}{flags}>",
        source="csrc/scatter_add.cu", grid=grid, inputs=(ids, values),
        accumulators=accs, stores=stores, stream=committed_ids_plain,
        stream_refs=((0, torch.int32),))


def bincount_lint_declaration(n: int, num_segments: int,
                              tile: int = DEFAULT_TILE):
    """What ``bincount_launch`` runs on n ids, declared for the kernel
    lint, on its route (``bincount_route``): a block's shared copy of the
    S counts, zeroed before ``__syncthreads``, incremented by the POPC
    ``atomicAdd(int)`` of 1; the one-block route stores the copy, the
    grid route adds each count into the result (zeroed by a kernel of its
    own) at L2.  The committed stream is the ids."""
    from repro_torch.lint.tracing import Accumulator, LaunchDecl

    route = bincount_route(n, num_segments)
    grid, ids = _id_stream(n, tile)
    acc = Accumulator(name="counts", shape=(num_segments,),
                      bins=num_segments, memory="shared", init="block",
                      combine="popc",
                      flush="store" if route == "block" else "add")
    return LaunchDecl(
        kernel=f"bincount_kernel<{'store' if route == 'block' else ''}>",
        source="csrc/scatter_add.cu", grid=grid, inputs=(ids,),
        accumulators=(acc,), stream=committed_ids_plain,
        stream_refs=((0, torch.int32),))


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check_ids(ids: torch.Tensor, device: torch.device) -> None:
    if (ids.dtype != torch.int32 or ids.dim() != 1
            or not ids.is_contiguous() or ids.device != device):
        raise ValueError(f"ids must be a contiguous 1-D int32 tensor on "
                         f"{device}, got {tuple(ids.shape)} {ids.dtype} on "
                         f"{ids.device}")
    if ids.numel() >= 2 ** 31:
        raise ValueError(f"{ids.numel()} ids overflow int32 indexing")


def _check_values(values: torch.Tensor, num_segments: int,
                  dtypes) -> None:
    if (values.dim() != 2 or not values.is_contiguous()
            or values.dtype not in dtypes):
        raise ValueError(f"values must be a contiguous (N, D) tensor of "
                         f"{sorted(map(str, dtypes))}, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if values.numel() >= 2 ** 31 or num_segments * values.shape[1] >= 2 ** 31:
        raise ValueError(f"{tuple(values.shape)} values into {num_segments} "
                         f"segments overflow int32 indexing")
    if num_segments < 0:
        raise ValueError(f"negative segment count {num_segments}")


# ---------------------------------------------------------------------------
# The operators: ``torch.library`` custom ops, so that the dispatcher (and
# a tracer: the meta device, ``FakeTensorMode``, ``launch.capture``) sees
# each kernel as one node.  The CUDA implementation is the launcher, the
# CPU one the plain version; another device has no implementation and the
# dispatcher refuses it.  The fake implementation gives the result's shape.
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::scatter_add", mutates_args=(),
                         device_types="cpu")
def scatter_add_op(values: torch.Tensor, ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """K5 as an operator: (S, D) f32 segment sums."""
    return scatter_add_plain(values, ids, num_segments)


@scatter_add_op.register_kernel("cuda")
def _scatter_add_cuda(values, ids, num_segments):
    _check_values(values, num_segments, VALUE_DTYPES)
    _check_ids(ids, values.device)
    n, d = values.shape
    if ids.shape[0] != n:
        raise ValueError(f"{ids.shape[0]} ids for {n} value rows")
    route = K5_ROUTES[scatter_add_route(values, num_segments)]
    out = torch.zeros((num_segments, d), dtype=torch.float32,
                      device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_scatter_add(
            values.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d,
            num_segments, VALUE_DTYPES[values.dtype], route, stream),
            "scatter_add")
    _build.count_launch(LAUNCHES, "scatter_add")
    return out


@scatter_add_op.register_fake
def _scatter_add_fake(values, ids, num_segments):
    return values.new_empty((num_segments, values.shape[1]),
                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::bincount", mutates_args=(),
                         device_types="cpu")
def bincount_op(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K7 as an operator: (S,) int32 counts."""
    return bincount_plain(ids, num_segments)


@bincount_op.register_kernel("cuda")
def _bincount_cuda(ids, num_segments):
    route = bincount_route(ids.numel(), num_segments)
    _check_ids(ids, ids.device)
    # the kernel stores every count, or its launcher zeroes out first
    out = torch.empty(num_segments, dtype=torch.int32, device=ids.device)
    entry = (_lib().repro_bincount_block if route == "block"
             else _lib().repro_bincount)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(entry(ids.data_ptr(), out.data_ptr(),
                                    ids.numel(), num_segments, stream),
                              "bincount")
    _build.count_launch(LAUNCHES, "bincount")
    return out


@bincount_op.register_fake
def _bincount_fake(ids, num_segments):
    return ids.new_empty((num_segments,), dtype=torch.int32)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {t.device}")
    return True


def scatter_add_launch(values: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """K5: (S, D) f32 segment sums of (N, D) ``values`` by (N,) ``ids``
    (``repro_torch::scatter_add``)."""
    return scatter_add_op(values, ids, num_segments)


class _ScatterAdd(torch.autograd.Function):
    """K5 forward (``scatter_add_launch``: the kernel on the card, the
    plain version on the CPU), the gather backward."""

    @staticmethod
    def forward(ctx, values, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments, ctx.dtype = num_segments, values.dtype
        return scatter_add_launch(values, ids, num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        ids, = ctx.saved_tensors
        grad = scatter_add_grad_plain(grad_out, ids, ctx.num_segments)
        return grad.to(ctx.dtype), None, None


def scatter_add_autograd(values: torch.Tensor, ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """``scatter_add_launch`` that autograd differentiates with respect to
    ``values``: the operator has no autograd formula of its own."""
    return _ScatterAdd.apply(values, ids, num_segments)


def scatter_add_instrumented_launch(values: torch.Tensor, ids: torch.Tensor,
                                    num_segments: int):
    """K6 on a committed id stream.

    ``ids`` is a whole number of 1024-id waves, at least as long as
    ``values`` (N, D) f32 has rows; the ids past row N are padding.
    Returns the (S, D) f32 sums of the N rows and the stream's per-wave
    degrees, (len(ids) / 1024,) f32.
    """
    if ids.numel() % instr.LANES or ids.numel() < values.shape[0]:
        raise ValueError(f"a committed stream of {ids.numel()} ids is not a "
                         f"whole number of {instr.LANES}-id waves covering "
                         f"{values.shape[0]} value rows")
    if not _on_card(values, "scatter_add_instrumented"):
        return scatter_add_instrumented_plain(values, ids, num_segments)
    _check_values(values, num_segments, {torch.float32: 0})
    _check_ids(ids, values.device)
    n, d = values.shape
    n_pad = ids.numel()
    shared = scatter_route(num_segments, d) == "shared"
    out = torch.zeros((num_segments, d), dtype=torch.float32,
                      device=values.device)
    deg = torch.empty(n_pad // instr.LANES, dtype=torch.float32,
                      device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_scatter_add_instrumented(
            values.data_ptr(), ids.data_ptr(), out.data_ptr(), deg.data_ptr(),
            n, n_pad, d, num_segments, int(shared), stream),
            "scatter_add_instrumented")
    _build.count_launch(LAUNCHES, "scatter_add_instrumented")
    return out, deg


def bincount_launch(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K7: (S,) int32 occurrence counts of (N,) ``ids``, S <= 8192
    (``repro_torch::bincount``)."""
    bincount_route(ids.numel(), num_segments)
    return bincount_op(ids, num_segments)
