"""Hopper flash attention (K8), with its plain version.

``csrc/flash_attention.cu`` is the counterpart of ``_flash_kernel`` in
``repro/kernels/flash_attention/kernel.py``: softmax attention computed
online over KV tiles, optionally causal, in f32, with the output in the
input's dtype.  One launch covers (B, H, T, d) q against (B, H / group,
T, d) k and v: query head h reads KV head ``h // group`` (GQA), and
``group=1`` is the reference's kernel.  The C launcher picks one of
three routes by dtype and head size: f32 inputs run on the CUDA cores in
f32; bf16 inputs at d = 64 and 128 run the Hopper kernel (TMA loads into
a ring of shared-memory stages, ``wgmma`` products, a producer and two
consumer warpgroups); bf16 at d = 16 and 32 run ``mma.sync``.  Both bf16
routes sum in f32.  T may be any length: the kernel masks a ragged last
tile.  v (and the output) may have a head size of its own where q and k
have another: the Hopper route takes bf16 at q·k 192 and v 128, latent
attention's prefill (``models/mla.py``), in a kernel of its own
(``flash_mla_sm90_kernel``); every other route takes one head size.

K8 is the ``torch.library`` operator ``repro_torch::flash_attention``:
its CUDA implementation launches the kernel, its CPU one runs the plain
version, and its fake implementation gives the result's shape on the
meta device or under ``FakeTensorMode``; its FLOP formula (for
``FlopCounterMode``) counts the full products, 2·B·H·T²·(d + d_v), which
is 4·B·H·T²·d at one head size.  The launcher
runs the kernel for CUDA tensors and the plain version for CPU tensors;
it never falls back from one to the other.  Neither has a
backward: an input that requires grad, with grad mode on, is refused, as
the reference's kernel has no gradient either.

Under autograd, the bf16 Hopper route (d = 64 and 128) has a backward of
its own, with no TPU counterpart: ``repro_torch::flash_attention_fwd``
runs that route's kernel and also stores each query row's log-sum-exp of
its scaled scores (f32, (B, H, T)), and ``repro_torch::flash_attention_bwd``
recomputes the scores tile by tile from it to give dq, dk and dv (three
launches: D = rowsum(dO o O), then dQ, then dK and dV with the GQA sum
inside a block; no atomics, so two runs give equal gradients).
``register_autograd`` ties the two; ``flash_attention_autograd`` is the
model's call.  Their CPU implementations are the plain versions' f32
math, their fake ones give shapes, and their FLOP formulas count the
forward's full products, 4·B·H·T²·d, and the backward's, 8·B·H·T²·d, as
PyTorch counts ``scaled_dot_product_attention`` and its backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
# the (q·k, v) head sizes of the routes: one size each, and latent
# attention's pair, bf16 only
MLA_HEAD_DIMS = (192, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -2.0e38
# the head sizes of the bf16 Hopper route, which alone has a backward
GRAD_HEAD_DIMS = (64, 128)
# the backward's scratch rows a head are T rounded up to this (kBwdPad)
BWD_PAD = 128

# kernel launches since the last reset_launches(): K8 without a gradient;
# the forward that keeps the LSE; the backward (its three kernels, one call)
LAUNCHES = {"flash_attention": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, ctypes.c_float, _P],
    "repro_flash_attention_smem": [_I, _I],
    "repro_flash_attention_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _P],
    "repro_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P],
    "repro_flash_attention_bwd_smem": [_I, _I],
}


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind("flash_attention", _ARGTYPES)


def shared_memory_bytes(head_dim: int, v_head_dim: Optional[int] = None
                        ) -> int:
    """Dynamic shared memory of one block of the bf16 route at
    ``head_dim`` (q·k) and ``v_head_dim`` (default the same; 0 where that
    route uses static shared memory only); builds the library."""
    return _lib().repro_flash_attention_smem(
        head_dim, head_dim if v_head_dim is None else v_head_dim)


def backward_shared_memory_bytes(head_dim: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the backward's dK/dV kernel
    and of its dQ kernel at ``head_dim`` (64 or 128); builds the
    library."""
    lib = _lib()
    return (lib.repro_flash_attention_bwd_smem(head_dim, 0),
            lib.repro_flash_attention_bwd_smem(head_dim, 1))


# query rows a block of each route takes (csrc/flash_attention.cu:
# kF32Rows, kMmaRows, kSm90Rows)
ROUTE_ROWS = {"flash_f32_kernel": 16, "flash_bf16_kernel": 64,
              "flash_bf16_sm90_kernel": 128}


def lint_declaration(b: int, h: int, t: int, d: int, *,
                     dtype: torch.dtype = torch.float32):
    """What ``flash_attention_launch`` runs on (B, H, T, d) q, declared for
    the kernel lint (``repro_torch.lint.tracing.LaunchDecl``): a block to
    each (batch, head, tile of query rows), reading its q rows and the
    whole of its head's k and v (head ``h // group``), and storing its own
    rows of the output.  No atomic, so no scatter site.  The C launcher
    picks the kernel: f32 on the CUDA cores, bf16 at d = 64 and 128 on
    ``wgmma``, at d = 16 and 32 on ``mma.sync``."""
    from repro_torch.lint.tracing import LaunchDecl, Operand, Store

    if dtype == torch.float32:
        kernel = "flash_f32_kernel"
    else:
        kernel = ("flash_bf16_sm90_kernel" if d in (64, 128)
                  else "flash_bf16_kernel")
    rows = ROUTE_ROWS[kernel]
    q = (1, 1, rows, d)
    kv = (1, 1, t, d)
    return LaunchDecl(
        kernel=f"{kernel}<{d}>", source="csrc/flash_attention.cu",
        grid=(b, h, -(-t // rows)),
        inputs=(Operand("q", q, (0, 1, 2, None)),
                Operand("k", kv, (0, 1, None, None)),
                Operand("v", kv, (0, 1, None, None))),
        stores=(Store("out", q, (0, 1, 2, None)),))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, group: int = 1,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, T, d) q and k over (B, H / group, T, d_v) v -> (B, H, T, d_v)
    (d_v is d but for latent attention).

    The whole (T, T) score matrix in f32, times ``scale`` (default
    d ** -0.5), a ``NEG_INF`` mask, and the result in q's dtype:
    ``ref.attention_ref`` with a batch axis and grouped KV heads,
    updating its scores in place to hold the memory to one f32 copy of
    them.
    """
    return attention_fwd_plain(q, k, v, causal=causal, group=group,
                               scale=scale)[0]


def _scores(q, k, causal, group, scale):
    """The (B, H / group, group, T, T) f32 scores times ``scale`` (default
    d ** -0.5), masked with ``NEG_INF`` where causal."""
    b, h, t, d = q.shape
    qg = q.to(torch.float32).reshape(b, h // group, group, t, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(torch.float32))
    s.mul_(d ** -0.5 if scale is None else scale)
    if causal:
        above = torch.ones((t, t), dtype=torch.bool, device=q.device).triu_(1)
        s.masked_fill_(above, NEG_INF)
    return s


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, group: int = 1,
                        scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_plain``'s output, and each query row's log-sum-exp of
    its scaled, masked scores, f32 (B, H, T): the forward the backward
    needs."""
    b, h, t, _ = q.shape
    s = _scores(q, k, causal, group, scale)
    m = s.amax(dim=-1, keepdim=True)
    s.sub_(m).exp_()
    total = s.sum(dim=-1, keepdim=True)
    s.div_(total)
    out = torch.einsum("bkgqt,bktd->bkgqd", s, v.to(torch.float32))
    lse = (m + total.log()).reshape(b, h, t)
    return out.reshape(b, h, t, v.shape[-1]).to(q.dtype), lse


def attention_bwd_plain(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, group: int = 1,
                        scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk and dv of ``attention_fwd_plain`` from its output ``out`` and
    ``lse``, in f32: P = exp(scale S - LSE), dV = Pᵀ dO, dP = dO Vᵀ,
    dS = P ∘ (dP - D) with D = rowsum(dO ∘ O), dQ = scale dS K and
    dK = scale dSᵀ Q, each KV head's summed over its group; each in its
    input's dtype."""
    b, h, t, d = q.shape
    sc = d ** -0.5 if scale is None else scale
    shape = (b, h // group, group, t, d)
    p = _scores(q, k, causal, group, scale)
    p.sub_(lse.reshape(*shape[:4], 1)).exp_()
    do = dout.to(torch.float32).reshape(shape)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, do)
    dp = torch.einsum("bkgqd,bktd->bkgqt", do, v.to(torch.float32))
    dsum = (do * out.to(torch.float32).reshape(shape)).sum(-1, keepdim=True)
    ds = p.mul_(dp.sub_(dsum))
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.to(torch.float32)) * sc
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds,
                      q.to(torch.float32).reshape(shape)) * sc
    return (dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group: int) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    _check_shapes(q, k, v, group)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  group: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"expected (B, H, T, d) q, (B, KV, T, d) k and "
                         f"(B, KV, T, d_v) v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    if group < 1 or h % group or k.shape != (b, h // group, t, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not give {h} query heads "
                         f"in groups of {group}")
    if not (q.dtype == k.dtype == v.dtype) or not (
            q.device == k.device == v.device):
        raise ValueError("q, k and v must share one dtype and one device")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, group: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """K8 as an operator: (B, H, T, d) q and k over (B, KV, T, d_v) v."""
    scaled = {} if scale is None else {"scale": scale}
    return attention_plain(q, k, v, causal=causal, group=group, **scaled)


def _check_cuda(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in (q, *tensors)):
        raise ValueError("q, k and v must be contiguous and 16-byte aligned")
    b, h, t, _ = q.shape
    if t < 1 or h > 65535 or b > 65535:
        raise ValueError(f"shape {tuple(q.shape)} outside the kernel's grid")


def _check_route(q: torch.Tensor, v: torch.Tensor) -> None:
    """Raise where no route takes q's dtype at these head sizes."""
    d, dv = q.shape[-1], v.shape[-1]
    if d == dv and q.dtype in DTYPES and d in HEAD_DIMS:
        return
    if (d, dv) == MLA_HEAD_DIMS and q.dtype == torch.bfloat16:
        return
    raise ValueError(f"the kernel takes f32 or bf16 with head_dim in "
                     f"{HEAD_DIMS}, or bf16 at (q·k, v) head_dim "
                     f"{MLA_HEAD_DIMS}, got {q.dtype} and ({d}, {dv})")


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, group, scale=None):
    b, h, t, d = q.shape
    dv = v.shape[-1]
    _check_route(q, v)
    _check_cuda(q, k, v)
    out = q.new_empty((b, h, t, dv))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            group, t, d, dv, DTYPES[q.dtype], int(causal),
            d ** -0.5 if scale is None else scale, stream),
            "flash_attention")
    _build.count_launch(LAUNCHES, "flash_attention")
    return out


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, group, scale=None):
    return q.new_empty((*q.shape[:3], v.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """The full products, 2·B·H·T²·d (QKᵀ) and 2·B·H·T²·d_v (PV), as
    PyTorch counts ``scaled_dot_product_attention``: a causal mask does
    not halve it."""
    b, h, t, d = q_shape
    return 2 * b * h * t * k_shape[2] * (d + v_shape[-1])


@torch.library.custom_op("repro_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool, group: int, scale: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's forward under autograd: (B, H, T, d) attention and each query
    row's f32 log-sum-exp, (B, H, T)."""
    return attention_fwd_plain(q, k, v, causal=causal, group=group,
                               scale=scale)


def _check_grad_route(q: torch.Tensor) -> None:
    if q.dtype != torch.bfloat16 or q.shape[-1] not in GRAD_HEAD_DIMS:
        raise ValueError(f"the backward takes bf16 with head_dim in "
                         f"{GRAD_HEAD_DIMS}, got {q.dtype} and "
                         f"{q.shape[-1]}")


@flash_attention_fwd_op.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, causal, group, scale):
    b, h, t, d = q.shape
    _check_grad_route(q)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_flash_attention_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, group, t, d, int(causal), scale, stream),
            "flash_attention_fwd")
    _build.count_launch(LAUNCHES, "flash_attention_fwd")
    return out, lse


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, group, scale):
    b, h, t, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_attention_fwd_flops(q_shape, k_shape, v_shape, *args,
                               **kwargs) -> int:
    """K8's: the full products, 4·B·H·T²·d."""
    b, h, t, d = q_shape
    return 4 * b * h * t * k_shape[2] * d


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=(), device_types="cpu")
def flash_attention_bwd_op(dout: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, causal: bool,
                           group: int, scale: float
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The gradients dq, dk and dv of ``flash_attention_fwd`` from its
    inputs, its output and LSE, and the output's gradient."""
    return attention_bwd_plain(dout, q, k, v, out, lse, causal=causal,
                               group=group, scale=scale)


@flash_attention_bwd_op.register_kernel("cuda")
def _flash_attention_bwd_cuda(dout, q, k, v, out, lse, causal, group, scale):
    b, h, t, d = q.shape
    _check_grad_route(q)
    if not (dout.dtype == out.dtype == q.dtype and lse.dtype == torch.float32
            and dout.shape == out.shape == q.shape
            and lse.shape == (b, h, t)):
        raise ValueError("dout and out must be q's shape and dtype, lse "
                         "(B, H, T) f32")
    _check_cuda(q, k, v, dout, out, lse)
    t_pad = -(-t // BWD_PAD) * BWD_PAD
    if b * h * t_pad >= 2 ** 31:      # the scratch's rows are C ints
        raise ValueError(f"shape {tuple(q.shape)}: {b * h * t_pad} query "
                         f"rows, the backward takes fewer than 2^31")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    scratch = torch.empty(2 * b * h * t_pad, dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, h, group, t, d,
            int(causal), scale, stream), "flash_attention_bwd")
    _build.count_launch(LAUNCHES, "flash_attention_bwd")
    return dq, dk, dv


@flash_attention_bwd_op.register_fake
def _flash_attention_bwd_fake(dout, q, k, v, out, lse, causal, group, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_attention_bwd_flops(dout_shape, q_shape, k_shape, *args,
                               **kwargs) -> int:
    """The backward's products, 8·B·H·T²·d (dV, dP, dQ and dK), as PyTorch
    counts the backward of ``scaled_dot_product_attention``; the scores'
    recompute is not counted."""
    b, h, t, d = q_shape
    return 8 * b * h * t * k_shape[2] * d


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, group, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.group, ctx.scale = causal, group, scale
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(dout.contiguous(), q, k, v, out, lse,
                                        ctx.causal, ctx.group, ctx.scale)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("repro_torch::flash_attention_fwd",
                                _fwd_backward,
                                setup_context=_fwd_setup_context)


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             group: int = 1,
                             scale: Optional[float] = None) -> torch.Tensor:
    """K8 where autograd differentiates through it: (B, H, T, d) attention
    of q over (B, H / group, T, d) k and v by ``flash_attention_fwd``,
    whose backward is ``flash_attention_bwd``.  The bf16 Hopper route's
    inputs only (bf16, head_dim 64 or 128) on the card; the plain
    versions on the CPU.  One head size for q, k and v: latent
    attention's pair has no backward."""
    _check_shapes(q, k, v, group)
    if v.shape[-1] != q.shape[-1]:
        raise ValueError(f"the backward takes one head_dim for q, k and v, "
                         f"got {q.shape[-1]} and {v.shape[-1]}")
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_attention_fwd_op(q, k, v, causal, group, sc)[0]


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, group: int = 1,
                           scale: Optional[float] = None) -> torch.Tensor:
    """K8: (B, H, T, d) attention of q over (B, H / group, T, d) k and v
    (``repro_torch::flash_attention``), the scores times ``scale``
    (default d ** -0.5)."""
    _check(q, k, v, group)
    return flash_attention_op(q, k, v, causal, group, scale)
