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
tile.

K8 is the ``torch.library`` operator ``repro_torch::flash_attention``:
its CUDA implementation launches the kernel, its CPU one runs the plain
version, and its fake implementation gives the result's shape on the
meta device or under ``FakeTensorMode``; its FLOP formula (for
``FlopCounterMode``) counts the full products, 4·B·H·T²·d.  The launcher
runs the kernel for CUDA tensors and the plain version for CPU tensors;
it never falls back from one to the other.  Neither has a
backward: an input that requires grad, with grad mode on, is refused, as
the reference's kernel has no gradient either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -2.0e38

# kernel launches since the last reset_launches()
LAUNCHES = {"flash_attention": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P],
    "repro_flash_attention_smem": [_I],
}


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind("flash_attention", _ARGTYPES)


def shared_memory_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the bf16 route at
    ``head_dim`` (0 where that route uses static shared memory only);
    builds the library."""
    return _lib().repro_flash_attention_smem(head_dim)


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
    """(B, H, T, d) q, (B, H / group, T, d) k/v -> (B, H, T, d).

    The whole (T, T) score matrix in f32, times ``scale`` (default
    d ** -0.5), a ``NEG_INF`` mask, and the result in q's dtype:
    ``ref.attention_ref`` with a batch axis and grouped KV heads,
    updating its scores in place to hold the memory to one f32 copy of
    them.
    """
    b, h, t, d = q.shape
    qg = q.to(torch.float32).reshape(b, h // group, group, t, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(torch.float32))
    s.mul_(d ** -0.5 if scale is None else scale)
    if causal:
        above = torch.ones((t, t), dtype=torch.bool, device=q.device).triu_(1)
        s.masked_fill_(above, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.div_(s.sum(dim=-1, keepdim=True))
    out = torch.einsum("bkgqt,bktd->bkgqd", s, v.to(torch.float32))
    return out.reshape(b, h, t, d).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group: int) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention has no backward: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected (B, H, T, d) q and (B, KV, T, d) k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
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
    """K8 as an operator: (B, H, T, d) attention."""
    scaled = {} if scale is None else {"scale": scale}
    return attention_plain(q, k, v, causal=causal, group=group, **scaled)


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, group, scale=None):
    b, h, t, d = q.shape
    if q.dtype not in DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes f32 or bf16 with head_dim in "
                         f"{HEAD_DIMS}, got {q.dtype} and {d}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in (q, k, v)):
        raise ValueError("q, k and v must be contiguous and 16-byte aligned")
    if t < 1 or h > 65535 or b > 65535:
        raise ValueError(f"shape {tuple(q.shape)} outside the kernel's grid")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            group, t, d, DTYPES[q.dtype], int(causal),
            d ** -0.5 if scale is None else scale, stream),
            "flash_attention")
    _build.count_launch(LAUNCHES, "flash_attention")
    return out


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, group, scale=None):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """The full products, 4·B·H·T²·d (QKᵀ and PV), as PyTorch counts
    ``scaled_dot_product_attention``: a causal mask does not halve it."""
    b, h, t, d = q_shape
    return 4 * b * h * t * k_shape[2] * d


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, group: int = 1,
                           scale: Optional[float] = None) -> torch.Tensor:
    """K8: (B, H, T, d) attention of q over (B, H / group, T, d) k and v
    (``repro_torch::flash_attention``), the scores times ``scale``
    (default d ** -0.5)."""
    _check(q, k, v, group)
    # where there is no ``scale``, the call as it was before it
    scaled = () if scale is None else (scale,)
    return flash_attention_op(q, k, v, causal, group, *scaled)
