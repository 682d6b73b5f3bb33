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

The launcher runs the kernel for CUDA tensors and the plain version for
CPU tensors; it never falls back from one to the other.  Neither has a
backward: an input that requires grad, with grad mode on, is refused, as
the reference's kernel has no gradient either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind("flash_attention", _ARGTYPES)


def shared_memory_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the bf16 route at
    ``head_dim`` (0 where that route uses static shared memory only);
    builds the library."""
    return _lib().repro_flash_attention_smem(head_dim)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, group: int = 1) -> torch.Tensor:
    """(B, H, T, d) q, (B, H / group, T, d) k/v -> (B, H, T, d).

    The whole (T, T) score matrix in f32, a ``NEG_INF`` mask, and the
    result in q's dtype: ``ref.attention_ref`` with a batch axis and
    grouped KV heads, updating its scores in place to hold the memory to
    one f32 copy of them.
    """
    b, h, t, d = q.shape
    qg = q.to(torch.float32).reshape(b, h // group, group, t, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(torch.float32))
    s.mul_(d ** -0.5)
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


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           group: int = 1) -> torch.Tensor:
    """K8: (B, H, T, d) attention of q over (B, H / group, T, d) k and v."""
    _check(q, k, v, group)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
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
            group, t, d, DTYPES[q.dtype], int(causal), d ** -0.5, stream),
            "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
