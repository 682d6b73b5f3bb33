"""Hopper chunked SSD: Mamba-2's state-space duality in three kernels.

``csrc/ssd.cu`` replaces no TPU kernel: the reference computes the SSD
outside any Pallas kernel (``repro/models/mamba2.py``, ``_ssd_chunked``,
in ``jnp.einsum``).  Its plain version is the port's
``models/mamba2._ssd_plain``, which stores the segment-sum decay of every
chunk and head as an f32 (B, chunks, H, L, L) tensor and walks the
chunks in a host loop; the kernels keep that decay in registers.  One
call, ``ssd_launch``, launches three kernels on the current stream:

  * ``ssd_chunk_state``: each chunk's inclusive cumsum of dt a (``cum``,
    (B, chunks, H, L) f32) and each head's chunk state
    sum_j exp(cum_last - cum_j) dt_j x_j B_j^T, (P, N) f32;
  * ``ssd_state_pass``: the recurrence across chunks, giving the state
    entering each chunk (as three bf16 planes, the form the next kernel
    multiplies it in) and the final state;
  * ``ssd_chunk_scan``: y_l = exp(cum_l) C_l h_in^T + sum_{m <= l}
    exp(cum_l - cum_m) (C_l . B_m) dt_m x_m, (B, T, H, P) f32.

The products run on the tensor cores (``mma.sync`` bf16 -> f32) with x,
B and C as they are and each f32 factor as three bf16 terms, so they keep
f32 precision; no TF32, no fast-math exponential.  ``kernel_route`` says
where ``models/mamba2._ssd_chunked`` takes them: CUDA tensors, no input
requiring grad while grad is enabled, x/B/C bf16 and dt/a f32, P 64, N 64
or 128, a chunk of 64, 128 or 256.  Everywhere else the plain version
runs, unchanged; nothing falls back from the kernels to it.  A ragged
last chunk is masked in the kernels, and x, B and C are read with their
strides (views of the causal conv's output), so neither is padded nor
copied.  ``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIM = 64
STATE_DIMS = (64, 128)
CHUNKS = (64, 128, 256)

# kernel launches since the last reset_launches(); one call launches each once
LAUNCHES = {"ssd_chunk_state": 0, "ssd_state_pass": 0, "ssd_chunk_scan": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "repro_ssd": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _L, _L, _P, _L, _L,
                  _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.bind("ssd", _ARGTYPES)


def kernel_route(device_type: str, grad: bool, dtypes, p: int, n: int,
                 chunk: int) -> bool:
    """Whether the SSD of inputs on ``device_type`` with ``dtypes`` (x,
    dt, a, B, C), head size ``p``, state size ``n`` and ``chunk`` runs
    the kernels; ``grad``: an input requires grad while grad is
    enabled."""
    x, dt, a, b_mat, c_mat = dtypes
    return (device_type == "cuda" and not grad
            and x == b_mat == c_mat == torch.bfloat16
            and dt == a == torch.float32
            and p == HEAD_DIM and n in STATE_DIMS and chunk in CHUNKS)


def takes(x, dt, a, b_mat, c_mat, chunk: int) -> bool:
    """``kernel_route`` for these tensors."""
    args = (x, dt, a, b_mat, c_mat)
    grad = torch.is_grad_enabled() and any(v.requires_grad for v in args)
    return kernel_route(x.device.type, grad, tuple(v.dtype for v in args),
                        x.shape[-1], b_mat.shape[-1], chunk)


def _rows(v: torch.Tensor) -> torch.Tensor:
    """``v`` as the kernels read it: its last dim contiguous, 16-byte
    aligned, every other stride a whole number of 8-element groups (a
    contiguous copy where not; the model's views need none)."""
    if (v.stride(-1) == 1 and v.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s, n in zip(v.stride()[:-1], v.shape)
                    if n > 1)):
        return v
    return v.contiguous()


def ssd_launch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b_mat: torch.Tensor, c_mat: torch.Tensor,
               chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD on the card: x (B, T, H, 64) bf16, dt (B, T, H)
    f32, a (H,) f32, B and C (B, T, N) bf16 -> y (B, T, H, 64) f32 and
    the final state (B, H, 64, N) f32, as ``models/mamba2._ssd_plain``
    returns them."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    if not kernel_route(x.device.type, False,
                        (x.dtype, dt.dtype, a.dtype, b_mat.dtype,
                         c_mat.dtype), p, n, chunk):
        raise ValueError(f"the SSD kernels take CUDA bf16 x/B/C and f32 "
                         f"dt/a, P {HEAD_DIM}, N in {STATE_DIMS}, chunk in "
                         f"{CHUNKS}; got {x.device} {x.dtype} P {p}, N {n}, "
                         f"chunk {chunk}")
    if (dt.shape != (bsz, t, h) or a.shape != (h,)
            or b_mat.shape != (bsz, t, n) or c_mat.shape != (bsz, t, n)
            or not all(v.device == x.device for v in (dt, a, b_mat, c_mat))):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(b_mat.shape)}, C "
                         f"{tuple(c_mat.shape)} on one device expected")
    nc = -(-t // chunk)
    if t < 1 or bsz * nc > 65535 or h > 65535:
        raise ValueError(f"shape {tuple(x.shape)} at chunk {chunk} outside "
                         f"the kernels' grid")
    x, b_mat, c_mat = _rows(x), _rows(b_mat), _rows(c_mat)
    a = a.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    cum = torch.empty((bsz, nc, h, chunk), **f32)
    states = torch.empty((bsz, nc, h, p, n), **f32)
    planes = torch.empty((bsz, nc, h, 3, p, n), dtype=torch.bfloat16,
                         device=x.device)
    y = torch.empty((bsz, t, h, p), **f32)
    final = torch.empty((bsz, h, p, n), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.raise_on_error(_lib().repro_ssd(
            x.data_ptr(), *x.stride()[:3], dt.data_ptr(), *dt.stride(),
            a.data_ptr(), b_mat.data_ptr(), *b_mat.stride()[:2],
            c_mat.data_ptr(), *c_mat.stride()[:2],
            cum.data_ptr(), states.data_ptr(), planes.data_ptr(), y.data_ptr(),
            final.data_ptr(), bsz, t, h, n, chunk, stream), "ssd")
    for name in LAUNCHES:
        _build.count_launch(LAUNCHES, name)
    return y, final
