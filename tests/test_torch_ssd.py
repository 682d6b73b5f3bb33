"""Mamba-2's chunked SSD: which route ``models/mamba2._ssd_chunked`` takes,
and the Hopper kernels (``kernels/ssd``) against the plain version.

The route is a pure function of the inputs' device, whether autograd
would differentiate through them, their dtypes, the head size P, the
state size N and the chunk (``ssd.kernel_route``); the CPU cases hold it
and the chunk counter, which counts batch x chunks on either route.

The ``cuda`` cases run the kernels and ``mamba2._ssd_plain`` (the f32
PyTorch SSD the CPU tests hold to the reference) on the same inputs on
the card and hold y and the final state within 1e-5 x max |plain|, the
tolerance the SSD's module tests use (``tests/test_torch_granite_hybrid.py``
``MODULE``): both compute in f32, the kernels' products as three bf16
terms a factor (about 2^-24 relative), in another order.  x, B and C are
views of one conv-output-like tensor, as the model passes them
(``chip_smoke.ssd_case``, which ``chip_smoke.py``'s checks draw from
too).  This file imports neither ``jax`` nor the reference package:

    python -m pytest -q -m cuda tests/test_torch_ssd.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import ssd_case  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
MODULE = 1e-5
TAKEN = (BF16, F32, F32, BF16, BF16)        # x, dt, a, B, C


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD kernels have no CPU mode")
    return torch.device("cuda")


# -- the route, on the CPU -----------------------------------------------------


@pytest.mark.parametrize("p,n,chunk", [(64, 64, 64), (64, 128, 256),
                                       (64, 128, 128), (64, 64, 256)])
def test_route_takes_the_kernels_for_bf16_on_the_card(p, n, chunk):
    assert ssd.kernel_route("cuda", False, TAKEN, p, n, chunk)


@pytest.mark.parametrize("device,grad,dtypes,p,n,chunk", [
    ("cpu", False, TAKEN, 64, 128, 256),          # the CPU
    ("meta", False, TAKEN, 64, 128, 256),         # a capture's tensors
    ("cuda", True, TAKEN, 64, 128, 256),          # under autograd
    ("cuda", False, (F32, F32, F32, F32, F32), 64, 128, 256),  # f32 checks
    ("cuda", False, (BF16, BF16, F32, BF16, BF16), 64, 128, 256),
    ("cuda", False, (BF16, F32, BF16, BF16, BF16), 64, 128, 256),
    ("cuda", False, (BF16, F32, F32, F32, BF16), 64, 128, 256),
    ("cuda", False, (torch.float16, F32, F32, torch.float16,
                     torch.float16), 64, 128, 256),
    ("cuda", False, TAKEN, 32, 128, 256),         # P
    ("cuda", False, TAKEN, 128, 128, 256),
    ("cuda", False, TAKEN, 64, 16, 256),          # N
    ("cuda", False, TAKEN, 64, 256, 256),
    ("cuda", False, TAKEN, 64, 128, 16),          # the chunk
    ("cuda", False, TAKEN, 64, 128, 512),
])
def test_route_keeps_the_plain_version_elsewhere(device, grad, dtypes, p, n,
                                                 chunk):
    assert not ssd.kernel_route(device, grad, dtypes, p, n, chunk)


def _inputs(bsz, t, h, n, dtype=BF16, p=64, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    xbc = torch.randn((bsz, t, h * p + 2 * n), generator=gen).to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    b_mat, c_mat = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.rand((bsz, t, h), generator=gen) * 0.1 + 1e-3
    a = -torch.linspace(1.0, 16.0, h)
    return tuple(v.to(device) for v in (x, dt, a, b_mat, c_mat))


def test_takes_reads_device_grad_and_dtypes_from_the_tensors():
    args = _inputs(1, 40, 2, 64)
    assert not ssd.takes(*args, 64)                  # CPU tensors
    meta = tuple(v.to("meta") for v in args)
    assert not ssd.takes(*meta, 64)


def test_the_cpu_route_is_the_plain_version_bit_for_bit():
    args = _inputs(2, 3 * 16 + 5, 3, 8, dtype=F32, p=8)
    y, h = mamba2._ssd_chunked(*args, 16)
    want_y, want_h = mamba2._ssd_plain(*args, 16)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_the_launcher_refuses_what_the_kernels_cannot_take():
    args = _inputs(1, 40, 2, 64)
    before = dict(ssd.LAUNCHES)
    with pytest.raises(ValueError, match="SSD kernels take"):
        ssd.ssd_launch(*args, 64)                    # CPU tensors
    assert ssd.LAUNCHES == before


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("bsz,t,chunk", [(2, 3 * 16 + 1, 16), (1, 64, 16),
                                         (3, 5, 64)])
def test_chunk_counter_counts_batch_times_chunks_on_both_routes(
        monkeypatch, route, bsz, t, chunk):
    """The kernels' route is stood in for by the plain version here (no
    card): the counter is a host integer, counted before the route."""
    called = []
    if route == "kernels":
        monkeypatch.setattr(ssd, "takes", lambda *args: True)
        monkeypatch.setattr(ssd, "ssd_launch", lambda *args: called.append(
            args) or mamba2._ssd_plain(*args))
    args = _inputs(bsz, t, 2, 8, dtype=F32, p=8)
    before = mamba2.CHUNKS.value()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            mamba2._ssd_chunked(*args, chunk)
    assert mamba2.CHUNKS.value() - before == bsz * -(-t // chunk)
    assert len(called) == (route == "kernels")


# -- the kernels, on the card --------------------------------------------------


def _hold(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all(), what
    assert err <= MODULE * scale, f"{what}: max |err| {err} > 1e-5 x {scale}"


CASES = [
    # Granite 4.0-H Small's layer (chunk 256, N 128) at 32k as one sequence
    # and as four; Zamba2's (chunk 64, N 64); ragged T at each chunk
    (1, 32768, 8, 128, 256, 0.05, None),
    (4, 8192, 8, 128, 256, 0.05, None),
    (2, 2048, 16, 64, 64, 0.05, None),
    (3, 3 * 256 + 17, 12, 128, 256, 0.05, None),
    (2, 3 * 128 + 5, 8, 64, 128, 0.05, None),
    (1, 64 + 1, 5, 64, 64, 0.05, None),
    (2, 700, 8, 128, 256, 1.3, -np.e),     # the product form overflows here
    (2, 700, 8, 128, 256, 0.001, -1.0),    # almost no decay over a chunk
]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,t,h,n,chunk,dt_value,a_value", CASES)
def test_kernels_match_the_plain_version(cuda, bsz, t, h, n, chunk, dt_value,
                                         a_value):
    args = ssd_case(cuda, bsz, t, h, n, dt_value, a_value)
    before = dict(ssd.LAUNCHES)
    with torch.no_grad():
        y, final = mamba2._ssd_chunked(*args, chunk)
    torch.cuda.synchronize()
    assert all(ssd.LAUNCHES[k] == before[k] + 1 for k in before)
    assert y.shape == (bsz, t, h, 64) and y.dtype == F32
    assert final.shape == (bsz, h, 64, n) and final.dtype == F32
    want_y, want_h = mamba2._ssd_plain(*args, chunk)
    _hold(y, want_y, "y")
    _hold(final, want_h, "final state")


@pytest.mark.cuda
def test_kernels_are_bit_equal_run_to_run(cuda):
    args = ssd_case(cuda, 2, 3 * 256 + 17, 12, 128, 0.05, None)
    first = ssd.ssd_launch(*args, 256)
    second = ssd.ssd_launch(*args, 256)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
def test_contiguous_inputs_equal_the_views(cuda):
    args = ssd_case(cuda, 2, 500, 8, 128, 0.05, None)
    strided = ssd.ssd_launch(*args, 256)
    whole = ssd.ssd_launch(*(v.contiguous() for v in args), 256)
    assert all(torch.equal(u, v) for u, v in zip(strided, whole))


@pytest.mark.cuda
def test_no_launch_under_grad_or_for_f32_inputs(cuda):
    x, dt, a, b_mat, c_mat = ssd_case(cuda, 1, 300, 4, 64, 0.05, None, seed=3)
    before = dict(ssd.LAUNCHES)
    leaf = x.detach().clone().requires_grad_()
    y, _ = mamba2._ssd_chunked(leaf, dt, a, b_mat, c_mat, 64)
    y.sum().backward()
    assert leaf.grad is not None
    mamba2._ssd_chunked(x.float(), dt, a, b_mat.float(), c_mat.float(), 64)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == before
    with torch.no_grad():
        mamba2._ssd_chunked(leaf, dt, a, b_mat, c_mat, 64)
    assert all(ssd.LAUNCHES[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
def test_launcher_refuses_what_the_kernels_cannot_take_on_the_card(cuda):
    x, dt, a, b_mat, c_mat = ssd_case(cuda, 1, 100, 2, 64, 0.05, None)
    with pytest.raises(ValueError):
        ssd.ssd_launch(x, dt, a, b_mat, c_mat, 32)           # the chunk
    with pytest.raises(ValueError):
        ssd.ssd_launch(x.float(), dt, a, b_mat, c_mat, 64)   # a dtype
    with pytest.raises(ValueError):
        ssd.ssd_launch(x, dt[:, :50], a, b_mat, c_mat, 64)   # a shape
