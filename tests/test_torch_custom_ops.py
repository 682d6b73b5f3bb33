"""K5, K7 and K8 as ``torch.library`` operators.

``repro_torch::scatter_add``, ``repro_torch::bincount`` and
``repro_torch::flash_attention``: the CPU implementation is the plain
version (the reference's own results, ``tests/test_torch_scatter.py``
and ``tests/test_torch_flash.py``), the CUDA one the launcher (its route
and its ``LAUNCHES`` count inside; ``tests/test_torch_kernels_cuda.py``
on the card), and the fake implementation gives the result's shape and
dtype on the meta device and under ``FakeTensorMode``, so that a
captured step holds each as one node.  ``torch.library.opcheck`` checks
the schema, the fake implementation against the CPU one, the autograd
registration and the AOT dispatch.  K8's FLOP formula counts the full
products, 4·B·H·T²·d, as PyTorch counts ``scaled_dot_product_attention``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck
from torch.utils.flop_counter import FlopCounterMode, sdpa_flop_count

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.scatter_add import kernel as sk


def _ids(n, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2, s + 2, (n,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("n,d,s", [(64, 8, 5), (257, 3, 70), (16, 128, 4)])
def test_scatter_add_opcheck(n, d, s):
    vals = torch.randn(n, d, generator=torch.Generator().manual_seed(n))
    opcheck(sk.scatter_add_op, (vals, _ids(n, s), s))


@pytest.mark.parametrize("n,s", [(64, 8), (10000, 8192), (3, 1)])
def test_bincount_opcheck(n, s):
    opcheck(sk.bincount_op, (_ids(n, s), s))


@pytest.mark.parametrize("group,causal,dtype", [
    (1, True, torch.float32), (2, False, torch.float32),
    (4, True, torch.bfloat16)])
def test_flash_attention_opcheck(group, causal, dtype):
    g = torch.Generator().manual_seed(group)
    q = torch.randn(2, 4, 24, 16, generator=g).to(dtype)
    k = torch.randn(2, 4 // group, 24, 16, generator=g).to(dtype)
    v = torch.randn(2, 4 // group, 24, 16, generator=g).to(dtype)
    opcheck(fk.flash_attention_op, (q, k, v, causal, group))


def test_launchers_take_the_meta_device_and_fake_tensors():
    """The meta device and ``FakeTensorMode`` run the fake
    implementations: the result's shape and dtype, no launch, no
    count."""
    sk.reset_launches()
    fk.reset_launches()
    vals = torch.empty(40, 6, device="meta")
    ids = torch.empty(40, dtype=torch.int32, device="meta")
    out = sk.scatter_add_launch(vals, ids, 9)
    assert out.is_meta and out.shape == (9, 6) and out.dtype == torch.float32
    cnt = sk.bincount_launch(ids, 9)
    assert cnt.is_meta and cnt.shape == (9,) and cnt.dtype == torch.int32
    q = torch.empty(2, 4, 16, 32, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 2, 16, 32, dtype=torch.bfloat16, device="meta")
    att = fk.flash_attention_launch(q, kv, kv, group=2)
    assert att.is_meta and att.shape == q.shape and att.dtype == q.dtype
    with FakeTensorMode():
        fv = torch.empty(40, 6)
        fi = torch.empty(40, dtype=torch.int32)
        assert sk.scatter_add_launch(fv, fi, 3).shape == (3, 6)
        assert sk.bincount_launch(fi, 3).shape == (3,)
    assert all(v == 0 for v in sk.LAUNCHES.values())
    assert fk.LAUNCHES["flash_attention"] == 0


def test_cpu_implementations_are_the_plain_versions():
    """On the CPU each operator returns its plain version's result bit
    for bit and counts no launch; K7 still refuses more than 8192 bins
    and K8 still refuses inputs that require grad, before the
    operator."""
    sk.reset_launches()
    vals = torch.randn(300, 4, generator=torch.Generator().manual_seed(3))
    ids = _ids(300, 17)
    assert torch.equal(sk.scatter_add_launch(vals, ids, 17),
                       sk.scatter_add_plain(vals, ids, 17))
    assert torch.equal(sk.bincount_launch(ids, 17),
                       sk.bincount_plain(ids, 17))
    assert all(v == 0 for v in sk.LAUNCHES.values())
    with pytest.raises(ValueError, match="8192"):
        sk.bincount_launch(ids, 8193)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fk.flash_attention_launch(q, q, q)


def test_scatter_add_autograd_through_the_operator():
    """K5 under autograd: the gather backward's gradient, bit for bit
    autograd's own through ``index_add`` of the plain version, 0 on
    dropped rows."""
    vals = torch.randn(200, 5, generator=torch.Generator().manual_seed(4))
    ids = _ids(200, 11)
    w = torch.randn(11, 5, generator=torch.Generator().manual_seed(5))
    got = vals.clone().requires_grad_()
    (sk.scatter_add_autograd(got, ids, 11) * w).sum().backward()
    want = vals.clone().requires_grad_()
    (sk.scatter_add_plain(want, ids, 11) * w).sum().backward()
    assert torch.equal(got.grad, want.grad)
    assert float(got.grad[(ids < 0) | (ids >= 11)].abs().sum()) == 0.0


@pytest.mark.parametrize("b,h,t,d,group", [(2, 4, 24, 16, 1),
                                           (1, 8, 100, 32, 4),
                                           (3, 2, 7, 64, 2)])
def test_flash_attention_flop_formula(b, h, t, d, group):
    """``FlopCounterMode`` counts K8 as 4·B·H·T²·d, causal or not, as
    PyTorch's own formula counts ``scaled_dot_product_attention`` on the
    same shapes with the KV heads expanded."""
    g = torch.Generator().manual_seed(t)
    q = torch.randn(b, h, t, d, generator=g)
    kv = torch.randn(b, h // group, t, d, generator=g)
    for causal in (True, False):
        with FlopCounterMode(display=False) as fc:
            fk.flash_attention_launch(q, kv, kv, causal=causal, group=group)
        assert fc.get_total_flops() == 4 * b * h * t * t * d
    shape = (b, h, t, d)
    assert sdpa_flop_count(shape, shape, shape) == 4 * b * h * t * t * d


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels build and run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_operators_on_the_card(cuda):
    """On the card each operator launches its kernel once a call (one
    count in ``LAUNCHES``), equals its plain version (K7 bit for bit, K5
    within 1e-5, K8 within the bf16 bound of the kernel tests), and
    passes ``opcheck`` against its fake implementation."""
    g = torch.Generator(device=cuda).manual_seed(7)
    ids = torch.randint(-2, 130, (4096,), generator=g, device=cuda,
                        dtype=torch.int32)
    vals = torch.randn((4096, 64), generator=g, device=cuda)
    q = torch.randn((2, 8, 256, 64), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    kv = torch.randn((2, 2, 256, 64), generator=g, device=cuda,
                     dtype=torch.bfloat16)
    sk.reset_launches()
    fk.reset_launches()
    assert torch.equal(sk.bincount_launch(ids, 128),
                       sk.bincount_plain(ids, 128))
    torch.testing.assert_close(sk.scatter_add_launch(vals, ids, 128),
                               sk.scatter_add_plain(vals, ids, 128),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        fk.flash_attention_launch(q, kv, kv, group=4).float(),
        fk.attention_plain(q, kv, kv, group=4).float(), rtol=2e-2,
        atol=2e-2)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["bincount"] == sk.LAUNCHES["scatter_add"] == 1
    assert fk.LAUNCHES["flash_attention"] == 1
    opcheck(sk.bincount_op, (ids, 128))
    opcheck(sk.scatter_add_op, (vals, ids, 128))
    opcheck(fk.flash_attention_op, (q, kv, kv, True, 4))
