"""The port's flash attention (K8) against the reference's.

The same numpy inputs go through ``repro.kernels.flash_attention.ops``
(the Pallas kernel in interpret mode, as ``tests/test_kernels_flash.py``
runs it) and ``ref.attention_ref``, and through
``repro_torch.kernels.flash_attention.ops`` on the CPU, where the wrapper
runs the kernel's plain version.  The bounds are the reference test's:
rtol/atol 2e-4 in f32 (the online and the whole-row softmax sum in other
orders) and 3e-2 in bf16 (the output is rounded to bf16).  The CUDA kernel
is held against the same plain version on the card by
``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention import ref as ref_ref
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops, ref

CPU = "cpu"
F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(shape, seed, kv_shape=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or shape
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(kv_shape).astype(dtype),
            rng.standard_normal(kv_shape).astype(dtype))


def _ref(q, k, v, **kw):
    return np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw), np.float32)


@pytest.mark.parametrize("h,t,d", [(2, 64, 32), (4, 128, 64), (1, 256, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(h, t, d, causal):
    q, k, v = _qkv((h, t, d), seed=0)
    got = ops.flash_attention(q, k, v, causal=causal, bq=32, bkv=32,
                              torch_device=CPU).numpy()
    np.testing.assert_allclose(got, _ref(q, k, v, causal=causal, bq=32,
                                         bkv=32), **F32)
    want = np.asarray(ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(
        ref.attention_ref(*map(torch.as_tensor, (q, k, v)),
                          causal=causal).numpy(), want, **F32)


@pytest.mark.parametrize("bq,bkv", [(16, 64), (64, 16), (32, 32)])
def test_block_shape_invariance(bq, bkv):
    q, k, v = _qkv((2, 64, 32), seed=1)
    got = ops.flash_attention(q, k, v, bq=bq, bkv=bkv, torch_device=CPU)
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, bq=bq, bkv=bkv),
                               **F32)


def test_bf16_and_batched():
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv((2, 2, 64, 32), 2))
    want = jax.vmap(lambda a, b, c: ref_ref.attention_ref(a, b, c))(q, k, v)
    ref_out = ref_ops.flash_attention(q, k, v, bq=32, bkv=32)
    tq, tk, tv = (torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, bq=32, bkv=32, torch_device=CPU)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, 64, 32)
    for expect in (want, ref_out):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(expect, np.float32), **BF16)


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_group_equals_expanded_kv(group, causal):
    """Query head h reads KV head h // group: the same as K/V expanded
    with ``repeat_interleave`` and attended head by head."""
    q, k, v = _qkv((2, 8, 64, 32), seed=3, kv_shape=(2, 8 // group, 64, 32))
    got = ops.flash_attention(q, k, v, causal=causal, bq=32, bkv=32,
                              group=group, torch_device=CPU)
    tk, tv = (torch.as_tensor(x).repeat_interleave(group, dim=1)
              for x in (k, v))
    expanded = ops.flash_attention(q, tk, tv, causal=causal, bq=32, bkv=32,
                                   torch_device=CPU)
    torch.testing.assert_close(got, expanded, **F32)
    np.testing.assert_allclose(
        got.numpy(), _ref(q, tk.numpy(), tv.numpy(), causal=causal, bq=32,
                          bkv=32), **F32)


@pytest.mark.parametrize("t,bq,bkv", [(64, 48, 32), (64, 32, 48), (100, 128,
                                                                   128)])
def test_refuses_lengths_that_are_not_whole_blocks(t, bq, bkv):
    q, k, v = _qkv((2, t, 16), seed=4)
    with pytest.raises(AssertionError):
        ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                bq=bq, bkv=bkv)
    with pytest.raises(ValueError, match="whole number"):
        ops.flash_attention(q, k, v, bq=bq, bkv=bkv, torch_device=CPU)


def test_plain_version_refuses_grad_and_bad_groups():
    q, k, v = (torch.as_tensor(x) for x in _qkv((1, 4, 32, 16), seed=5,
                                                kv_shape=(1, 2, 32, 16)))
    with pytest.raises(RuntimeError, match="backward"):
        fk.flash_attention_launch(q.clone().requires_grad_(), k, v, group=2)
    with torch.no_grad():
        fk.flash_attention_launch(q.clone().requires_grad_(), k, v, group=2)
    with pytest.raises(ValueError, match="groups"):
        fk.flash_attention_launch(q, k, v, group=3)
    before = dict(fk.LAUNCHES)
    fk.flash_attention_launch(q, k, v, group=2)
    assert fk.LAUNCHES == before  # the CPU runs the plain version
