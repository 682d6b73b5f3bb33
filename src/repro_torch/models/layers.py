"""Shared model building blocks: norms, embeddings, RoPE, losses.

Pure functions over parameter dicts, as in the reference.  The init
functions draw from an explicit ``torch.Generator`` and create their
tensors on its device; the reference's ``jax.random`` keys give other
numbers, so tests carry the reference's parameters across instead
(``convert.lm_params_from_numpy``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import P

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config's dtype name (or a torch dtype)."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


class MetaGenerator:
    """Stands in for a generator where ``init`` should only lay out the
    parameters: every tensor is made on the meta device, with its shape
    and dtype and no memory, and nothing is drawn (the counterpart of
    ``jax.eval_shape(model.init, key)``)."""
    device = torch.device("meta")


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM init schemes)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.is_meta:
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, bias: bool = False) -> dict:
    p = {"w": truncated_normal_init(gen, (d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.bfloat16, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in f32, cast back to x's dtype, *then* scaled."""
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def layernorm_init(d: int, dtype=torch.bfloat16, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.to(torch.float32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, unbiased=False)
    h = (h - mu) * torch.rsqrt(var + eps)
    return h.to(x.dtype) * p["scale"] + p["bias"]


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16) -> dict:
    # d**-0.5 keeps tied-unembedding logits O(1) at init.
    return {"table": truncated_normal_init(gen, (vocab, d), d ** -0.5, dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(p["table"], DTensor):
        return _embed_vocab_parallel(p["table"], tokens)
    return F.embedding(tokens, p["table"])


def _embed_vocab_parallel(table, tokens) -> torch.Tensor:
    """The lookup under a mesh, each rank on its shard: the table's rows
    over the model axis (its columns gathered), the tokens over the data
    axes where the batch divides.  A rank looks up the tokens in its rows
    and zeros the rest; the sum over the model axis is every token's row
    (DTensor's own rule for a vocab-sharded lookup does not hold when the
    tokens are sharded on another mesh axis)."""
    ctx = pctx.current()
    mesh = table.device_mesh
    lead = pctx.batch_axes_for(ctx, tokens.shape[0])
    tok = coll.to_local(tokens, mesh, P(lead, None))
    rows = coll.to_local(table, mesh, P(ctx.tp_axis, None),
                         ctx.data_axes if lead else ())
    lo = mesh.get_local_rank(ctx.tp_axis) * rows.shape[0]
    ids = tok.to(torch.int64) - lo
    hit = (ids >= 0) & (ids < rows.shape[0])
    out = F.embedding(ids.clamp(0, rows.shape[0] - 1), rows) \
        * hit[..., None].to(rows.dtype)
    out = coll.sum_over(out, mesh.get_group(ctx.tp_axis))
    return coll.from_local(out, mesh, P(lead, None, None))


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: (..., d) @ (V, d)^T -> (..., V)."""
    return x @ p["table"].T


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# -- rotary position embeddings --------------------------------------------


def _rope_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    freq = theta ** (-np.arange(0, half) * 2.0 / head_dim)
    return torch.as_tensor(freq, dtype=torch.float32, device=device)


_cached_rope_freq = functools.lru_cache(maxsize=None)(_rope_freq)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions; (..., head_dim/2), f32.

    The frequencies are computed in float64 by numpy and used in f32, as
    the reference does with 64-bit mode off: a float64 tensor here would
    promote the whole rotation to float64.  On the card they are copied
    there once per head size, theta and device: a copy from pageable host
    memory on every call would wait for the card's queue to drain.
    """
    if positions.is_cuda and not is_fake(positions):
        freq = _cached_rope_freq(head_dim, float(theta), positions.device)
    else:
        freq = _rope_freq(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., T, head_dim); cos/sin: (T, head_dim/2) broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# -- YaRN (DeepSeek-V3's rotary scaling) -------------------------------------


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 · mscale · ln(factor) + 1 (1 where
    the factor is 1 or less)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * np.log(factor) + 1.0


def _yarn_freq(dim: int, theta: float, factor: float, original: int,
               beta_fast: float, beta_slow: float, device) -> torch.Tensor:
    """DeepSeek's ``precompute_freqs_cis``: theta^(-2i/dim), divided by
    ``factor`` below the frequencies that turn ``beta_slow`` times over
    ``original`` positions, kept above those that turn ``beta_fast``
    times, and a linear ramp between (``yarn_find_correction_range``).
    In float64 by numpy, used in f32, as ``_rope_freq``."""
    freq = theta ** (-np.arange(0, dim, 2) / dim)

    def corr_dim(rotations):
        return (dim * np.log(original / (rotations * 2 * np.pi))
                / (2 * np.log(theta)))
    low = max(int(np.floor(corr_dim(beta_fast))), 0)
    high = min(int(np.ceil(corr_dim(beta_slow))), dim - 1)
    ramp = np.clip((np.arange(dim // 2) - low) / max(high - low, 0.001),
                   0.0, 1.0)
    freq = freq / factor * ramp + freq * (1.0 - ramp)
    return torch.as_tensor(freq, dtype=torch.float32, device=device)


_cached_yarn_freq = functools.lru_cache(maxsize=None)(_yarn_freq)


def yarn_angles(positions: torch.Tensor, dim: int, theta: float,
                factor: float, original: int, beta_fast: float,
                beta_slow: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_angles`` at YaRN's frequencies (``_yarn_freq``): cos/sin
    (..., dim/2), f32; the frequencies copied to the card once."""
    args = (dim, float(theta), float(factor), int(original),
            float(beta_fast), float(beta_slow), positions.device)
    freq = (_cached_yarn_freq(*args) if positions.is_cuda
            and not is_fake(positions) else _yarn_freq(*args))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                     ) -> torch.Tensor:
    """Rotary embedding over adjacent pairs (x_{2i}, x_{2i+1}), as
    DeepSeek's ``apply_rotary_emb`` (a complex product), in f32, then in
    x's dtype.  x: (..., T, dim); cos/sin: (T, dim/2) broadcastable."""
    xf = x.to(torch.float32).unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1)
    return out.flatten(-2).to(x.dtype)


def sinusoidal_positions(num: int, d: int, device="cuda") -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, (num, d) f32."""
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    pos = np.arange(num)[:, None] * freq[None, :]
    return torch.as_tensor(np.concatenate([np.sin(pos), np.cos(pos)], axis=1),
                           dtype=torch.float32, device=device)


# -- losses ------------------------------------------------------------------


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's -log softmax(logits)[label], f32; logits (..., V)
    any dtype.  DTensor logits (under a mesh) are taken on each rank's
    shard: the vocab over the model axis where it divides."""
    if isinstance(logits, DTensor):
        return _nll_vocab_parallel(logits, labels)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def _nll_vocab_parallel(logits, labels) -> torch.Tensor:
    """``nll`` of (B, T, V) DTensor logits, Megatron's vocab-parallel
    cross-entropy: each rank takes the log-sum-exp and the label's logit
    over its slice of the vocab, and the model axis combines them (DTensor's
    own rule for a gather from a sharded dimension does not hold when the
    batch is sharded on another mesh axis).  Each rank's ``logsumexp``
    keeps no (B, T, V) temporary for its backward."""
    ctx = pctx.current()
    mesh = logits.device_mesh
    lead = pctx.batch_axes_for(ctx, logits.shape[0])
    tp = pctx.axis_size(mesh, ctx.tp_axis)
    split = logits.shape[-1] % tp == 0
    spec = P(lead, *(None,) * (logits.ndim - 2), ctx.tp_axis if split
             else None)
    local = coll.to_local(logits, mesh, spec).to(torch.float32)
    gold = coll.to_local(labels, mesh, P(lead)).to(torch.int64)
    lse = torch.logsumexp(local, dim=-1)
    lo = mesh.get_local_rank(ctx.tp_axis) * local.shape[-1] if split else 0
    ids = gold - lo
    hit = (ids >= 0) & (ids < local.shape[-1])
    g = torch.gather(local, -1, ids.clamp(0, local.shape[-1] - 1)[..., None]
                     )[..., 0] * hit.to(local.dtype)
    if split:   # log sum_r exp(lse_r), about the largest lse_r
        group = mesh.get_group(ctx.tp_axis)
        m = lse.detach().clone()
        torch.distributed.all_reduce(
            m, op=torch.distributed.ReduceOp.MAX, group=group)
        lse = m + torch.log(coll.sum_over(torch.exp(lse - m), group))
        g = coll.sum_over(g, group)
    out = lse - g
    return coll.from_local(out, mesh, P(lead, *(None,) * (out.ndim - 1)))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) any dtype, computed in f32."""
    loss = nll(logits, labels)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
