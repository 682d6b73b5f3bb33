"""Mamba-2 block (SSD, arXiv:2405.21060), zamba2's and Granite 4.0-H's
mixer.

Selective state-space with scalar-per-head decay, evaluated with the
chunked state-space-duality algorithm: the intra-chunk quadratic (matmul)
term and the inter-chunk state recurrence, in f32.  On the card, for
bf16 inputs without a gradient, it runs as hand-written Hopper kernels
(``kernels/ssd``, no TPU counterpart: the reference computes SSD outside
any Pallas kernel); everywhere else as the reference's
``models/mamba2.py`` computes it, with ``torch.einsum`` and a Python loop
over chunks (``_ssd_plain``).  The intra-chunk decay is the SSD
paper's segment sum, ``exp(cum_i - cum_j)`` over ``j <= i``, whose
exponent is never positive: the reference's ``exp(cum_i) * exp(-cum_j)``
overflows f32 once a chunk's summed log decay passes about 88 (chunk 256
at dt 0.05 and A -8 does).  Decode carries the (H, P, N) state and a
small causal-conv ring, O(1) in sequence length.

The block is the ``telemetry`` span ``ssm`` (in_proj, conv, SSD, gated
norm, out_proj) with the SSD inside it as ``ssm.scan`` (the plain
version's chunk loop inside that as ``CHUNK_LOOP``); while the profiler
records, ``repro_ssm_chunks_total`` (``CHUNKS``) counts the chunks the
SSD processes, batch x chunks a call, as a host integer, on either
route.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.models import layers
from repro_torch.obs import telemetry
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx as pctx

CHUNK_LOOP = "mamba2 SSD chunk loop"  # the profiler's name for it
# in a registry of its own: the process's (``telemetry.REGISTRY``) holds
# the reference's metric names, and the MoE's rows counter, alone
CHUNKS = telemetry.MetricsRegistry().counter(
    "repro_ssm_chunks_total", "Mamba-2 SSD chunks processed (batch x "
    "chunks a call), counted while profiling")


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6      # the gated norm's

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.state_dim


def init(gen: torch.Generator, cfg: Mamba2Config) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    dev = gen.device
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.state_dim + cfg.num_heads
    h = cfg.num_heads
    return {
        "in_proj": layers.dense_init(gen, cfg.d_model, d_in_proj, dt),
        "conv_w": layers.truncated_normal_init(
            gen, (cfg.conv_width, cfg.conv_dim), 0.3, dt),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dt, device=dev),
        # A = -exp(a_log)
        "a_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": layers.rmsnorm_init(cfg.d_inner, dt, dev),
        "out_proj": layers.dense_init(gen, cfg.d_inner, cfg.d_model, dt),
    }


def _split_proj(proj: torch.Tensor, cfg: Mamba2Config):
    """(z, x, B, C, dt) of the input projection, in that order."""
    return torch.split(proj, (cfg.d_inner, cfg.d_inner, cfg.state_dim,
                              cfg.state_dim, cfg.num_heads), dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted multiply-adds in x's dtype;
    x (B,T,C), w (W,C); rows before position 0 are zeros.  (The
    reference's ``init_state`` argument, which no caller passes, is not
    ported: decode sums its own window in f32.)"""
    width, t = w.shape[0], x.shape[1]
    ext = F.pad(x, (0, 0, width - 1, 0))                 # (B, W-1+T, C)
    out = x * w[-1]
    for i in range(1, width):
        out = out + ext[:, width - 1 - i:width - 1 - i + t] * w[-1 - i]
    return F.silu(out + b)


def _ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int):
    """SSD: x (B,T,H,P), dt (B,T,H) f32, a (H,) f32 (negative),
    b/c (B,T,N).  Returns y (B,T,H,P) f32 and the final state
    (B,H,P,N).  Where ``ssd.kernel_route`` admits the inputs (bf16 x/B/C
    on the card, no gradient, P 64, N 64 or 128, chunk 64, 128 or 256)
    the Hopper kernels compute it (``ssd.ssd_launch``); everywhere else
    ``_ssd_plain``.  Either way the chunks count batch x chunks."""
    if telemetry.tracing():
        CHUNKS.inc(x.shape[0] * -(-x.shape[1] // chunk))
    if ssd.takes(x, dt, a, b_mat, c_mat, chunk):
        return ssd.ssd_launch(x, dt, a, b_mat, c_mat, chunk)
    return _ssd_plain(x, dt, a, b_mat, c_mat, chunk)


def _ssd_plain(x, dt, a, b_mat, c_mat, chunk: int):
    """``_ssd_chunked`` in f32 PyTorch, the kernels' plain version.  The
    pairwise decay is the segment sum ``exp(cum_i - cum_j)`` for j <= i
    and 0 above the diagonal; where autograd will not differentiate
    through it, it is made in place, one (B, chunks, H, L, L) f32 tensor
    at a time."""
    bsz, t0, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-t0) % chunk
    if pad:  # zero x/dt rows contribute nothing; dt=0 means decay exp(0)=1
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, b_mat, c_mat = (F.pad(a_, (0, 0, 0, pad))
                            for a_ in (dt, b_mat, c_mat))
    t = t0 + pad
    nc = t // chunk
    grad = torch.is_grad_enabled() and any(
        v.requires_grad for v in (x, dt, a, b_mat, c_mat))
    da = (dt * a).reshape(bsz, nc, chunk, h)             # log decay per step
    xdt = (x.to(torch.float32) * dt[..., None]).reshape(
        bsz, nc, chunk, h, p)
    bs = b_mat.to(torch.float32).reshape(bsz, nc, chunk, n)
    cs = c_mat.to(torch.float32).reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(da, dim=2)                        # inclusive
    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (c_i.b_j) dtx_j
    scores = torch.einsum("bcln,bcmn->bclm", cs, bs)     # (b,c,l,m)
    cum_h = cum.permute(0, 1, 3, 2)                      # (b,c,h,l)
    seg = cum_h[..., :, None] - cum_h[..., None, :]      # (b,c,h,l,m)
    above = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).triu_(1)
    if grad:
        pair = torch.exp(seg.masked_fill(above, float("-inf"))) \
            * scores[:, :, None]
    else:
        pair = seg.masked_fill_(above, float("-inf")).exp_().mul_(
            scores[:, :, None])
    del seg
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", pair, xdt)
    del pair
    # chunk summary state: S_c = sum_j exp(cum_L - cum_j) dtx_j b_j^T
    w_total = cum[:, :, -1]                              # (b,c,h)
    k_tail = torch.exp(w_total[:, :, None] - cum)        # (b,c,l,h)
    s_chunk = torch.einsum("bclh,bclhp,bcln->bchpn", k_tail, xdt, bs)
    # inter-chunk recurrence; chunk c reads the state entering it (named
    # for the profiler)
    with telemetry.span(CHUNK_LOOP):
        hprev = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
        h_in = []
        for i in range(nc):
            h_in.append(hprev)
            hprev = (torch.exp(w_total[:, i])[..., None, None] * hprev
                     + s_chunk[:, i])
        h_in = torch.stack(h_in, dim=1)                  # (b,c,h,p,n)
    y_inter = torch.einsum("bclh,bcln,bchpn->bclhp", torch.exp(cum), cs,
                           h_in)
    y = (y_intra + y_inter).reshape(bsz, t, h, p)
    return y[:, :t0], hprev


@telemetry.span("ssm")
def apply(p: dict, x: torch.Tensor, cfg: Mamba2Config) -> torch.Tensor:
    bsz, t, _ = x.shape
    proj = layers.dense(p["in_proj"], x)
    z, xin, b_mat, c_mat, dt_raw = _split_proj(proj, cfg)
    z, xin = pctx.shard_batch_tp(z), pctx.shard_batch_tp(xin)
    xbc = torch.cat([xin, b_mat, c_mat], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin, b_mat, c_mat = torch.split(
        xbc, (cfg.d_inner, cfg.state_dim, cfg.state_dim), dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = pctx.unflatten(xin, -1, (cfg.num_heads, cfg.head_dim))
    # under a mesh, on each rank's (batch, heads) shard
    with telemetry.span("ssm.scan"):
        y = coll.per_head(lambda *xs: _ssd_chunked(*xs, cfg.chunk)[0],
                          (xh, dt, a, b_mat, c_mat),
                          [("act", 2), ("act", 2), ("param", 0),
                           ("act", None), ("act", None)], 2)
    y = y + xh.to(torch.float32) * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, t, cfg.d_inner).to(x.dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return layers.dense(p["out_proj"], y)


def decode_step(p: dict, x: torch.Tensor, state: dict, cfg: Mamba2Config):
    """x (B,1,d); state {"h": (B,H,P,N) f32, "conv": (B,W-1,conv_dim)}.
    The conv window is summed in f32 here (in x's dtype in ``apply``)."""
    bsz = x.shape[0]
    proj = layers.dense(p["in_proj"], x)[:, 0]
    z, xin, b_mat, c_mat, dt_raw = _split_proj(proj, cfg)
    xbc = torch.cat([xin, b_mat, c_mat], dim=-1)         # (B, conv_dim)
    window = torch.cat([state["conv"], xbc[:, None]], dim=1)
    conv_out = F.silu(
        torch.einsum("bwc,wc->bc", window.to(torch.float32),
                     p["conv_w"].to(torch.float32)) + p["conv_b"])
    conv_out = conv_out.to(x.dtype)
    xin, b_mat, c_mat = torch.split(
        conv_out, (cfg.d_inner, cfg.state_dim, cfg.state_dim), dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (B,H)
    a = -torch.exp(p["a_log"])
    xh = xin.reshape(bsz, cfg.num_heads, cfg.head_dim).to(torch.float32)
    decay = torch.exp(dt * a)                            # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None],
                       b_mat.to(torch.float32))
    h_new = decay[..., None, None] * state["h"] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c_mat.to(torch.float32))
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, cfg.d_inner).to(x.dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z[:, None]), cfg.norm_eps)
    out = layers.dense(p["out_proj"], y)
    return out, {"h": h_new, "conv": window[:, 1:]}


def init_state(cfg: Mamba2Config, batch: int, device="cuda") -> dict:
    return {
        "h": torch.zeros((batch, cfg.num_heads, cfg.head_dim, cfg.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                            dtype=torch.bfloat16, device=device),
    }
