"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent decay linear RNN.

The time-mix (WKV6) and channel-mix sub-blocks with the DDLerp
token-shift interpolation and the low-rank data-dependent decay, as the
reference's ``models/rwkv6.py`` computes them.  Two WKV evaluation paths,
picked by ``ModelConfig.rwkv_impl``:

  * ``scan``    — the per-token recurrence,
  * ``chunked`` — chunk-parallel evaluation (intra-chunk matmul form and
    an inter-chunk state recurrence, a Python loop over the chunks), the
    default.

Both run in f32 with ``torch.einsum``; no kernel of its own (the
reference computes them outside any Pallas kernel too).  State per head:
S (N_k x N_v) with N = head_dim; decode carries (S, last token), O(1) in
sequence length.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.obs import telemetry
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx as pctx


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    d_ff: int = 0               # channel-mix hidden (3.5x d_model default)
    dtype: str = "bfloat16"

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or int(3.5 * self.d_model)


_MIX_NAMES = ("w", "k", "v", "r", "g")
CHUNK_LOOP = "rwkv6 WKV chunk loop"   # the profiler's name for it


def init(gen: torch.Generator, cfg: RWKVConfig) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    d, n, dev = cfg.d_model, cfg.head_dim, gen.device
    m = len(_MIX_NAMES)
    tn = layers.truncated_normal_init
    return {
        "mix_base": torch.zeros((m, d), dtype=dt, device=dev),      # mu_i
        "mix_x": torch.zeros((d,), dtype=dt, device=dev),           # mu_x
        "mix_a": tn(gen, (d, m * cfg.mix_lora), d ** -0.5, dt),
        "mix_b": tn(gen, (m, cfg.mix_lora, d), cfg.mix_lora ** -0.5, dt),
        "decay_base": torch.full((d,), -6.0, dtype=torch.float32,
                                 device=dev),                       # w0
        "decay_a": tn(gen, (d, cfg.decay_lora), d ** -0.5, dt),
        "decay_b": tn(gen, (cfg.decay_lora, d), cfg.decay_lora ** -0.5, dt),
        "bonus": torch.zeros((cfg.num_heads, n), dtype=torch.float32,
                             device=dev),                           # u
        "wr": layers.dense_init(gen, d, d, dt),
        "wk": layers.dense_init(gen, d, d, dt),
        "wv": layers.dense_init(gen, d, d, dt),
        "wg": layers.dense_init(gen, d, d, dt),
        "wo": layers.dense_init(gen, d, d, dt),
        "ln_x": layers.layernorm_init(d, dt, dev),  # over all of d
        # channel mix
        "cm_mix_k": torch.full((d,), 0.5, dtype=dt, device=dev),
        "cm_mix_r": torch.full((d,), 0.5, dtype=dt, device=dev),
        "cm_k": layers.dense_init(gen, d, cfg.ffn_dim, dt),
        "cm_v": layers.dense_init(gen, cfg.ffn_dim, d, dt),
        "cm_r": layers.dense_init(gen, d, d, dt),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None):
    """x (B,T,d) -> previous-token x; position 0 sees ``last`` (or
    zeros)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent interpolation for the 5 mix streams (RWKV6)."""
    xx = x_prev - x
    base = x + xx * p["mix_x"]
    lora = torch.tanh(base @ p["mix_a"])                    # (B,T,5*Lm)
    lora = pctx.unflatten(lora, -1, (len(_MIX_NAMES), -1))
    adj = torch.einsum("btml,mld->btmd", lora.to(x.dtype), p["mix_b"])
    return [x + xx * (p["mix_base"][i] + adj[..., i, :])
            for i in range(len(_MIX_NAMES))]  # xw, xk, xv, xr, xg


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel data-dependent log-decay (negative), f32 (B,T,d)."""
    lora = (torch.tanh(xw @ p["decay_a"]).to(torch.float32)
            @ p["decay_b"].to(torch.float32))
    return -torch.exp(p["decay_base"] + lora)  # log w_t <= 0


def _wkv_scan(r, k, v, logw, u):
    """The recurrence.  r, k, v, logw (B,T,H,N) f32; u (H,N)."""
    b, t, h, n = r.shape
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for i in range(t):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, i], v[:, i])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i],
                               s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, i])[..., None] * s + kv
    return torch.stack(ys, dim=1)                  # (B,T,H,N)


def _wkv_chunked(r, k, v, logw, u, chunk: int = 64):
    """Chunk-parallel WKV6: intra-chunk matmul + inter-chunk state
    recurrence.

    Within a chunk of length L the contribution of token j to output i>j
    is r_i . (prod_{j<u<i} w_u) (k_j x v_j); plus the u-bonus diagonal
    and the carried-in state decayed to position i.  The pairwise decay
    is factorised as ``r·exp(cum - w)`` times ``k·exp(-cum)``, as in the
    reference: it overflows f32 where the reference's does, once a
    channel's log-decay summed over a chunk passes about 88.7.
    """
    b, t0, h, n = r.shape
    pad = (-t0) % chunk
    if pad:  # zero r/k/v rows contribute nothing; logw=0 means decay 1
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    t = t0 + pad
    c = t // chunk
    rs = r.reshape(b, c, chunk, h, n).to(torch.float32)
    ks = k.reshape(b, c, chunk, h, n).to(torch.float32)
    vs = v.reshape(b, c, chunk, h, n).to(torch.float32)
    ws = logw.reshape(b, c, chunk, h, n)
    cum = torch.cumsum(ws, dim=2)                   # inclusive cumsum of logw
    # y_t reads the state *before* w_t is applied (scan semantics), so the
    # pairwise decay for (i, j), i > j is sum_{u=j+1}^{i-1} w_u
    # = cum_excl_i - cum_incl_j with cum_excl = cum - w.
    r_dec = rs * torch.exp(cum - ws)                # r_i * exp(cum_{i-1})
    k_dec = ks * torch.exp(-cum)                    # k_j * exp(-cum_j)
    scores = torch.einsum("bclhn,bcmhn->bchlm", r_dec, k_dec)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), -1)
    scores = scores * tri[None, None, None]
    diag = torch.einsum("bclhn,hn,bclhn->bclh", rs, u, ks)
    y_intra = torch.einsum("bchlm,bcmhn->bclhn", scores, vs)
    y_intra = y_intra + diag[..., None] * vs
    # chunk summary state: S_c = sum_j exp(cum_L - cum_j) k_j x v_j
    w_total = cum[:, :, -1]                         # (b,c,h,n)
    k_tail = ks * torch.exp(w_total[:, :, None] - cum)
    s_chunk = torch.einsum("bclhk,bclhv->bchkv", k_tail, vs)
    # inter-chunk recurrence: H_c = exp(w_total_c) H_{c-1} + S_c; chunk c
    # reads the state entering it, H_{c-1} (named for the profiler)
    with telemetry.span(CHUNK_LOOP):
        hprev = torch.zeros((b, h, n, n), dtype=torch.float32,
                            device=r.device)
        h_in = []
        for i in range(c):
            h_in.append(hprev)
            hprev = (torch.exp(w_total[:, i])[..., None] * hprev
                     + s_chunk[:, i])
        h_in = torch.stack(h_in, dim=1)             # (b,c,h,n,n)
    y_inter = torch.einsum("bclhk,bchkv->bclhv", r_dec, h_in)
    y = (y_intra + y_inter).reshape(b, t, h, n)
    return y[:, :t0]


def time_mix(p: dict, x: torch.Tensor, cfg: RWKVConfig,
             impl: str = "chunked", chunk: int = 64) -> torch.Tensor:
    b, t, d = x.shape
    h, n = cfg.num_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, _token_shift(x))
    tp = pctx.shard_batch_tp
    logw = pctx.unflatten(tp(_decay(p, xw)), -1, (h, n))
    r, k, v = (pctx.unflatten(tp(layers.dense(p[w], xi)), -1, (h, n)).to(
        torch.float32) for w, xi in (("wr", xr), ("wk", xk), ("wv", xv)))
    g = tp(layers.dense(p["wg"], xg))
    def wkv(r, k, v, logw, u):
        if impl == "scan":
            return _wkv_scan(r, k, v, logw, u)
        return _wkv_chunked(r, k, v, logw, u, chunk)

    # under a mesh, on each rank's (batch, heads) shard
    y = coll.per_head(wkv, (r, k, v, logw, p["bonus"]),
                      [("act", 2)] * 4 + [("param", 0)], 2)
    y = y.reshape(b, t, d).to(x.dtype)
    y = layers.layernorm(p["ln_x"], y)
    return layers.dense(p["wo"], y * F.silu(g))


def time_mix_decode(p: dict, x: torch.Tensor, state: dict, cfg: RWKVConfig):
    """One-token step.  x (B,1,d); state {"s": (B,H,N,N) f32, "last":
    (B,d)}.  Returns (out, {"s", "last"}): "last" is this step's x."""
    b, _, d = x.shape
    h, n = cfg.num_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, state["last"][:, None, :])
    tp = pctx.shard_batch_tp
    logw = pctx.unflatten(tp(_decay(p, xw)), -1, (h, n))[:, 0]
    r, k, v = (pctx.unflatten(tp(layers.dense(p[w], xi)), -1, (h, n))[:, 0]
               .to(torch.float32)
               for w, xi in (("wr", xr), ("wk", xk), ("wv", xv)))
    g = tp(layers.dense(p["wg"], xg))

    def step(r, k, v, logw, s, u):
        kv = torch.einsum("bhk,bhv->bhkv", k, v)
        y = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
        return y, torch.exp(logw)[..., None] * s + kv

    # under a mesh, on each rank's (batch, heads) shard
    y, s_new = coll.per_head(step, (r, k, v, logw, state["s"], p["bonus"]),
                             [("act", 1)] * 5 + [("param", 0)], (1, 1))
    y = y.reshape(b, 1, d).to(x.dtype)
    y = layers.layernorm(p["ln_x"], y)
    out = layers.dense(p["wo"], y * F.silu(g))
    return out, {"s": s_new, "last": x[:, 0, :]}


def channel_mix(p: dict, x: torch.Tensor, last=None) -> torch.Tensor:
    xp = _token_shift(x, last)
    xk = x + (xp - x) * p["cm_mix_k"]
    xr = x + (xp - x) * p["cm_mix_r"]
    k = torch.square(torch.relu(
        pctx.shard_batch_tp(layers.dense(p["cm_k"], xk))))
    return torch.sigmoid(layers.dense(p["cm_r"], xr)) * \
        layers.dense(p["cm_v"], k)


def init_state(cfg: RWKVConfig, batch: int, device="cuda") -> dict:
    h, n = cfg.num_heads, cfg.head_dim
    return {
        "s": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
        "last": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                            device=device),
        "cm_last": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                               device=device),
    }
