"""Plain PyTorch reference of the MoE causal LM that the cells run.

Imports nothing of the program: it reads the benchmark's parameter tree
by key and the configuration file's ``port`` section, and computes in
float32 (TF32 off), or, as the control, with every matrix product's
operands rounded to float8 e4m3 under a per-tensor scale.

The model, as the configuration states it:

  h = table[tokens]
  each layer:  h += attn(rmsnorm(h));  h += moe(rmsnorm(h))
  logits = rmsnorm(h) @ table^T  (tied)  or  @ lm_head.w

- rmsnorm: x / sqrt(mean(x^2) + 1e-6) * scale.
- attention: grouped-query (query head i reads key/value head
  i // (heads / kv_heads)), rotary embeddings on the two halves of each
  head (x1 cos - x2 sin, x2 cos + x1 sin; frequencies theta^(-2i/hd)),
  causal softmax of q k^T / sqrt(hd).
- moe: f32 router logits, softmax, the top k (the lower expert first
  among equal probabilities), gates renormalised to sum to 1.  Each call
  of the layer (the whole batch) gives every expert a
  capacity of int(n k / E * capacity_factor) rows, n the call's tokens;
  an expert's rows in token-major order past its capacity are dropped
  and add nothing (GShard).  Each expert is silu(x Wg) * (x Wu) @ Wd.
- aux: E * sum_e(share of tokens whose first expert is e * mean
  probability of e), summed over layers; the loss adds 0.001 of it.

The parameter tree: ``embed.table`` (V, d), ``final_norm.scale``,
``lm_head.w`` (d, V) where untied, and ``layers[i]`` with ``norm1``,
``norm2`` (``scale``), ``attn.{wq,wk,wv,wo}.w`` (in, out) and
``ffn.router.w`` (d, E), ``ffn.{w_gate,w_up}`` (E, d, f),
``ffn.w_down`` (E, f, d).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

EPS = 1e-6
FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Arch:
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_experts: int
    top_k: int
    d_expert: int
    vocab_size: int
    tie_embeddings: bool
    rope_theta: float
    capacity_factor: float
    aux_weight: float = 0.001

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a configuration file's ``port`` section."""
        return cls(
            num_layers=cfg["num_layers"], d_model=cfg["d_model"],
            num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"],
            head_dim=cfg["head_dim"], num_experts=cfg["num_experts"],
            top_k=cfg["top_k"], d_expert=cfg["d_expert"],
            vocab_size=cfg["vocab_size"],
            tie_embeddings=cfg.get("tie_embeddings", True),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            capacity_factor=float(cfg.get("moe_capacity_factor", 1.25)))


# -- precision ---------------------------------------------------------------


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 under one scale for the whole tensor (its
    largest magnitude to 448), back in f32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum a broadcast gradient back to ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands, and in the backward the incoming
    gradient, rounded to float8 e4m3; products summed in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round_fp8(a), _round_fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_fp8(g)
        ga = _sum_to(qg @ qb.transpose(-1, -2), ctx.shapes[0])
        gb = _sum_to(qa.transpose(-1, -2) @ qg, ctx.shapes[1])
        return ga, gb


@dataclasses.dataclass(frozen=True)
class Precision:
    """``"f32"``: float32 products, TF32 off.  ``"fp8"``: the control.
    ``"bf16"``: the products' operands rounded to bfloat16 (forward
    only), to read what the configuration's own precision does to the
    reference (a calibration aid)."""
    name: str = "f32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8MatMul.apply(a, b)
        if self.name == "bf16":
            return a.to(torch.bfloat16).to(torch.float32) \
                @ b.to(torch.bfloat16).to(torch.float32)
        return a @ b


F32 = Precision("f32")
FP8 = Precision("fp8")
BF16 = Precision("bf16")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


# -- blocks ------------------------------------------------------------------


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + EPS) \
        * f32(scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, T, hd) at positions 0..T-1; angles in float64."""
    t, hd = x.shape[2], x.shape[3]
    half = hd // 2
    pos = torch.arange(t, dtype=torch.float64, device=x.device)
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) * 2.0 / hd)
    ang = pos[:, None] * freq[None, :]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(p: dict, x: torch.Tensor, arch: Arch, prec: Precision,
              budget_bytes: int = 1 << 30) -> torch.Tensor:
    """Causal GQA self-attention over x (B, T, d) f32, the heads taken a
    block at a time so that the scores fit ``budget_bytes``."""
    b, t, _ = x.shape
    h, kv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim

    def heads(w, n):
        return prec.mm(x, f32(w)).view(b, t, n, hd).transpose(1, 2)

    q = rope(heads(p["wq"]["w"], h), arch.rope_theta)
    k = rope(heads(p["wk"]["w"], kv), arch.rope_theta)
    v = heads(p["wv"]["w"], kv)
    rep = h // kv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    per = max(1, budget_bytes // (b * t * t * 4))
    outs = []
    for i in range(0, h, per):
        s = prec.mm(q[:, i:i + per], k[:, i:i + per].transpose(-1, -2)) \
            * hd ** -0.5
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(prec.mm(torch.softmax(s, -1), v[:, i:i + per]))
    o = torch.cat(outs, 1).transpose(1, 2).reshape(b, t, h * hd)
    return prec.mm(o, f32(p["wo"]["w"]))


def moe(p: dict, x: torch.Tensor, arch: Arch, prec: Precision):
    """x (N, d) f32, tokens in the program's order, one call of the
    layer.  Returns (out (N, d), aux)."""
    n, d = x.shape
    e, k = arch.num_experts, arch.top_k
    probs = torch.softmax(prec.mm(x, f32(p["router"]["w"])), -1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    density = F.one_hot(ids[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(density * probs.mean(0))
    # each row's place among its expert's rows, token-major
    flat = ids.reshape(n * k)
    onehot = F.one_hot(flat, e).to(torch.int32)
    place = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    capacity = max(1, int(n * k / e * arch.capacity_factor))
    keep = place < capacity
    gate = gates.reshape(-1)
    out = torch.zeros_like(x)
    for j in range(e):
        rows = torch.nonzero((flat == j) & keep)[:, 0]
        if rows.numel() == 0:
            continue
        tok = torch.div(rows, k, rounding_mode="floor")
        xs = x[tok]
        hid = F.silu(prec.mm(xs, f32(p["w_gate"][j]))) \
            * prec.mm(xs, f32(p["w_up"][j]))
        y = prec.mm(hid, f32(p["w_down"][j]))
        out = out.index_add(0, tok, y * gate[rows][:, None])
    return out, aux


def layer(p: dict, h: torch.Tensor, arch: Arch, prec: Precision):
    """One block over h (B, T, d)."""
    b, t, d = h.shape
    h = h + attention(p["attn"], rmsnorm(p["norm1"]["scale"], h), arch,
                      prec)
    y, aux = moe(p["ffn"], rmsnorm(p["norm2"]["scale"], h).reshape(b * t, d),
                 arch, prec)
    return h + y.view(b, t, d), aux


def hidden(params: dict, tokens: torch.Tensor, arch: Arch, prec: Precision,
           checkpoint: bool = False):
    """Final-normed hidden states (B, T, d) f32 and the summed aux; the
    whole batch is one call of each MoE layer.  ``checkpoint``
    recomputes each layer in the backward pass."""
    h = f32(params["embed"]["table"])[tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in params["layers"]:
        def run(h, p=p):
            return layer(p, h, arch, prec)
        if checkpoint and torch.is_grad_enabled():
            h, a = torch.utils.checkpoint.checkpoint(run, h,
                                                     use_reentrant=False)
        else:
            h, a = run(h)
        aux = aux + a
    return rmsnorm(params["final_norm"]["scale"], h), aux


def head_weight(params: dict, arch: Arch) -> torch.Tensor:
    """(d, V) in the parameters' dtype."""
    if arch.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def logits(params: dict, h: torch.Tensor, arch: Arch, prec: Precision,
           head: torch.Tensor = None) -> torch.Tensor:
    """h @ the head (``head``: the head already in f32)."""
    return prec.mm(h, f32(head_weight(params, arch)) if head is None
                   else head)


def xent(params: dict, h: torch.Tensor, tokens: torch.Tensor, arch: Arch,
         prec: Precision, chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy: position t against token t + 1,
    the logits made ``chunk`` positions of a row at a time."""
    b, t, _ = h.shape
    gold = tokens[:, 1:].long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, t - 1, chunk):
        z = logits(params, h[:, i:min(i + chunk, t - 1)], arch, prec)
        g = gold[:, i:i + z.shape[1]]
        total = total + (torch.logsumexp(z, -1)
                         - z.gather(-1, g[..., None])[..., 0]).sum()
    return total / (b * (t - 1))


def loss(params: dict, tokens: torch.Tensor, arch: Arch, prec: Precision):
    """(xent + aux_weight * aux, xent, aux) of one training batch."""
    h, aux = hidden(params, tokens, arch, prec, checkpoint=True)
    x = xent(params, h, tokens, arch, prec)
    return x + arch.aux_weight * aux, x, aux


@torch.no_grad()
def served_gaps(params: dict, tokens: torch.Tensor, served: torch.Tensor,
                arch: Arch, other: Precision = None,
                chunk: int = 1024) -> torch.Tensor:
    """The reference's logits over ``tokens`` (B, T), in f32, at every
    position where ``served`` (B, T) holds a token (-1 elsewhere): how
    far below the position's best logit that token's lies.  With
    ``other`` (the control, ``FP8``), the token is the one that precision
    puts first at the position, and ``served`` only marks the positions.
    Returns the gaps of the marked positions, flat (f32)."""
    with exact_f32():
        h, _ = hidden(params, tokens, arch, F32)
        ho = None if other is None else \
            hidden(params, tokens, arch, other)[0]
        b, t, d = h.shape
        head = f32(head_weight(params, arch))
        want = served.reshape(-1).long()
        gaps = []
        for i in range(0, b * t, chunk):
            w = want[i:i + chunk]
            mark = w >= 0
            if not bool(mark.any()):
                continue
            z = logits(params, h.reshape(b * t, d)[i:i + chunk][mark], arch,
                       F32, head)
            tok = w[mark] if other is None else logits(
                params, ho.reshape(b * t, d)[i:i + chunk][mark], arch, other,
                head).argmax(-1)
            gaps.append(z.amax(-1) - z.gather(-1, tok[:, None])[:, 0])
        return torch.cat(gaps)


def all_gaps(params: dict, samples: list, arch: Arch,
             other: Precision = None) -> torch.Tensor:
    """``served_gaps`` of every sample, each a pair (tokens, served),
    together."""
    return torch.cat([served_gaps(params, tokens, served, arch, other)
                      for tokens, served in samples])


def serving_numbers(gaps: torch.Tensor) -> dict:
    """The numbers a serving cell's check compares: the widest gap (one
    wrong token shows there) and the mean gap over the served positions
    (how far the precision moves every token)."""
    return {"logit_gap": float(gaps.max()),
            "mean_gap": float(gaps.double().mean())}


def gap_stats(gaps: torch.Tensor) -> dict:
    """The spread of the gaps (a calibration aid): high quantiles and the
    share of positions whose token is not the reference's best."""
    g = gaps.double()
    q = torch.quantile(g, torch.tensor([0.99, 0.999], dtype=g.dtype,
                                       device=g.device)).tolist()
    return {"p99": q[0], "p999": q[1], "off_best": float((g > 0).double()
                                                         .mean()),
            "n": g.numel()}
