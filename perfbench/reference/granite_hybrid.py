"""Plain PyTorch reference of Granite 4.0-H (``granitemoehybrid``), the
hybrid of Mamba-2 and attention mixers, each followed by an MoE with a
shared expert.

Imports nothing of the program: it reads the benchmark's parameter tree
by key and the configuration file's ``port`` section, and computes in
float32 (TF32 off), or with the products' operands rounded as
``model.py``'s precisions round them, whose helpers it shares.

The model, as the published configuration states it (r the
``residual_multiplier``, each norm an RMSNorm of eps ``norm_eps``):

  h = table[tokens] * embedding_multiplier
  each layer:  h += r * mixer(norm(h))       (``layer_types``: "mamba"
                                               or "attention")
               h += r * (moe(norm(h)) + shared(norm(h)))
  logits = norm(h) @ table^T / logits_scaling      (tied)

- attention: grouped-query, no position embeddings (NoPE), causal
  softmax of q k^T * ``attention_multiplier``.
- mamba (Mamba-2, n_groups 1): in_proj to (z, xBC, dt); xBC through the
  causal depthwise conv of width 4 with its bias, then SiLU, split into
  (x, B, C); dt = softplus(dt + dt_bias), A = -exp(a_log); the SSD
  y_t = sum_{s<=t} C_t . B_s exp(sum_{s<u<=t} A dt_u) dt_s x_s, by the
  SSD paper's chunked segment-sum algorithm at chunks of ``CHUNK`` (64,
  not the program's 256: a fault at the program's chunk boundaries
  cannot cancel here); plus D x; then rmsnorm(y * silu(z)) and out_proj.
- moe: ``model.moe`` (softmax router, top k renormalised, each expert's
  capacity int(n k / E * capacity_factor) rows of a call, the rest
  dropped), which equals Granite's softmax over the top-k logits.
- shared: silu(x Wg) * (x Wu) @ Wd, of width ``d_shared``.

Departures from the published model, each the program's too: the
experts' capacity (the published model routes every token); bf16
weights, here read in f32.  Under a lower precision (the control) the
products with a weight, and attention's two, take the rounded operands;
the SSD's own products stay in f32.

A prefill's check (``compared``, ``numbers``) reads the served tokens'
gaps below the reference's best logit, as ``model.py``'s does, and the
program's logits themselves at a few rows of each sequence.

The parameter tree: ``embed.table`` (V, d), ``final_norm.scale``, and
``layers[i]`` with ``norm1``, ``norm2`` (``scale``), ``ffn`` (the MoE's
``router.w`` (d, E), ``w_gate``, ``w_up`` (E, d, f), ``w_down`` (E, f,
d), ``shared.{w_gate,w_up,w_down}.w``), and ``attn.{wq,wk,wv,wo}.w`` (in,
out) or ``ssm`` (``in_proj.w`` (d, 2 d_in + 2 N + H), ``conv_w`` (4,
d_in + 2 N), ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip`` (H),
``norm.scale`` (d_in), ``out_proj.w`` (d_in, d)).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .model import F32, exact_f32, f32, serving_numbers
from .model import moe as routed_moe

CHUNK = 64
CONV = 4


@dataclasses.dataclass(frozen=True)
class Arch:
    layer_types: tuple
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_experts: int
    top_k: int
    d_expert: int
    ssm_state: int
    ssm_head_dim: int
    vocab_size: int
    capacity_factor: float
    embedding_multiplier: float
    residual_multiplier: float
    attention_multiplier: float
    logits_scaling: float
    norm_eps: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a configuration file's ``port`` section."""
        return cls(
            layer_types=tuple(cfg["layer_types"]), d_model=cfg["d_model"],
            num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"],
            head_dim=cfg["head_dim"], num_experts=cfg["num_experts"],
            top_k=cfg["top_k"], d_expert=cfg["d_expert"],
            ssm_state=cfg["ssm_state"], ssm_head_dim=cfg["ssm_head_dim"],
            vocab_size=cfg["vocab_size"],
            capacity_factor=float(cfg["moe_capacity_factor"]),
            embedding_multiplier=float(cfg["embedding_multiplier"]),
            residual_multiplier=float(cfg["residual_multiplier"]),
            attention_multiplier=float(cfg["attention_multiplier"]),
            logits_scaling=float(cfg["logits_scaling"]),
            norm_eps=float(cfg["norm_eps"]))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * f32(scale)


def attention(p: dict, x: torch.Tensor, arch: Arch, prec,
              budget_bytes: int = 1 << 30) -> torch.Tensor:
    """Causal GQA over x (B, T, d) f32, no position embeddings, the heads
    a block at a time so that the scores fit ``budget_bytes``."""
    b, t, _ = x.shape
    h, kv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim

    def heads(w, n):
        return prec.mm(x, f32(w)).view(b, t, n, hd).transpose(1, 2)

    rep = h // kv
    q = heads(p["wq"]["w"], h)
    k = heads(p["wk"]["w"], kv).repeat_interleave(rep, dim=1)
    v = heads(p["wv"]["w"], kv).repeat_interleave(rep, dim=1)
    above = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    per = max(1, budget_bytes // (b * t * t * 4))
    outs = []
    for i in range(0, h, per):
        s = prec.mm(q[:, i:i + per], k[:, i:i + per].transpose(-1, -2)) \
            * arch.attention_multiplier
        s = torch.softmax(s.masked_fill(above, float("-inf")), -1)
        outs.append(prec.mm(s, v[:, i:i + per]))
    o = torch.cat(outs, 1).transpose(1, 2).reshape(b, t, h * hd)
    return prec.mm(o, f32(p["wo"]["w"]))


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L): entry (i, j) the sum of a over j < u <=
    i where j <= i, and -inf above the diagonal."""
    n = a.shape[-1]
    cum = torch.cumsum(a, -1)
    out = cum[..., :, None] - cum[..., None, :]
    above = torch.ones(n, n, dtype=torch.bool, device=a.device).triu(1)
    return out.masked_fill(above, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b_mat: torch.Tensor, c_mat: torch.Tensor,
        chunk: int = CHUNK) -> torch.Tensor:
    """The SSD paper's chunked algorithm (``ssd_minimal_discrete``):
    x (B, T, H, P), dt (B, T, H), a (H,), b/c (B, T, N), all f32; from a
    zero state.  Returns y (B, T, H, P)."""
    bsz, t0, h, p = x.shape
    pad = (-t0) % chunk          # dt = 0 past the end: no input, no decay
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    b_mat, c_mat = (F.pad(m, (0, 0, 0, pad)) for m in (b_mat, c_mat))
    c = (t0 + pad) // chunk
    xs = (x * dt[..., None]).view(bsz, c, chunk, h, p)
    la = (dt * a).view(bsz, c, chunk, h).permute(0, 3, 1, 2)  # (B,H,c,L)
    bs = b_mat.view(bsz, c, chunk, -1)
    cs = c_mat.view(bsz, c, chunk, -1)
    cum = torch.cumsum(la, -1)
    # within each chunk
    cb = torch.einsum("bcln,bcsn->bcls", cs, bs)
    m = torch.exp(segsum(la)) * cb[:, None]                   # (B,H,c,L,L)
    y = torch.einsum("bhcls,bcshp->bclhp", m, xs)
    del m
    # each chunk's state, from its own inputs
    tail = torch.exp(cum[..., -1:] - cum).permute(0, 2, 3, 1)  # (B,c,L,H)
    states = torch.einsum("bclhp,bcln->bchpn", xs * tail[..., None], bs)
    # the states entering each chunk, over the chunks' summed decays
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    across = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))   # (B,H,c+1,..)
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y = y + torch.einsum("bcln,bchpn->bclhp", cs, states) \
        * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(bsz, c * chunk, h, p)[:, :t0]


def mamba(p: dict, x: torch.Tensor, arch: Arch, prec) -> torch.Tensor:
    """The Mamba-2 mixer over x (B, T, d) f32."""
    bsz, t, _ = x.shape
    d_in = 2 * arch.d_model
    n, hp = arch.ssm_state, arch.ssm_head_dim
    h = d_in // hp
    z, xbc, dt = torch.split(prec.mm(x, f32(p["in_proj"]["w"])),
                             (d_in, d_in + 2 * n, h), -1)
    w = f32(p["conv_w"]).T[:, None, :]                        # (C, 1, W)
    xbc = F.silu(F.conv1d(F.pad(xbc.transpose(1, 2), (CONV - 1, 0)), w,
                          f32(p["conv_b"]), groups=w.shape[0]))
    xs, b_mat, c_mat = torch.split(xbc.transpose(1, 2), (d_in, n, n), -1)
    dt = F.softplus(dt + f32(p["dt_bias"]))
    a = -torch.exp(f32(p["a_log"]))
    xh = xs.reshape(bsz, t, h, hp)
    y = ssd(xh, dt, a, b_mat, c_mat) + xh * f32(p["d_skip"])[:, None]
    y = y.reshape(bsz, t, d_in) * F.silu(z)
    y = rmsnorm(p["norm"]["scale"], y, arch.norm_eps)
    return prec.mm(y, f32(p["out_proj"]["w"]))


def shared(p: dict, x: torch.Tensor, prec) -> torch.Tensor:
    hid = F.silu(prec.mm(x, f32(p["w_gate"]["w"]))) \
        * prec.mm(x, f32(p["w_up"]["w"]))
    return prec.mm(hid, f32(p["w_down"]["w"]))


def layer(p: dict, kind: str, h: torch.Tensor, arch: Arch, prec):
    """One layer over h (B, T, d): (h, the MoE's aux loss)."""
    b, t, d = h.shape
    r = arch.residual_multiplier
    xn = rmsnorm(p["norm1"]["scale"], h, arch.norm_eps)
    mixed = (mamba(p["ssm"], xn, arch, prec) if kind == "mamba"
             else attention(p["attn"], xn, arch, prec))
    h = h + r * mixed
    xn = rmsnorm(p["norm2"]["scale"], h, arch.norm_eps).reshape(b * t, d)
    y, aux = routed_moe(p["ffn"], xn, arch, prec)
    y = y + shared(p["ffn"]["shared"], xn, prec)
    return h + r * y.view(b, t, d), aux


def hidden(params: dict, tokens: torch.Tensor, arch: Arch, prec):
    """Final-normed hidden states (B, T, d) f32 and the summed aux; the
    whole batch is one call of each MoE layer."""
    h = f32(params["embed"]["table"])[tokens.long()] \
        * arch.embedding_multiplier
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, kind in zip(params["layers"], arch.layer_types):
        h, a = layer(p, kind, h, arch, prec)
        aux = aux + a
    return rmsnorm(params["final_norm"]["scale"], h, arch.norm_eps), aux


def logits(params: dict, h: torch.Tensor, arch: Arch, prec,
           head: torch.Tensor = None) -> torch.Tensor:
    """h @ the tied head / ``logits_scaling`` (``head``: the head already
    in f32)."""
    w = f32(params["embed"]["table"].T) if head is None else head
    return prec.mm(h, w) / arch.logits_scaling


@torch.no_grad()
def compared(params: dict, tokens: torch.Tensor, kept: tuple, arch: Arch,
             other=None, chunk: int = 1024) -> tuple:
    """What a prefill's check compares of one sample: ``tokens`` (B, T)
    and what the program kept of it, ``(served, at, rows)``: the token it
    put first at each position (B, T; -1 where none was kept), and its
    logits ``rows`` (B, P, V) at the positions ``at`` (B, P).

    Returns (gaps, errs): at each served position, how far below the
    reference's best f32 logit the served token's lies (flat); and for
    each kept row, the mean square of its difference from the reference's
    row and the reference row's variance, (rows, 2).  With ``other``
    (a lower precision), the reference in that precision stands in the
    program's place: its first token at each served position and its
    rows at ``at``."""
    served, at, rows = kept
    with exact_f32():
        h, _ = hidden(params, tokens, arch, F32)
        ho = None if other is None else hidden(params, tokens, arch,
                                               other)[0]
        b, t, d = h.shape
        head = f32(params["embed"]["table"].T)
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
                params, ho.reshape(b * t, d)[i:i + chunk][mark], arch,
                other, head).argmax(-1)
            gaps.append(z.amax(-1) - z.gather(-1, tok[:, None])[:, 0])
        pick = at[..., None].expand(-1, -1, d)
        want = logits(params, h.gather(1, pick), arch, F32, head)
        if other is not None:
            rows = logits(params, ho.gather(1, pick), arch, other, head)
        errs = torch.stack([(rows.float() - want).pow(2).mean(-1),
                            want.var(-1, unbiased=False)], -1)
        return torch.cat(gaps), errs.reshape(-1, 2)


def all_compared(params: dict, samples: list, arch: Arch,
                 other=None) -> tuple:
    """``compared`` of every sample, each a pair (tokens, kept): the
    gaps together and the rows' errors together."""
    got = [compared(params, tokens, kept, arch, other)
           for tokens, kept in samples]
    return (torch.cat([g for g, _ in got]), torch.cat([e for _, e in got]))


def numbers(gaps: torch.Tensor, errs: torch.Tensor) -> dict:
    """The numbers a prefill cell's check can compare:
    ``model.serving_numbers`` of the gaps; ``logit_err``, the RMS of the
    kept rows' differences from the reference's over the RMS of the
    reference's rows about their means, all rows together; and
    ``logit_err_max``, the same of the worst row alone."""
    err, var = errs.double().unbind(-1)
    return dict(serving_numbers(gaps),
                logit_err=float((err.mean() / var.mean()).sqrt()),
                logit_err_max=float((err / var).max().sqrt()))
