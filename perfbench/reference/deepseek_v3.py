"""Plain PyTorch reference of DeepSeek-V3 (``deepseek_v3``): multi-head
latent attention (MLA) in every layer, a dense FFN in the first
``first_k_dense`` layers and sigmoid-routed experts beside a shared
expert in the rest, cut to the share of the routed experts one card of an
expert-parallel deployment holds.

Imports nothing of the program: it reads the benchmark's parameter tree
by key and the configuration file's ``port`` section, and computes in
float32 (TF32 off), or with the products' operands rounded as
``model.py``'s precisions round them, whose helpers it shares.

The model, as the published configuration states it (each norm an
RMSNorm of eps ``norm_eps``):

  h = table[tokens]
  each layer:  h += mla(norm(h));  h += ffn(norm(h))
  logits = norm(h) @ lm_head                                 (untied)

- mla: q = wq_b(q_norm(wq_a(x))), per head q_nope (dn) and q_pe (dr);
  [c_kv, k_pe] = wkv_a(x) (kv_lora_rank and dr wide, one k_pe for all
  heads); [k_nope, v] = wkv_b(kv_norm(c_kv)), per head dn and dv; q_pe
  and k_pe rotated over adjacent pairs (x_2i, x_2i+1) by angles p · f_i
  in float64, f_i YaRN's: theta^(-2i/dr), divided by ``rope_factor``
  below the frequencies that turn ``beta_slow`` times over
  ``rope_original_max`` positions, kept above those that turn
  ``beta_fast`` times, a linear ramp between; causal softmax of
  [q_nope, q_pe] . [k_nope, k_pe] times (dn + dr)^-0.5 · m², m = 0.1 ·
  mscale_all_dim · ln(rope_factor) + 1, over v; then wo.  The scores
  are taken a block of heads and queries at a time, so that they fit.
- dense FFN: silu(x Wg) * (x Wu) @ Wd, of width ``d_ff_dense``.
- moe: s = sigmoid(x W_router) (f32, all E experts); each of ``n_group``
  groups scores the sum of its two best s + bias; the best ``topk_group``
  groups are kept; the top k experts by s + bias among the kept groups'
  (the lower expert first among equal values); weights: their s,
  normalised to sum to 1, times ``routed_scale``.  Of the experts
  [expert_offset, expert_offset + experts_held) (this card's), each
  takes its rows in token-major order up to a capacity of int(n k / E ·
  capacity_factor), n the call's tokens, and adds nothing for the rest;
  the other experts add nothing here.  Plus the shared expert, silu(x
  Wg) * (x Wu) @ Wd of width ``d_expert`` times ``num_shared_experts``.

Departures from the published model, each the program's too: the
experts' capacity (the published model routes every token); only this
card's experts (the deployment's other cards add the rest); no
multi-token-prediction module; no redundant expert; bf16 weights, read
here in f32.  Under a lower precision (the control) every product with a
weight, and attention's two, take the rounded operands.

A prefill's check (``compared``, ``numbers``) reads the served tokens'
gaps below the reference's best logit, and the program's logits
themselves at a few rows of each sequence, as ``granite_hybrid.py``'s.

The parameter tree: ``embed.table`` (V, d), ``final_norm.scale``,
``lm_head.w`` (d, V), and ``layers[i]`` with ``norm1``, ``norm2``
(``scale``), ``attn`` (``wq_a.w`` (d, q_lora), ``q_norm.scale``,
``wq_b.w`` (q_lora, H (dn + dr)), ``wkv_a.w`` (d, kv_lora + dr),
``kv_norm.scale``, ``wkv_b.w`` (kv_lora, H (dn + dv)), ``wo.w`` (H dv,
d)) and ``ffn``: ``{w_gate,w_up,w_down}.w`` (dense), or ``router.w`` (d,
E), ``score_bias`` (E), ``w_gate``, ``w_up`` (held, d, f), ``w_down``
(held, f, d) and ``shared.{w_gate,w_up,w_down}.w``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .granite_hybrid import numbers  # noqa: F401  (the same numbers)
from .model import F32, exact_f32, f32


@dataclasses.dataclass(frozen=True)
class Arch:
    num_layers: int
    d_model: int
    num_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense: int
    num_experts: int
    experts_held: int
    expert_offset: int
    top_k: int
    n_group: int
    topk_group: int
    routed_scale: float
    capacity_factor: float
    rope_theta: float
    rope_factor: float
    rope_original_max: int
    beta_fast: float
    beta_slow: float
    mscale_all_dim: float
    norm_eps: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a configuration file's ``port`` section."""
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls)
                      if f.name != "capacity_factor"},
                   capacity_factor=float(cfg["moe_capacity_factor"]))

    @property
    def scale(self) -> float:
        m = 0.1 * self.mscale_all_dim * math.log(self.rope_factor) + 1.0
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 * m * m


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * f32(scale)


def yarn_frequencies(arch: Arch, device) -> torch.Tensor:
    """(dr / 2,) float64."""
    dim, base = arch.qk_rope_head_dim, arch.rope_theta
    i = torch.arange(0, dim, 2, dtype=torch.float64, device=device)
    freq = base ** (-i / dim)

    def turns(rotations):
        return dim * math.log(arch.rope_original_max
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(turns(arch.beta_fast)), 0)
    high = min(math.ceil(turns(arch.beta_slow)), dim - 1)
    span = high - low if high > low else 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / span).clamp(0.0, 1.0)
    return freq / arch.rope_factor * ramp + freq * (1.0 - ramp)


def rope_pairs(x: torch.Tensor, arch: Arch) -> torch.Tensor:
    """x (..., T, dr) at positions 0..T-1, rotated over adjacent pairs;
    the angles in float64."""
    t = x.shape[-2]
    pos = torch.arange(t, dtype=torch.float64, device=x.device)
    ang = pos[:, None] * yarn_frequencies(arch, x.device)[None]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                       -1).flatten(-2)


def mla(p: dict, x: torch.Tensor, arch: Arch, prec,
        budget_bytes: int = 1 << 31, q_block: int = 2048) -> torch.Tensor:
    """Latent attention over x (B, T, d) f32; the scores of a block of
    heads and of ``q_block`` queries at a time against the keys up to the
    block's last, each within ``budget_bytes``."""
    b, t, _ = x.shape
    h, dn, dr, dv = (arch.num_heads, arch.qk_nope_head_dim,
                     arch.qk_rope_head_dim, arch.v_head_dim)
    eps = arch.norm_eps
    q = prec.mm(rmsnorm(p["q_norm"]["scale"], prec.mm(x, f32(p["wq_a"]["w"])),
                        eps), f32(p["wq_b"]["w"]))
    q = q.view(b, t, h, dn + dr).transpose(1, 2)              # (B, H, T, .)
    kv = prec.mm(x, f32(p["wkv_a"]["w"]))
    c_kv, k_pe = kv[..., :arch.kv_lora_rank], kv[..., arch.kv_lora_rank:]
    kv = prec.mm(rmsnorm(p["kv_norm"]["scale"], c_kv, eps),
                 f32(p["wkv_b"]["w"])).view(b, t, h, dn + dv).transpose(1, 2)
    q = torch.cat([q[..., :dn], rope_pairs(q[..., dn:], arch)], -1)
    k_pe = rope_pairs(k_pe, arch)[:, None].expand(b, h, t, dr)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    v = kv[..., dn:]
    del kv
    out = torch.empty((b, h, t, dv), dtype=torch.float32, device=x.device)
    q_block = min(t, q_block)
    per = max(1, budget_bytes // (b * q_block * t * 4))
    for i in range(0, t, q_block):
        end = min(i + q_block, t)
        rows = torch.arange(i, end, device=x.device)[:, None]
        above = torch.arange(end, device=x.device)[None] > rows
        for j in range(0, h, per):
            s = prec.mm(q[:, j:j + per, i:end],
                        k[:, j:j + per, :end].transpose(-1, -2)) * arch.scale
            s = torch.softmax(s.masked_fill(above, float("-inf")), -1)
            out[:, j:j + per, i:end] = prec.mm(s, v[:, j:j + per, :end])
            del s
    o = out.transpose(1, 2).reshape(b, t, h * dv)
    return prec.mm(o, f32(p["wo"]["w"]))


def mlp(p: dict, x: torch.Tensor, prec) -> torch.Tensor:
    hid = F.silu(prec.mm(x, f32(p["w_gate"]["w"]))) \
        * prec.mm(x, f32(p["w_up"]["w"]))
    return prec.mm(hid, f32(p["w_down"]["w"]))


def route(p: dict, x: torch.Tensor, arch: Arch, prec):
    """The sigmoid router over x (N, d): (weights (N, k), experts (N, k))."""
    n = x.shape[0]
    e, g = arch.num_experts, arch.n_group
    s = torch.sigmoid(prec.mm(x, f32(p["router"]["w"])))
    choice = s + f32(p["score_bias"])
    grouped = choice.view(n, g, e // g)
    group_score = torch.sort(grouped, -1, descending=True)[0][..., :2].sum(-1)
    kept = torch.sort(group_score, dim=-1, descending=True, stable=True)[1][
        :, :arch.topk_group]
    allowed = torch.zeros(n, g, dtype=torch.bool, device=x.device)
    allowed[torch.arange(n, device=x.device)[:, None], kept] = True
    choice = grouped.masked_fill(~allowed[..., None], float("-inf")).view(n, e)
    ids = torch.sort(choice, dim=-1, descending=True, stable=True)[1][
        :, :arch.top_k]
    w = s.gather(1, ids)
    return w / w.sum(-1, keepdim=True) * arch.routed_scale, ids


def moe(p: dict, x: torch.Tensor, arch: Arch, prec) -> torch.Tensor:
    """x (N, d) f32, tokens in the program's order, one call of the
    layer: this card's experts' part and the shared expert's."""
    n, _ = x.shape
    k = arch.top_k
    gates, ids = route(p, x, arch, prec)
    flat = ids.reshape(n * k)
    gate = gates.reshape(-1)
    capacity = max(1, int(n * k / arch.num_experts * arch.capacity_factor))
    out = mlp(p["shared"], x, prec)
    for j in range(arch.experts_held):
        rows = torch.nonzero(flat == arch.expert_offset + j)[:, 0]
        rows = rows[:capacity]            # token-major: the first to come
        if rows.numel() == 0:
            continue
        tok = torch.div(rows, k, rounding_mode="floor")
        xs = x[tok]
        hid = F.silu(prec.mm(xs, f32(p["w_gate"][j]))) \
            * prec.mm(xs, f32(p["w_up"][j]))
        y = prec.mm(hid, f32(p["w_down"][j]))
        out = out.index_add(0, tok, y * gate[rows][:, None])
    return out


def layer(p: dict, i: int, h: torch.Tensor, arch: Arch, prec):
    b, t, d = h.shape
    h = h + mla(p["attn"], rmsnorm(p["norm1"]["scale"], h, arch.norm_eps),
                arch, prec)
    xn = rmsnorm(p["norm2"]["scale"], h, arch.norm_eps)
    if i < arch.first_k_dense:
        return h + mlp(p["ffn"], xn, prec)
    return h + moe(p["ffn"], xn.reshape(b * t, d), arch, prec).view(b, t, d)


def hidden(params: dict, tokens: torch.Tensor, arch: Arch, prec):
    """Final-normed hidden states (B, T, d) f32; the whole batch is one
    call of each MoE layer."""
    h = f32(params["embed"]["table"])[tokens.long()]
    for i, p in enumerate(params["layers"]):
        h = layer(p, i, h, arch, prec)
    return rmsnorm(params["final_norm"]["scale"], h, arch.norm_eps)


def logits(params: dict, h: torch.Tensor, prec,
           head: torch.Tensor = None) -> torch.Tensor:
    """h @ the untied head (``head``: it already in f32)."""
    return prec.mm(h, f32(params["lm_head"]["w"]) if head is None else head)


@torch.no_grad()
def compared(params: dict, tokens: torch.Tensor, kept: tuple, arch: Arch,
             other=None, chunk: int = 1024) -> tuple:
    """What a prefill's check compares of one sample (``granite_hybrid.
    compared``'s): ``tokens`` (B, T) and what the program kept,
    ``(served, at, rows)``.  Returns (gaps, errs): each served token's
    gap below the reference's best f32 logit (flat), and each kept row's
    mean square difference from the reference's row beside that row's
    variance (rows, 2).  With ``other`` (a lower precision), the
    reference in that precision stands in the program's place."""
    served, at, rows = kept
    with exact_f32():
        h = hidden(params, tokens, arch, F32)
        ho = None if other is None else hidden(params, tokens, arch, other)
        b, t, d = h.shape
        head = f32(params["lm_head"]["w"])
        want = served.reshape(-1).long()
        gaps = []
        for i in range(0, b * t, chunk):
            w = want[i:i + chunk]
            mark = w >= 0
            if not bool(mark.any()):
                continue
            z = logits(params, h.reshape(b * t, d)[i:i + chunk][mark], F32,
                       head)
            tok = w[mark] if other is None else logits(
                params, ho.reshape(b * t, d)[i:i + chunk][mark], other,
                head).argmax(-1)
            gaps.append(z.amax(-1) - z.gather(-1, tok[:, None])[:, 0])
        pick = at[..., None].expand(-1, -1, d)
        want = logits(params, h.gather(1, pick), F32, head)
        if other is not None:
            rows = logits(params, ho.gather(1, pick), other, head)
        errs = torch.stack([(rows.float() - want).pow(2).mean(-1),
                            want.var(-1, unbiased=False)], -1)
        return torch.cat(gaps), errs.reshape(-1, 2)


def all_compared(params: dict, samples: list, arch: Arch,
                 other=None) -> tuple:
    """``compared`` of every sample (tokens, kept): the gaps together and
    the rows' errors together."""
    got = [compared(params, tokens, kept, arch, other)
           for tokens, kept in samples]
    return (torch.cat([g for g, _ in got]), torch.cat([e for _, e in got]))
