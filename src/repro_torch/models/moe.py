"""Mixture-of-Experts layer on one card: top-k routing, a sort by expert,
the dispatch count in K7, capacity-grouped expert products and the
combine in K5.

The reference's ``apply_local`` (``repro/models/moe.py``), the layer its
``CausalLM`` runs on one device.  For the tokens x (T, d) the layer

  1. routes: f32 router logits, softmax, top-k (the lower expert first
     among equal probabilities, as ``jax.lax.top_k``), gates renormalised
     to sum to 1, and the Switch load-balance loss;
  2. sorts the (token, slot) stream by expert id, stably, as
     ``jnp.argsort`` does: which of an expert's rows overflow its
     capacity depends on that order;
  3. counts the rows of each expert with K7 (``bincount_launch``): the
     paper's histogram, on live router output (a collapsed router is its
     solid image, a balanced one its uniform image);
  4. writes each expert's first ``capacity`` rows into an (E, C, d)
     buffer and runs one batched product per projection (plain large
     products, left to cuBLAS as the reference leaves them to XLA); the
     rows past the capacity are dropped (GShard semantics) and add
     nothing to their token;
  5. sums each token's gate-weighted expert rows with K5
     (``scatter_add_autograd``: ``scatter_add_launch`` with a gather for
     its backward): the reference's unsort and ``einsum("tkd,tk->td")``
     as one segment sum of f32 values.

Under autograd (training) every step is differentiable, as the
reference's ``jax.grad`` through ``apply_local``: K7's counts are
integers and need no gradient, the buffer of step 4 is a fresh one whose
zeros autograd never reads, and the gates are applied out of place where
autograd needs the rows they scale.  Serving (no grad) scales them in
place, to keep its memory.

Every launcher runs its plain version for CPU tensors, so the layer runs
on the device its inputs lie on.  ``apply_ep`` and ``apply_sharded``
need a mesh: they wait for the multi-device MoE paths (ROADMAP queue 1,
"Multi-device and the zoo audit").  On one device the reference ignores
``use_ep`` too.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.models import layers, mlp

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int              # per-expert hidden (d_ff of one expert)
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    router_aux_coef: float = 0.001
    activation: str = "silu"
    dtype: str = "bfloat16"
    capacity_factor: float = 1.25
    # the reference's EP return path in bf16; one card has no such path
    bf16_combine: bool = False

    @property
    def use_ep(self) -> bool:
        """Whole-expert EP (all_to_all) for big expert counts, in the
        reference's meshes; one card runs ``apply_local`` either way."""
        return self.num_experts >= 64


def init(gen: torch.Generator, cfg: MoEConfig) -> dict:
    """Router (d, E) and expert weights (E, d, f), (E, f, d), drawn from
    ``gen`` on its device with the reference's fan-in scales."""
    dt = layers.torch_dtype(cfg.dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_expert
    scale_in, scale_out = d ** -0.5, f ** -0.5
    p = {
        "router": layers.dense_init(gen, d, e, dt),
        "w_gate": layers.truncated_normal_init(gen, (e, d, f), scale_in, dt),
        "w_up": layers.truncated_normal_init(gen, (e, d, f), scale_in, dt),
        "w_down": layers.truncated_normal_init(gen, (e, f, d), scale_out, dt),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp.init(gen, d, f * cfg.num_shared_experts, dt)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """Router: (gates (T, k) f32, ids (T, k) int32, aux loss scalar)."""
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance auxiliary loss
    lead = tuple(range(ids.dim() - 1))
    density = F.one_hot(ids[..., 0], cfg.num_experts).to(
        torch.float32).mean(dim=lead)
    mean_probs = probs.mean(dim=lead)
    aux = cfg.num_experts * torch.sum(density * mean_probs)
    return gates, ids.to(torch.int32), aux


def _expert_ffn_sorted(p: dict, xs: torch.Tensor, group_sizes,
                       cfg: MoEConfig) -> torch.Tensor:
    """The reference's ``ragged_dot`` FFN over expert-sorted rows: the
    next ``group_sizes[e]`` rows through expert e, one product per group;
    rows past the groups stay zero.  The reference calls it from nowhere
    (its layer takes the capacity-grouped path below)."""
    act = mlp._ACT[cfg.activation]
    out = xs.new_zeros((xs.shape[0], p["w_down"].shape[-1]))
    start = 0
    for e, n in enumerate(torch.as_tensor(group_sizes).tolist()):
        rows = xs[start:start + n]
        h = act(rows @ p["w_gate"][e]) * (rows @ p["w_up"][e])
        out[start:start + n] = h.to(xs.dtype) @ p["w_down"][e]
        start += n
    return out


def _expert_ffn_grouped(p: dict, xs: torch.Tensor, sorted_ids: torch.Tensor,
                        num_experts: int, capacity: int,
                        cfg: MoEConfig) -> torch.Tensor:
    """Capacity-grouped expert FFN over expert-sorted rows ``xs`` (T·k, d)
    with int32 ``sorted_ids``: each expert's first ``capacity`` rows go
    through one batched product per projection; the rest come back zero.

    The dispatch count is K7.  The kept rows are written into their
    (E, C) slots, and the dropped ones into one spare row past the
    buffer, which no product reads, so that nothing waits on the host
    for the number of kept rows.
    """
    tk, d = xs.shape
    counts = sk.bincount_launch(sorted_ids, num_experts)        # K7
    start = torch.cumsum(counts, 0) - counts
    sid = sorted_ids.to(torch.int64)
    pos = torch.arange(tk, device=xs.device) - start[sid]
    keep = pos < capacity
    slots = num_experts * capacity
    slot = torch.where(keep, sid * capacity + pos, slots)
    buf = xs.new_zeros((slots + 1, d))
    buf.index_put_((slot,), xs)   # under grad: d xs = d buf[slot]
    buf = buf[:slots].view(num_experts, capacity, d)
    act = mlp._ACT[cfg.activation]
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    del buf
    y = torch.bmm(h.to(xs.dtype), p["w_down"]).view(slots, d)
    del h
    rows = y[slot.clamp(max=slots - 1)]
    return torch.where(keep[:, None], rows, 0.0)


def combine_inputs(y_sorted: torch.Tensor, gates: torch.Tensor,
                   order: torch.Tensor, top_k: int):
    """K5's inputs: the expert rows times their gates, (T·k, d) f32, and
    the token of each, int32.  Row i of ``y_sorted`` is slot ``order[i]``
    of the token-major (T, k) stream, so it belongs to token
    ``order[i] // k``."""
    g = gates.reshape(-1)[order][:, None]
    if torch.is_grad_enabled() and (y_sorted.requires_grad
                                    or gates.requires_grad):
        vals = y_sorted.to(torch.float32) * g   # autograd keeps both
    else:
        vals = y_sorted.to(torch.float32, copy=True)
        vals.mul_(g)
    ids = torch.div(order, top_k, rounding_mode="floor").to(torch.int32)
    return vals, ids


def dispatch(x: torch.Tensor, ids: torch.Tensor, cfg: MoEConfig):
    """The expert-sorted stream of the router's ``ids`` (T, k): (flat
    ids (T·k,) int32 in issue order, the stable sort's order, the sorted
    ids, the rows of x in sorted order, the capacity)."""
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    # row i of x repeated k times, taken in sorted order
    xs = x[torch.div(order, cfg.top_k, rounding_mode="floor")]
    sorted_ids = flat_ids[order]
    capacity = max(1, int(flat_ids.shape[0] / cfg.num_experts
                          * cfg.capacity_factor))
    return flat_ids, order, sorted_ids, xs, capacity


def apply_local(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """MoE over the tokens x (T, d) on their device.

    Returns (out (T, d) in x's dtype, aux loss, dispatch ids (T·k,) int32:
    the expert stream in issue order, the instrumented profiler's index
    stream).
    """
    t, _ = x.shape
    gates, ids, aux = route(p, x, cfg)
    flat_ids, order, sorted_ids, xs, capacity = dispatch(x, ids, cfg)
    y_sorted = _expert_ffn_grouped(p, xs, sorted_ids, cfg.num_experts,
                                   capacity, cfg)
    del xs
    # K5: each token's gate-weighted expert rows summed in f32
    vals, tok = combine_inputs(y_sorted, gates, order, cfg.top_k)
    del y_sorted
    out = sk.scatter_add_autograd(vals, tok, t).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + mlp.apply(p["shared"], x, cfg.activation)
    return out, aux, flat_ids
