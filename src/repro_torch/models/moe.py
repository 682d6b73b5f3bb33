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
on the device its inputs lie on.

Under a mesh (``parallel/ctx.py``) the layer takes the reference's
distributed paths, each a body that runs on every rank over its local
shards (the reference's ``shard_map``): ``apply_ep`` for 64 experts or
more (``MoEConfig.use_ep``), whole experts over the EP axis with a
fixed-capacity all-to-all dispatch, and ``apply_sharded`` otherwise,
every expert on every data shard; both TP-shard the expert hidden over
the model axis.  The parameters and tokens come in as DTensors (or
plain tensors, the same on every rank), are redistributed to the
reference's in-specs and taken to their local shards; the outputs go
back as DTensors with its out-specs.  The collectives are the
reference's: the EP all-to-alls (``all_to_all_single`` of
``torch.distributed.nn``, which differentiates), the TP sum of the
expert outputs, and the mean of ``aux`` over the data axes.  Under
autograd the sum over the TP axis passes its gradient through
unchanged and the expert input sums its gradient over that axis (the
Megatron pair), and each local parameter's gradient leaves the body as
a partial sum over the data axes it is replicated on: the gradient of
the layer over all ranks' tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.models import layers, mlp
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import P

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
    capacity_factor: float = 1.25   # GShard capacity of each expert
    bf16_combine: bool = False      # keep the EP return path (unsort +
                                    # all-to-all back) in bf16: half the
                                    # wire traffic; each slot is written
                                    # once, so the combine loses nothing

    @property
    def use_ep(self) -> bool:
        """Whole-expert EP (all_to_all) for big expert counts; the small-E
        archs keep experts replicated over data and TP-shard the hidden."""
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
                        num_experts: int, capacity: int, cfg: MoEConfig,
                        tp_group=None) -> torch.Tensor:
    """Capacity-grouped expert FFN over expert-sorted rows ``xs`` (T·k, d)
    with int32 ``sorted_ids``: each expert's first ``capacity`` rows go
    through one batched product per projection; the rest come back zero.
    Rows whose id is ``num_experts`` or more (the EP body's empty slots,
    sorted last) count nowhere and come back zero.

    The dispatch count is K7, which drops those ids.  The kept rows are
    written into their (E, C) slots, and the dropped ones into one spare
    row past the buffer, which no product reads, so that nothing waits
    on the host for the number of kept rows.  With ``tp_group`` the
    expert weights are this rank's slice of the hidden, and the outputs
    are summed over the group.
    """
    tk, d = xs.shape
    counts = sk.bincount_launch(sorted_ids, num_experts)        # K7
    start = torch.cumsum(counts, 0) - counts
    sid = sorted_ids.to(torch.int64)
    valid = sid < num_experts
    pos = torch.arange(tk, device=xs.device) - start[
        sid.clamp(max=num_experts - 1)]
    keep = (pos < capacity) & valid
    slots = num_experts * capacity
    slot = torch.where(keep, sid * capacity + pos, slots)
    buf = xs.new_zeros((slots + 1, d))
    buf.index_put_((slot,), xs)   # under grad: d xs = d buf[slot]
    buf = buf[:slots].view(num_experts, capacity, d)
    if tp_group is not None:
        buf = coll.grad_sum_over(buf, tp_group)
    act = mlp._ACT[cfg.activation]
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    del buf
    y = torch.bmm(h.to(xs.dtype), p["w_down"]).view(slots, d)
    del h
    if tp_group is not None:
        y = coll.sum_over(y, tp_group)
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


def _shared(p: dict, x: torch.Tensor, cfg: MoEConfig, tp_group):
    """The shared experts' MLP; with ``tp_group`` its weights are this
    rank's slice of the hidden and its output is summed over the group
    (the reference's mesh bodies leave out that sum, and with a model
    axis of more than one rank and shared experts their out-spec, which
    says the output is the same on every model rank, would not hold; no
    config of the repo has shared experts)."""
    if tp_group is None:
        return mlp.apply(p["shared"], x, cfg.activation)
    x = coll.grad_sum_over(x, tp_group)
    return coll.sum_over(mlp.apply(p["shared"], x, cfg.activation),
                               tp_group)


def apply_local(p: dict, x: torch.Tensor, cfg: MoEConfig,
                axis_name: Optional[str] = None, mesh=None):
    """MoE over the tokens x (T, d) on their device: unsharded on one
    device (``axis_name=None``), or a rank's body inside
    ``apply_sharded``, where ``axis_name`` is the TP axis of ``mesh``
    (default: the current mesh's) to sum the expert outputs over.

    Returns (out (T, d) in x's dtype, aux loss, dispatch ids (T·k,) int32:
    the expert stream in issue order, the instrumented profiler's index
    stream).
    """
    tp_group = _group(axis_name, mesh)
    t, _ = x.shape
    gates, ids, aux = route(p, x, cfg)
    flat_ids, order, sorted_ids, xs, capacity = dispatch(x, ids, cfg)
    y_sorted = _expert_ffn_grouped(p, xs, sorted_ids, cfg.num_experts,
                                   capacity, cfg, tp_group)
    del xs
    # K5: each token's gate-weighted expert rows summed in f32
    vals, tok = combine_inputs(y_sorted, gates, order, cfg.top_k)
    del y_sorted
    out = sk.scatter_add_autograd(vals, tok, t).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + _shared(p, x, cfg, tp_group)
    return out, aux, flat_ids


# ---------------------------------------------------------------------------
# The mesh paths: a body per rank over its local shards
# ---------------------------------------------------------------------------


def _group(axis: Optional[str], mesh=None):
    if axis is None:
        return None
    if mesh is None:
        mesh = pctx.current().mesh
    return mesh.get_group(axis)


def _expert_pspec(cfg: MoEConfig, tp_axis: str, ep_axis=None) -> dict:
    """The reference's in-spec of the layer's parameters."""
    pspec = {"router": {"w": P()},
             "w_gate": P(ep_axis, None, tp_axis),
             "w_up": P(ep_axis, None, tp_axis),
             "w_down": P(ep_axis, tp_axis, None)}
    if cfg.num_shared_experts:
        pspec["shared"] = {"w_gate": {"w": P(None, tp_axis)},
                           "w_up": {"w": P(None, tp_axis)},
                           "w_down": {"w": P(tp_axis, None)}}
    return pspec


def _mesh_body(body, p: dict, x, cfg: MoEConfig, mesh, data_axes, tp_axis,
               ep_axis=None):
    """Run ``body(p_local, x_local (T, d))`` on every rank with the
    reference's in-specs (experts over ``ep_axis`` and the hidden over
    ``tp_axis``; tokens over ``data_axes``) and out-specs: out
    ``P(data_axes)``, aux ``P()``, dispatch ``P(data_axes)``."""
    data_axes = tuple(data_axes)
    pspec = _expert_pspec(cfg, tp_axis, ep_axis)
    p_local = tree.map(lambda v, s: coll.to_local(v, mesh, s, data_axes),
                       {k: p[k] for k in pspec}, pspec)
    x_local = coll.to_local(x, mesh, P(data_axes))
    bl, sl, d = x_local.shape
    out, aux, disp = body(p_local, x_local.reshape(bl * sl, d))
    aux = coll.mean_over(aux, [mesh.get_group(a) for a in data_axes])
    return (coll.from_local(out.reshape(bl, sl, d), mesh, P(data_axes)),
            coll.from_local(aux, mesh, P()),
            coll.from_local(disp, mesh, P(data_axes)))


def _ep_local(p: dict, x_local: torch.Tensor, cfg: MoEConfig,
              ep_group, tp_group):
    """Whole-expert EP body (one rank).

    x_local (T, d): this data shard's tokens; ``p`` holds E/D whole
    experts (their hidden split over the TP group).  GShard-style
    fixed-capacity all-to-all dispatch: per-destination buffers of
    ``cap`` rows, overflow dropped (the residual path carries the
    token).  K7 counts the rows bound for each shard (the paper's
    histogram) and, on the receiving rank, each local expert's rows; K5
    sums each token's gate-weighted rows on their return.

    An empty slot of a send buffer carries the expert id ``e_local`` and
    the slot ``tk``, both one past the end: K7 and ``_expert_ffn_grouped``
    count and compute nothing for that id, and K5 adds nothing for that
    slot (it drops segment ids past its count, as the reference's
    ``mode="drop"`` does).
    """
    d_shards = dist.get_world_size(ep_group)
    t, d = x_local.shape
    k = cfg.top_k
    e_local = cfg.num_experts // d_shards
    gates, ids, aux = route(p, x_local, cfg)                  # (T, k)
    flat_ids, order, sorted_ids, xs, _ = dispatch(x_local, ids, cfg)
    tk = flat_ids.shape[0]
    dev = x_local.device

    cap = max(1, int(tk / d_shards * cfg.capacity_factor))
    dst = torch.div(sorted_ids, e_local, rounding_mode="floor")  # ascending
    counts_dst = sk.bincount_launch(dst, d_shards)              # K7
    start = torch.cumsum(counts_dst, 0) - counts_dst
    dst64 = dst.to(torch.int64)
    pos_in_dst = torch.arange(tk, device=dev) - start[dst64]
    keep = pos_in_dst < cap
    slots = d_shards * cap
    slot = torch.where(keep, dst64 * cap + pos_in_dst, slots)  # spare: drop

    send_x = xs.new_zeros((slots + 1, d))
    send_x.index_put_((slot,), xs)
    send_id = torch.full((slots + 1,), e_local, dtype=torch.int32,
                         device=dev)                           # empty slot
    send_id[slot] = torch.remainder(sorted_ids, e_local).to(torch.int32)
    send_slot = torch.full((slots + 1,), tk, dtype=torch.int64, device=dev)
    send_slot[slot] = order
    del xs

    rx = coll.all_to_all(send_x[:slots], ep_group)         # (D·cap, d)
    rid = coll.all_to_all(send_id[:slots], ep_group)
    order2 = torch.argsort(rid, stable=True)
    rs = rx[order2]
    rids = rid[order2]                                  # empty: id e_local
    cap2 = max(1, int(rx.shape[0] / e_local * cfg.capacity_factor))
    y = _expert_ffn_grouped(p, rs, rids, e_local, cap2, cfg, tp_group)
    del rs
    y = y[torch.argsort(order2)]                        # unsort locally
    comb_dt = x_local.dtype if cfg.bf16_combine else torch.float32
    back = coll.all_to_all(y.to(comb_dt), ep_group)

    # K5: slot s of the (T, k) stream is token s // k; an empty slot (tk)
    # is token t, one past the end, and adds nothing
    ret = send_slot[:slots]
    g = torch.cat([gates.reshape(-1), gates.new_zeros(1)])[ret]
    vals = back.to(torch.float32) * g[:, None]
    tok = torch.div(ret, k, rounding_mode="floor").to(torch.int32)
    out = sk.scatter_add_autograd(vals, tok, t).to(x_local.dtype)
    if cfg.num_shared_experts:
        out = out + _shared(p, x_local, cfg, tp_group)
    return out, aux, flat_ids


def apply_ep(p: dict, x, cfg: MoEConfig, mesh, data_axes=("pod", "data"),
             tp_axis: str = "model", ep_axis: str = "data"):
    """Whole-expert EP over ``ep_axis`` + intra-expert TP over
    ``tp_axis``: x (B, S, d) tokens over ``data_axes``, expert weights
    ``P(ep, None, tp)``; experts replicate over pod (pure DP across
    pods).  Returns (out (B, S, d), aux, dispatch ids) as DTensors."""
    def body(p_local, x_local):
        return _ep_local(p_local, x_local, cfg, mesh.get_group(ep_axis),
                         mesh.get_group(tp_axis))
    return _mesh_body(body, p, x, cfg, mesh, data_axes, tp_axis, ep_axis)


def apply_sharded(p: dict, x, cfg: MoEConfig, mesh,
                  data_axes=("pod", "data"), tp_axis: str = "model"):
    """x (B, S, d) over ``data_axes``; every expert on every data shard,
    its hidden TP-sharded over ``tp_axis``: ``apply_local`` on each
    rank's tokens.  Returns (out, aux, dispatch ids) as DTensors."""
    def body(p_local, x_local):
        return apply_local(p_local, x_local, cfg, axis_name=tp_axis,
                           mesh=mesh)
    return _mesh_body(body, p, x, cfg, mesh, data_axes, tp_axis)
