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
     solid image, a balanced one its uniform image); each row's slot
     follows from the counts (``slot_map``, which the EP body's send and
     receive buffers use too);
  4. puts each expert's first ``capacity`` rows in an (E, C, d) buffer
     (``dispatch``: without autograd each slot gathered from x through
     its token, under it x's rows in sorted order written through their
     slots) and runs one batched product per projection (plain large
     products, left to cuBLAS as the reference leaves them to XLA); the
     rows past the capacity are dropped (GShard semantics) and add
     nothing to their token;
  5. sums each token's gate-weighted expert rows with K5
     (``scatter_add_autograd``: ``scatter_add_launch`` with a gather for
     its backward) straight from the (E·C, d) slots the products leave,
     an empty slot's token id one past the end, which K5 drops: the
     reference's unsort and ``einsum("tkd,tk->td")`` as one segment sum
     of f32 values.

Under autograd (training) every step is differentiable, as the
reference's ``jax.grad`` through ``apply_local``: K7's counts are
integers and need no gradient, the buffer of step 4 is a fresh one whose
zeros autograd never reads, and the combine indexes no expert row: the
gates reach their slots by a write whose backward is a gather, so no
backward adds many rows into one (a gather of the dropped rows from one
clamped slot would, one row after another).

Every launcher runs its plain version for CPU tensors, so the layer runs
on the device its inputs lie on.

Two additions of the port's own, for DeepSeek-V3 (``router="sigmoid"``,
``experts_held``), which the reference lacks:

- the sigmoid router: f32 sigmoid scores of the router's logits; experts
  are chosen on the scores plus a selection bias (``score_bias``, E f32):
  each of ``n_group`` groups of experts scores the sum of its best two,
  the best ``topk_group`` groups are kept, the others' experts masked
  with -inf, and the top k taken among the rest (the lower expert first
  among equal values, as everywhere here); the weights are the chosen
  experts' unbiased scores, normalised to sum to 1, times
  ``routed_scale``.  It has no aux loss (0);
- a card that holds a share of the experts, ``[expert_offset,
  expert_offset + experts_held)``: the router routes over all E, the
  weights hold the share's experts alone, and the layer computes their
  gate-weighted part (and the shared expert's).  A row bound for another
  expert gets the id ``experts_held``, one past the share, which K7 does
  not count and ``slot_map`` sends to the spare slot.  Each held expert's
  capacity is the whole layer's, int(T·k / E · capacity_factor), so that
  the shares of all cards add up to the whole layer.

The layer's stages are functions, each opening one ``telemetry`` span,
a profiler range while the profiler records: ``route`` (``moe.route``,
step 1), ``dispatch`` (``moe.dispatch``: the sort, the gather of x, K7,
the slot map and the buffer's write), ``experts`` (``moe.experts``: the
products), ``combine`` (``moe.combine``: each slot's token and gate, the
gate product, K5 and the cast) and ``_shared`` (``moe.shared``: the
shared experts' MLP, where the layer has one).  While the profiler
records, ``repro_moe_rows_total`` counts the rows routed to an expert and
those kept within capacity at each expert buffer (0-d device tensors
that nothing reads inside the layer).

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
from repro_torch.obs import telemetry
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import P

ROWS = telemetry.counter(
    "repro_moe_rows_total", "MoE rows with an expert id (routed) and "
    "within their expert's capacity (kept), counted while profiling",
    ("outcome",))


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


@dataclasses.dataclass(frozen=True)
class PortMoEConfig(MoEConfig):
    """``MoEConfig`` with the sigmoid router and the expert share
    (DeepSeek-V3's; the reference has neither).  The layer reads these
    fields by ``getattr``, at the defaults here on a ``MoEConfig``."""
    router: str = "softmax"         # or "sigmoid" (module docstring)
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    experts_held: int = 0           # 0: every expert on this card
    expert_offset: int = 0


def init(gen: torch.Generator, cfg: MoEConfig, d_shared: int = 0) -> dict:
    """Router (d, E) and expert weights (E, d, f), (E, f, d), drawn from
    ``gen`` on its device with the reference's fan-in scales; with shared
    experts, their MLP of width ``d_shared`` (default: ``d_expert`` a
    shared expert).  Of a share (``experts_held``) the weights of its
    experts alone; the sigmoid router's selection bias, zero."""
    dt = layers.torch_dtype(cfg.dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_expert
    held = getattr(cfg, "experts_held", 0) or e
    scale_in, scale_out = d ** -0.5, f ** -0.5
    p = {
        "router": layers.dense_init(gen, d, e, dt),
        "w_gate": layers.truncated_normal_init(gen, (held, d, f), scale_in,
                                               dt),
        "w_up": layers.truncated_normal_init(gen, (held, d, f), scale_in, dt),
        "w_down": layers.truncated_normal_init(gen, (held, f, d), scale_out,
                                               dt),
    }
    if getattr(cfg, "router", "softmax") == "sigmoid":
        p["score_bias"] = torch.zeros((e,), dtype=torch.float32,
                                      device=gen.device)
    if cfg.num_shared_experts:
        p["shared"] = mlp.init(gen, d, d_shared or f * cfg.num_shared_experts,
                               dt)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_sigmoid(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """The sigmoid router (module docstring): (gates, ids, aux 0)."""
    scores = torch.sigmoid(x.to(torch.float32)
                           @ p["router"]["w"].to(torch.float32))
    choice = scores + p["score_bias"].to(torch.float32)
    t, e = choice.shape
    if cfg.n_group > 1:
        grouped = choice.view(t, cfg.n_group, e // cfg.n_group)
        best = torch.topk(grouped, 2, dim=-1).values.sum(-1)  # (T, groups)
        dropped = torch.ones_like(best, dtype=torch.bool).scatter_(
            1, _top_k(best, cfg.topk_group)[1], False)
        choice = grouped.masked_fill(dropped[..., None],
                                     float("-inf")).view(t, e)
    ids = _top_k(choice, cfg.top_k)[1]
    gates = scores.gather(1, ids)
    gates = gates / gates.sum(-1, keepdim=True) * cfg.routed_scale
    return gates, ids.to(torch.int32), scores.new_zeros(())


@telemetry.span("moe.route")
def route(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """Router: (gates (T, k) f32, ids (T, k) int32, aux loss scalar)."""
    if getattr(cfg, "router", "softmax") == "sigmoid":
        return _route_sigmoid(p, x, cfg)
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


def _capacity(rows: int, groups: int, cfg: MoEConfig) -> int:
    """GShard's capacity of each of ``groups`` groups for ``rows`` rows."""
    return max(1, int(rows / groups * cfg.capacity_factor))


def _sort(x: torch.Tensor, ids: torch.Tensor, top_k: int):
    """The router's ``ids`` (T, k) as a stream sorted by expert, stably as
    ``jnp.argsort`` (which of an expert's rows overflow its capacity
    depends on that order): (flat ids (T·k,) int32 in issue order, the
    sort's order, the sorted ids, x's rows in sorted order)."""
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    # row i of x repeated k times, taken in sorted order
    xs = x[torch.div(order, top_k, rounding_mode="floor")]
    return flat_ids, order, flat_ids[order], xs


def slot_map(sorted_ids: torch.Tensor, groups: int, capacity: int):
    """Each row of an ascending int32 id stream in a (groups, capacity)
    layout: (slot int64, kept bool).  K7 counts each group's rows; a row
    is kept where its first-come position in its group is below
    ``capacity``, and its slot is ``group · capacity + position``.  A
    dropped row, and one whose id is ``groups`` or more (K7 drops those),
    gets the spare slot ``groups · capacity``, one past the layout."""
    counts = sk.bincount_launch(sorted_ids, groups)          # K7
    start = torch.cumsum(counts, 0) - counts
    sid = sorted_ids.to(torch.int64)
    valid = sid < groups
    pos = torch.arange(sid.shape[0], device=sid.device) - start[
        sid.clamp(max=groups - 1)]
    keep = (pos < capacity) & valid
    return torch.where(keep, sid * capacity + pos, groups * capacity), keep


def _write_slots(rows: torch.Tensor, slot: torch.Tensor, slots: int,
                 fill=0) -> torch.Tensor:
    """``rows`` written at their ``slot`` into a fresh (slots, ...) layout,
    ``fill`` where no row came; the rows at the spare slot land in a row
    past the layout, which is cut off, so that nothing waits on the host
    for the number of kept rows.  Under autograd the rows' gradient is a
    gather (the write does not accumulate)."""
    shape = (slots + 1, *rows.shape[1:])
    buf = rows.new_full(shape, fill) if fill else rows.new_zeros(shape)
    buf.index_put_((slot,), rows)
    return buf[:slots]


def _expert_buffer(xs: torch.Tensor, sorted_ids: torch.Tensor, groups: int,
                   capacity: int) -> dict:
    """The expert-sorted rows ``xs`` (T·k, d) in a (groups, capacity, d)
    buffer, zero where no row came: {"slot", "keep", "buf"}.  While the
    profiler records, ``ROWS`` counts the rows with an expert id and those
    kept."""
    slot, keep = slot_map(sorted_ids, groups, capacity)
    if telemetry.tracing():
        ROWS.inc((sorted_ids < groups).sum(), outcome="routed")
        ROWS.inc(keep.sum(), outcome="kept")
    buf = _write_slots(xs, slot, groups * capacity)
    return {"slot": slot, "keep": keep,
            "buf": buf.view(groups, capacity, xs.shape[1])}


def _slot_buffer(x: torch.Tensor, rows: torch.Tensor,
                 sorted_ids: torch.Tensor, groups: int, capacity: int
                 ) -> dict:
    """``_expert_buffer`` without a copy of the routed rows: each slot of
    the (groups, capacity, d) buffer gathered from x through its token
    (``rows``: each sorted row's), from a zero row past x's where no row
    came, so that neither the (T·k, d) rows nor ``index_put_`` is made.
    Its gradient would be an accumulating index of every slot."""
    slot, keep = slot_map(sorted_ids, groups, capacity)
    if telemetry.tracing():
        ROWS.inc((sorted_ids < groups).sum(), outcome="routed")
        ROWS.inc(keep.sum(), outcome="kept")
    slots = groups * capacity
    tok = torch.full((slots + 1,), x.shape[0], dtype=torch.int64,
                     device=x.device)
    tok[slot] = rows
    buf = torch.cat([x, x.new_zeros((1, x.shape[1]))])[tok[:slots]]
    return {"slot": slot, "keep": keep,
            "buf": buf.view(groups, capacity, x.shape[1])}


def dispatch(x: torch.Tensor, ids: torch.Tensor, cfg: MoEConfig) -> dict:
    """The ``moe.dispatch`` stage: the router's ``ids`` (T, k) sorted by
    expert, K7's counts and the (E, C, d) expert buffer.  Returns {"ids":
    the flat ids (T·k,) int32 in issue order, "order": the sort's, "slot",
    "keep", "buf"}.

    On a card that holds a share of the experts (``experts_held``) the
    ids are first taken into the share, ``experts_held`` for another
    card's expert, and the buffer holds the share's experts at the whole
    layer's capacity.  Without autograd (prefill, decode) the buffer is
    gathered slot by slot from x (``_slot_buffer``): on an H100 at the
    cells' shapes 1.12 against 2.28 ms a layer (8192 tokens, 128 experts,
    top 8, d 4096) and 2.84 against 9.68 (32768, 72, top 10).  Under
    autograd x's rows are taken in sorted order and written into the
    buffer (``_expert_buffer``): that write's backward is a gather, and
    the train step's stage split counts it under ``moe.dispatch``."""
    with telemetry.span("moe.dispatch"):
        held = getattr(cfg, "experts_held", 0)
        flat_ids = ids.reshape(-1)
        local = flat_ids
        if held:
            local = flat_ids - cfg.expert_offset
            local = torch.where((local >= 0) & (local < held), local,
                                held).to(torch.int32)
        order = torch.argsort(local, stable=True)
        sorted_ids = local[order]
        rows = torch.div(order, cfg.top_k, rounding_mode="floor")
        groups = held or cfg.num_experts
        capacity = _capacity(flat_ids.shape[0], cfg.num_experts, cfg)
        if torch.is_grad_enabled() and x.requires_grad:
            sent = _expert_buffer(x[rows], sorted_ids, groups, capacity)
        else:
            sent = _slot_buffer(x, rows, sorted_ids, groups, capacity)
    return dict(sent, ids=flat_ids, order=order)


def experts(p: dict, buf: torch.Tensor, cfg: MoEConfig,
            tp_group=None) -> torch.Tensor:
    """The ``moe.experts`` stage: one batched product per projection over
    the (G, C, d) buffer, the products left in its slots, (G·C, d) in its
    dtype.  With ``tp_group`` the weights are this rank's slice of the
    hidden, and the outputs are summed over the group.  Handed the last
    reference to ``buf``, it frees it before the last product."""
    with telemetry.span("moe.experts"):
        g, c, _ = buf.shape
        if tp_group is not None:
            buf = coll.grad_sum_over(buf, tp_group)
        act, dtype = mlp._ACT[cfg.activation], buf.dtype
        h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        del buf
        y = torch.bmm(h.to(dtype), p["w_down"]).view(g * c, -1)
        del h
        if tp_group is not None:
            y = coll.sum_over(y, tp_group)
    return y


def _expert_ffn_grouped(p: dict, xs: torch.Tensor, sorted_ids: torch.Tensor,
                        num_experts: int, capacity: int, cfg: MoEConfig,
                        tp_group=None) -> torch.Tensor:
    """The reference's function of this name: the expert products of the
    expert-sorted rows ``xs`` (T·k, d), int32 ``sorted_ids``, gathered
    back to the sorted rows, zero for a dropped row and for an id of
    ``num_experts`` or more (the EP body's empty slots, sorted last).
    The EP body needs the rows in sorted order for its unsort and its
    all-to-all back; under autograd the gather's backward adds every
    dropped row's zero into one slot."""
    with telemetry.span("moe.dispatch"):
        sent = _expert_buffer(xs, sorted_ids, num_experts, capacity)
    y = experts(p, sent.pop("buf"), cfg, tp_group)
    with telemetry.span("moe.combine"):
        rows = y[sent["slot"].clamp(max=y.shape[0] - 1)]
        return torch.where(sent["keep"][:, None], rows, 0.0)


def combine_slots(y: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                  order: torch.Tensor, top_k: int, num_tokens: int):
    """K5's inputs in a slot layout (``slot_map``'s): each slot's product
    times its gate, (slots, d) f32, and each slot's token, int32,
    ``num_tokens`` (one past the end, which K5 drops) for an empty slot.

    Sorted row i sits in slot ``slot[i]`` and is entry ``order[i]`` of
    the token-major (T, k) stream, so its token is ``order[i] // k``.
    Both maps are written through ``slot`` without accumulating, the
    dropped rows into a spare entry that is cut off: the gates' gradient
    is then a gather (the backward of ``scatter``), zero for a dropped
    row, and nothing indexes ``y``.
    """
    slots = y.shape[0]
    tok = torch.full((slots + 1,), num_tokens, dtype=torch.int32,
                     device=y.device)
    tok[slot] = torch.div(order, top_k, rounding_mode="floor").to(torch.int32)
    g = gates.new_zeros(slots + 1).scatter(0, slot, gates.reshape(-1)[order])
    return y * g[:slots, None], tok[:slots]


def combine(y: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
            order: torch.Tensor, top_k: int, dtype) -> torch.Tensor:
    """The ``moe.combine`` stage: K5 (``scatter_add_autograd``) sums each
    token's gate-weighted rows, in f32, straight from the slot layout
    ``y`` of the sorted rows' ``slot``; (T, d) in ``dtype`` for the (T, k)
    ``gates``.  Handed the last reference to ``y``, it frees it before
    K5."""
    with telemetry.span("moe.combine"):
        t = gates.shape[0]
        vals, tok = combine_slots(y, slot, gates, order, top_k, t)
        del y
        return sk.scatter_add_autograd(vals, tok, t).to(dtype)


@telemetry.span("moe.shared")
def _shared(p: dict, x: torch.Tensor, cfg: MoEConfig, tp_group):
    """The shared experts' MLP; with ``tp_group`` its weights are this
    rank's slice of the hidden and its output is summed over the group
    (the reference's mesh bodies leave out that sum, and with a model
    axis of more than one rank and shared experts their out-spec, which
    says the output is the same on every model rank, would not hold; of
    the configurations only the port's Granite 4.0-H has a shared
    expert, which the reference lacks)."""
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
    gates, ids, aux = route(p, x, cfg)
    sent = dispatch(x, ids, cfg)
    # each stage is handed the last reference to the buffer or the
    # products it reads, and frees them as soon as they are read
    out = combine(experts(p, sent.pop("buf"), cfg, tp_group), sent["slot"],
                  gates, sent["order"], cfg.top_k, x.dtype)
    if cfg.num_shared_experts:
        out = out + _shared(p, x, cfg, tp_group)
    return out, aux, sent["ids"]


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

    An empty slot of a send buffer carries the expert id ``e_local``, one
    past the end: K7 and ``_expert_ffn_grouped`` count and compute nothing
    for that id.  The rows come back in their send slots, which
    ``combine`` sums as the one-card layer's: an empty slot's token is T,
    one past the end, which K5 drops (as the reference's ``mode="drop"``).
    """
    d_shards = dist.get_world_size(ep_group)
    k = cfg.top_k
    e_local = cfg.num_experts // d_shards
    gates, ids, aux = route(p, x_local, cfg)                  # (T, k)
    with telemetry.span("moe.dispatch"):
        flat_ids, order, sorted_ids, xs = _sort(x_local, ids, k)
        cap = _capacity(flat_ids.shape[0], d_shards, cfg)
        slot, _ = slot_map(torch.div(sorted_ids, e_local,  # by rank (K7)
                                     rounding_mode="floor"), d_shards, cap)
        send_x = _write_slots(xs, slot, d_shards * cap)
        del xs
        send_id = _write_slots(torch.remainder(sorted_ids, e_local).to(
            torch.int32), slot, d_shards * cap, fill=e_local)
    rx = coll.all_to_all(send_x, ep_group)             # (D·cap, d)
    rid = coll.all_to_all(send_id, ep_group)
    order2 = torch.argsort(rid, stable=True)      # empty slots' e_local last
    y = _expert_ffn_grouped(p, rx[order2], rid[order2], e_local,
                            _capacity(rx.shape[0], e_local, cfg), cfg,
                            tp_group)
    y = y[torch.argsort(order2)]                        # unsort locally
    comb_dt = x_local.dtype if cfg.bf16_combine else torch.float32
    # the rows come back in their send slots: the one-card combine
    out = combine(coll.all_to_all(y.to(comb_dt), ep_group), slot, gates,
                  order, k, x_local.dtype)
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
