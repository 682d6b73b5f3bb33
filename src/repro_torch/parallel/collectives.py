"""Per-rank code inside a mesh: the boundary between DTensors and each
rank's local shard, and the collectives a local body runs, with the
gradients the reference's ``shard_map`` bodies get from ``jax.grad``.

``to_local`` takes a DTensor (or a plain tensor, the same on every rank)
to this rank's shard of a spec; under autograd the shard's gradient
leaves as a partial sum over the axes named, where the tensor is
replicated but each rank uses it on other data (other tokens).
``from_local`` wraps a body's result as a DTensor of a spec.  Between
them, ``sum_over`` sums a value over a group that every rank then uses
alike (its gradient passes through), ``grad_sum_over`` marks a value
that enters a product whose weights are split over a group (its
gradient is summed there), ``mean_over`` is the mean of a per-rank value
over groups, and ``all_to_all`` exchanges equal blocks (the gradient
goes back the same way).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.sharding import P, to_placements


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        x = x.clone()
        n = 1
        for g in groups:
            dist.all_reduce(x, group=g)
            n *= dist.get_world_size(g)
        ctx.n = n
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, which each of them
    then uses alike (the reference's ``psum``)."""
    return _SumOver.apply(x, group)


def grad_sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, entering a product whose weights are split over ``group``:
    each rank's gradient is a part, summed over the group."""
    return _GradSumOver.apply(x, group)


def mean_over(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of each rank's ``x`` over the ranks of ``groups``
    together (the reference's ``pmean``): each rank's gradient is its
    share of the mean's."""
    return _MeanOver.apply(x, list(groups))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of dim 0 of ``x`` to rank i of ``group``; block j of the
    result from rank j (differentiable)."""
    out = torch.empty_like(x)
    if x.requires_grad and torch.is_grad_enabled():
        return dist_fn.all_to_all_single(out, x.contiguous(), group=group)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def to_local(x, mesh, spec: P, partial_axes=()) -> torch.Tensor:
    """This rank's shard of ``x`` placed by ``spec`` on ``mesh``; ``x`` a
    DTensor, or a plain tensor the same on every rank.  Under autograd the
    shard's gradient is a partial sum over each of ``partial_axes`` where
    ``spec`` replicates ``x``."""
    placements = to_placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    names = mesh.mesh_dim_names
    grad = [Partial() if names[j] in partial_axes
            and isinstance(pl, Replicate) else pl
            for j, pl in enumerate(placements)]
    return x.to_local(grad_placements=grad)


def from_local(x: torch.Tensor, mesh, spec: P) -> DTensor:
    """``x``, this rank's shard, as a DTensor placed by ``spec``."""
    return DTensor.from_local(x, mesh, to_placements(spec, mesh),
                              run_check=False)


def per_head(fn, args, dims, out_dims):
    """``fn(*args)`` on each rank's local shard, for a computation that is
    independent per sequence and per head (attention, RWKV's WKV,
    Mamba-2's SSD).  ``dims`` gives each argument's kind and head dim:
    ``("act", h)`` an activation with the batch at dim 0 (``h`` None: no
    head dim), ``("param", h)`` a parameter.  Under a mesh (a DTensor
    among ``args``) the batch is sharded over the data axes where it
    divides and the heads over the model axis where every head count
    divides, everything else whole; the results, activations with their
    heads at ``out_dims`` (an int: one result), come back as DTensors.
    Under autograd a parameter's local gradient is a partial sum over the
    data axes (each rank's own tokens), and an activation without heads a
    partial sum over the model axis (each rank's own heads).  DTensor
    has no rule for these computations' views of a sharded head dim."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    ctx = pctx.current()
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    tp = pctx.axis_size(mesh, ctx.tp_axis)
    heads = ctx.tp_axis if all(a.shape[h] % tp == 0 for a, (_, h)
                               in zip(args, dims) if h is not None) else None
    batch = next(a.shape[0] for a, (kind, _) in zip(args, dims)
                 if kind == "act")
    lead = pctx.batch_axes_for(ctx, batch)

    def spec(ndim, kind, h):
        entries = [None] * ndim
        if kind == "act":
            entries[0] = lead
        if h is not None:
            entries[h] = heads
        return P(*entries)

    local = []
    for a, (kind, h) in zip(args, dims):
        partial = ((ctx.data_axes if kind == "param" and lead else ())
                   + ((ctx.tp_axis,) if h is None and heads else ()))
        local.append(to_local(a, mesh, spec(a.ndim, kind, h), partial))
    out = fn(*local)
    if isinstance(out_dims, int):
        return from_local(out, mesh, spec(out.ndim, "act", out_dims))
    return tuple(from_local(o, mesh, spec(o.ndim, "act", h))
                 for o, h in zip(out, out_dims))


def write_slice(buf, x, start: int, dim: int) -> None:
    """``buf[start:start + n]`` along ``dim`` = ``x`` (n = its length
    there), in place.  A DTensor ``buf`` keeps its placements: ``x`` is
    brought to them with ``dim`` whole on every rank, and each rank
    writes into its own shard the part of the slice that falls there (the
    reference's ``dynamic_update_slice`` of a sharded cache)."""
    if not isinstance(buf, DTensor):
        buf.narrow(dim, start, x.shape[dim]).copy_(x)
        return
    mesh, placements = buf.device_mesh, buf.placements
    whole = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
             for pl in placements]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x_local = x.redistribute(mesh, whole).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, placements)
    lo = max(start, offset[dim])
    hi = min(start + x.shape[dim], offset[dim] + shape[dim])
    if lo < hi:
        buf.to_local().narrow(dim, lo - offset[dim], hi - lo).copy_(
            x_local.narrow(dim, lo - start, hi - lo))
