"""Distribution context: the mesh and axis names the models shard against.

The reference's ``repro/parallel/ctx.py`` on ``torch.distributed``: a
``MeshCtx`` holds a ``DeviceMesh`` with the reference's axis names, set
by ``use_mesh`` for the process, where the reference keeps it in a
thread-local: autograd runs a CUDA backward on threads of its own, and
a remat layer's recompute there must take the same mesh paths as its
forward did.  The models stay functions of their
parameters; under a mesh the parameters are DTensors
(``parallel/sharding.py``), the batch is sharded over the data axes, and
the hints below redistribute an activation to the reference's layout,
the counterpart of its ``with_sharding_constraint``.  With no mesh set,
or on a plain tensor, every hint returns its input.

Inside ``use_mesh`` a plain tensor that meets a DTensor (RoPE tables,
masks, positions, constants) is taken as replicated
(``implicit_replication``): every rank builds the same one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.parallel.sharding import P, to_placements


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: object                       # torch DeviceMesh
    data_axes: tuple[str, ...]         # batch-sharding axes (incl. pod)
    tp_axis: str                       # tensor-parallel axis
    seq_axis: Optional[str] = None     # sequence-parallel axis (long ctx)

    @property
    def batch_spec(self) -> P:
        return P(self.data_axes)

    @property
    def num_data_shards(self) -> int:
        return axes_size(self.mesh, self.data_axes)


_current: Optional[MeshCtx] = None


def current() -> Optional[MeshCtx]:
    return _current


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh dimension named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


@contextlib.contextmanager
def use_mesh(mesh, data_axes=("data",), tp_axis: str = "model",
             seq_axis: Optional[str] = None):
    global _current
    prev = _current
    _current = MeshCtx(mesh=mesh, data_axes=tuple(data_axes),
                       tp_axis=tp_axis, seq_axis=seq_axis)
    try:
        with implicit_replication():
            yield _current
    finally:
        _current = prev


def _constrain(x, spec):
    ctx = current()
    placements = to_placements(spec, ctx.mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(ctx.mesh, placements)


def _active(x) -> bool:
    return current() is not None and isinstance(x, DTensor)


def constrain(x, spec: P):
    """Redistribute ``x`` to ``spec`` on the mesh when one is set."""
    if not _active(x):
        return x
    return _constrain(x, spec)


def unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``.  Where ``x`` is a DTensor sharded on
    ``dim`` over a mesh axis that does not divide ``sizes[0]`` (reduced
    widths: 2 heads over 4 ranks), the dim is gathered first: DTensor
    cannot split it in place."""
    if isinstance(x, DTensor):
        d = dim % x.ndim
        mesh = x.device_mesh
        if any(isinstance(pl, Shard) and pl.dim == d
               and sizes[0] % mesh.size(j)
               for j, pl in enumerate(x.placements)):
            x = x.redistribute(mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim == d else pl
                for pl in x.placements])
    return x.unflatten(dim, sizes)


def shard(x, *spec):
    """Redistribute ``x`` to ``P(*spec)`` on the mesh when one is set."""
    return constrain(x, P(*spec))


def shard_batch(x):
    """Shard the leading (batch) dim over the data axes (skip if it does
    not divide, e.g. the batch=1 long-context decode cells)."""
    if not _active(x):
        return x
    ctx = current()
    n = axes_size(ctx.mesh, ctx.data_axes)
    if x.shape[0] % n or x.shape[0] < n:
        return x
    return _constrain(x, P(ctx.data_axes, *(None,) * (x.ndim - 1)))


def batch_axes_for(ctx: MeshCtx, batch: int):
    """The data axes where ``batch`` rows divide over them, else None."""
    nb = axes_size(ctx.mesh, ctx.data_axes)
    return ctx.data_axes if (batch % nb == 0 and batch >= nb) else None


def _lead(ctx, x):
    return batch_axes_for(ctx, x.shape[0])


def shard_heads(x, head_axis: int = 1):
    """(B, H, T, hd)-shaped tensors: batch over the data axes, heads over
    the TP axis (skipped when H does not divide)."""
    if not _active(x):
        return x
    ctx = current()
    tp = axis_size(ctx.mesh, ctx.tp_axis)
    if x.shape[head_axis] % tp or x.shape[head_axis] < tp:
        return x
    spec = [None] * x.ndim
    spec[0] = _lead(ctx, x)
    spec[head_axis] = ctx.tp_axis
    return _constrain(x, P(*spec))


def shard_batch_tp(x):
    """Batch over the data axes and the LAST dim over the TP axis: the
    projection outputs (q/k/v, FFN hidden, logits), so that the layer's
    products stay tensor-parallel."""
    if not _active(x):
        return x
    ctx = current()
    tp = axis_size(ctx.mesh, ctx.tp_axis)
    if x.shape[-1] % tp or x.shape[-1] < tp:
        return x
    return _constrain(x, P(_lead(ctx, x), *(None,) * (x.ndim - 2),
                           ctx.tp_axis))
