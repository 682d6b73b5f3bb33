"""Placements for every parameter, state, batch and cache tree.

The reference's ``repro/parallel/sharding.py``: 2-D weight sharding, the
TP dim over ``model`` and the other big dim over ``data`` (FSDP-style),
the batch over ``(pod, data)``, experts EP-sharded over ``data`` (whole
experts) and TP over ``model`` (the expert hidden) for 64 experts or
more, KV caches sequence-sharded over ``model``.

Specs are assigned by parameter *path name*, as in the reference.  The
reference stacks each scanned layer's leaves along a leading axis
(``params["groups"]``); the port keeps one dict per layer, so a port
leaf has one dimension fewer.  Every rule sets the spec of a leaf's last
dimensions and leaves the leading ones replicated, so a port leaf's spec
is the reference's spec of the same leaf without its leading ``None``;
the rules read that from the port's own paths and shapes.

``P`` is the port's ``PartitionSpec``: one entry per dimension from the
first, each ``None``, an axis name or a tuple of names; ``tuple(P(...))``
equals ``tuple`` of the reference's spec of the same entries.
``to_placements`` turns a spec into DTensor placements on a
``DeviceMesh``: a dimension over two axes, ``("pod", "data")``, is
``Shard(dim)`` on both mesh dimensions, the outer one first, as a
``PartitionSpec`` splits it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import tree

# parent-key name -> (spec for 2D weight)
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "lm_head", "cm_k",
                 "cm_r", "wr", "wg", "in_proj", "mix_a", "decay_a"}
_ROW_PARALLEL = {"wo", "w_down", "cm_v", "out_proj", "decay_b"}


def _entry(e):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a
    tuple of one axis is that axis."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P:
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements, one per mesh dimension, of ``spec``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        prev = -1
        for axis in _axes(entry):
            if axis not in names:
                raise ValueError(f"{spec}: no axis {axis!r} in the mesh "
                                 f"{names}")
            j = names.index(axis)
            if not isinstance(out[j], Replicate):
                raise ValueError(f"{spec}: axis {axis!r} used twice")
            if j < prev:
                raise ValueError(f"{spec}: axes {_axes(entry)} not in the "
                                 f"mesh's order {names}")
            out[j] = Shard(dim)
            prev = j
    # on a mesh dimension of one rank a shard is the whole tensor: the
    # same layout as Replicate, which DTensor takes through every view
    # (it refuses to merge a dimension of size 1 sharded there)
    return tuple(Replicate() if mesh.size(j) == 1 else pl
                 for j, pl in enumerate(out))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def distribute(values, shardings):
    """Each leaf of ``values`` (plain tensors, all of them on every rank,
    or DTensors) as a DTensor placed by the matching leaf of
    ``shardings``."""
    def place(x, sh):
        if isinstance(x, DTensor):
            return x.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(x.to(sh.mesh.device_type), sh.mesh,
                                 sh.placements)
    return tree.map(place, values, shardings)


def param_spec_for_path(path, leaf, cfg) -> P:
    """The spec of the parameter at ``path`` (keys and list indices, as
    strings) of the port's tree."""
    names = [str(k) for k in path]
    nd = getattr(leaf, "ndim", 0)
    in_moe_ep = cfg.is_moe and cfg.num_experts >= 64  # EP for big-E archs

    if "embed" in names and names[-1] == "table":
        return P("model", "data")
    if names and names[-1] == "b":
        # bias: TP-shard the feature dim only, and only for
        # column-parallel parents (row-parallel outputs are replicated
        # after the reduce)
        for name in reversed(names):
            if name in _COL_PARALLEL:
                return P(*(None,) * (nd - 1), "model")
            if name in _ROW_PARALLEL:
                return P()
        return P()
    # MoE expert weights: a leading E dim, sharded over data for EP
    if names and names[-1] in ("w_gate", "w_up") and nd >= 3 and cfg.is_moe \
            and "shared" not in names:
        e_ax = "data" if in_moe_ep else None
        return P(*(None,) * (nd - 3), e_ax, None, "model")
    if names and names[-1] == "w_down" and nd >= 3 and cfg.is_moe \
            and "shared" not in names:
        e_ax = "data" if in_moe_ep else None
        return P(*(None,) * (nd - 3), e_ax, "model", None)
    for name in reversed(names):
        if name in _COL_PARALLEL:
            if nd >= 2:
                return P(*(None,) * (nd - 2), "data", "model")
            if nd == 1 and names[-1] == "b":
                return P("model")
            return P()
        if name in _ROW_PARALLEL:
            if nd >= 2:
                return P(*(None,) * (nd - 2), "model", "data")
            return P()
    return P()  # norms, scalars, router, conv, biases of row-parallel


def param_pspecs(params, cfg):
    return tree.map_with_path(
        lambda path, leaf: param_spec_for_path(path, leaf, cfg), params)


def shardings_of(specs, mesh):
    """A tree of ``NamedSharding`` of a tree of specs."""
    return tree.map(lambda s: NamedSharding(mesh, s), specs)


def param_shardings(params, cfg, mesh):
    return shardings_of(param_pspecs(params, cfg), mesh)


# -- inputs / caches ---------------------------------------------------------


def batch_pspecs(batch_tree, data_axes=("pod", "data")):
    def spec(path, leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd == 0:
            return P()
        return P(data_axes, *(None,) * (nd - 1))
    return tree.map_with_path(spec, batch_tree)


def cache_pspecs(cache_tree, cfg, data_axes=("pod", "data"),
                 seq_axis: Optional[str] = "model"):
    """KV caches: batch over the data axes, *sequence* over the model
    axis (the flash-decode layout: any KV head count, and it spreads the
    32k/500k caches).  SSM states: batch over data, heads over model."""
    del cfg  # the reference's signature; the rules read names and ranks

    def spec(path, leaf):
        nd = getattr(leaf, "ndim", 0)
        name = str(path[-1]) if path else ""
        if name in ("xk", "xv") and nd >= 4:
            # cross-attention K/V: a short frozen source — replicate it,
            # shard the batch only
            return P(*(None,) * (nd - 4), data_axes, None, None, None)
        if name in ("k", "v") and nd >= 4:
            return P(*(None,) * (nd - 4), data_axes, None, seq_axis, None)
        if name in ("s", "h") and nd >= 4:   # rwkv/mamba states (B,H,...)
            return P(*(None,) * (nd - 4), data_axes, seq_axis, None, None)
        if name == "conv" and nd >= 3:       # (B, W-1, conv_dim)
            return P(*(None,) * (nd - 3), data_axes, None, None)
        if name in ("last", "cm_last") and nd >= 2:
            return P(*(None,) * (nd - 2), data_axes, None)
        return P()

    return tree.map_with_path(spec, cache_tree)


def opt_state_pspecs(opt_state, params_specs):
    """AdamW state: m/v/master mirror the param specs; scalars
    replicated."""
    del opt_state
    return {"m": params_specs, "v": params_specs, "master": params_specs,
            "count": P()}
