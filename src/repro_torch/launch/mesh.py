"""Mesh construction: the reference's ``repro/launch/mesh.py`` on
``torch.distributed``.

Every function builds from the default process group, which the caller
sets up first (``torch.distributed.init_process_group``, with one rank a
device of the mesh); importing this module touches no device and no
group.  A mesh's axis names are the reference's; ``device_type``
defaults to the card.
"""

from __future__ import annotations

import math

from torch.distributed.device_mesh import init_device_mesh


def compat_make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with the axis names ``axes`` over the
    default group's ranks, in order."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: a group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device_type)


def make_host_mesh(shape=(2, 4), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh over the group's ranks (tests)."""
    return compat_make_mesh(shape, axes, device_type)


def data_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_chips(mesh) -> int:
    return math.prod(mesh.shape)
