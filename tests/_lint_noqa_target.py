"""A lint target declared in a module that carries an in-source
suppression, for ``tests/test_torch_lint.py``.

K5 at 64 segments of 32 values is on its shared route: an unpadded
shared copy whose rows are 32 values wide, the premise of KERN002.  The
comment below allowlists that rule for every target whose ``module`` is
this one.
"""

import dataclasses
import sys

import numpy as np

# repro: noqa KERN002

SEGMENTS, WIDTH, IDS = 64, 32, 4096


def shared_route_spec(label: str = "scatter_add-shared"):
    from repro_torch.analysis import WorkloadSpec

    ids = np.random.default_rng(0).integers(0, SEGMENTS, IDS).astype(
        np.int32)
    return WorkloadSpec.from_scatter_add(
        ids, np.ones((IDS, WIDTH), np.float32), SEGMENTS, label=label)


def shared_route_target():
    """K5's shared-route launch, its noqa scope this module."""
    from repro_torch.lint import target_from_spec

    return dataclasses.replace(target_from_spec(shared_route_spec()),
                               module=sys.modules[__name__])
