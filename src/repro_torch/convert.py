"""Carry the model's state across from the reference package, as numpy.

The system has no weights: its state is the service-time table S(n, e, c),
the wave traces the counters come from, and the scatter-unit calibration.
These functions rebuild the port's types from plain arrays and dicts, so
a table or trace made by the reference (``np.savez`` arrays, or its
dataclasses' fields) can be fed to the port — for instance to test the
port's model code apart from its own table build:

    Session("v5e", table=table_from_numpy(np.load(path)))
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np

from repro_torch.core.counters import WaveTrace
from repro_torch.core.qmodel import ServiceTimeTable
from repro_torch.core.timing import ScatterUnitParams


def table_from_numpy(arrays: Mapping) -> ServiceTimeTable:
    """A ``ServiceTimeTable`` from its fields: ``n_grid``, ``e_grid``,
    ``cfrac_grid``, ``T``, ``popc_T``, ``clock_hz`` and ``meta``.

    ``popc_T`` may be absent, None or empty (no POPC samples).  ``meta``
    may be a dict or the JSON string a saved table holds.
    """
    popc = arrays["popc_T"] if "popc_T" in arrays else None
    if popc is not None and np.asarray(popc).size == 0:
        popc = None
    meta = arrays["meta"] if "meta" in arrays else {}
    if not isinstance(meta, dict):
        meta = json.loads(str(meta))
    return ServiceTimeTable(
        n_grid=np.asarray(arrays["n_grid"]),
        e_grid=np.asarray(arrays["e_grid"]),
        cfrac_grid=np.asarray(arrays["cfrac_grid"]),
        T=np.asarray(arrays["T"]),
        popc_T=None if popc is None else np.asarray(popc, np.float64),
        clock_hz=float(arrays["clock_hz"]),
        meta=dict(meta),
    )


def trace_from_numpy(arrays: Mapping) -> WaveTrace:
    """A ``WaveTrace`` from ``degree``, ``job_class``, ``core`` and
    ``lanes_active`` arrays, plus optional ``waves_per_tile`` and
    ``pipeline_depth``."""
    return WaveTrace(
        degree=np.asarray(arrays["degree"]),
        job_class=np.asarray(arrays["job_class"]),
        core=np.asarray(arrays["core"]),
        lanes_active=np.asarray(arrays["lanes_active"]),
        waves_per_tile=int(arrays["waves_per_tile"])
        if "waves_per_tile" in arrays else 1,
        pipeline_depth=int(arrays["pipeline_depth"])
        if "pipeline_depth" in arrays else 2,
    )


def scatter_params_from_dict(d: Mapping) -> ScatterUnitParams:
    """``ScatterUnitParams`` from its fields (e.g. ``dataclasses.asdict``
    of the reference's, or a table's ``meta["params"]``)."""
    return ScatterUnitParams(**dict(d))
