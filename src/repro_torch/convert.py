"""Carry state across from the reference package, as numpy.

The analysis has no weights: its state is the service-time table
S(n, e, c), the wave traces the counters come from, and the scatter-unit
calibration.  These functions rebuild the port's types from plain arrays
and dicts, so a table, trace or counter set made by the reference
(``np.savez`` arrays, or its dataclasses' fields) can be fed to the port —
for instance to test the port's model code apart from its own table
build:

    Session("v5e", table=table_from_numpy(np.load(path)))

The LM substrate does have weights: ``lm_params_from_numpy`` takes a
reference ``CausalLM``'s parameters, as numpy arrays, into the port's
per-layer layout.
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.counters import CounterSet, WaveTrace
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


def counter_set_from_numpy(arrays: Mapping) -> CounterSet:
    """A ``CounterSet`` from its fields (e.g. ``dataclasses.asdict`` of the
    reference's): ``label``, ``O``, ``N_f``, ``N_c``, ``N_p`` and, where
    present, the scalar fields; absent ones keep their defaults."""
    names = ("source", "num_cores", "lanes_active", "num_waves",
             "waves_per_tile", "pipeline_depth", "bytes_read", "flops",
             "ici_bytes", "overhead_cycles", "wall_time_s")
    scalars = {k: arrays[k] for k in names if k in arrays}
    return CounterSet(
        label=str(arrays["label"]),
        O=np.asarray(arrays["O"]), N_f=np.asarray(arrays["N_f"]),
        N_c=np.asarray(arrays["N_c"]), N_p=np.asarray(arrays["N_p"]),
        meta=dict(arrays.get("meta") or {}), **scalars)


def scatter_params_from_dict(d: Mapping) -> ScatterUnitParams:
    """``ScatterUnitParams`` from its fields (e.g. ``dataclasses.asdict``
    of the reference's, or a table's ``meta["params"]``)."""
    return ScatterUnitParams(**dict(d))


def _tensor(a, device) -> torch.Tensor:
    """A tensor of a numpy array; bfloat16 arrays (ml_dtypes) go through
    their bits, which torch cannot read as such."""
    a = np.array(a)  # a writable copy: the reference's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def lm_params_from_numpy(params: Mapping, cfg, device="cuda") -> dict:
    """The port's ``CausalLM`` parameters from the reference's.

    ``params`` is the reference's ``CausalLM.init`` output passed through
    ``jax.tree.map(np.asarray, ...)``.  Its layers are stacked along a
    leading group axis (``params["groups"]["sub0"]``); the port keeps one
    dict per layer, so that axis is unstacked, the same for every leaf:
    a dense layer's ``ffn`` (``w_gate``, ``w_up``, ``w_down``) and an MoE
    layer's (``router: {w}``, ``w_gate``, ``w_up``, ``w_down`` and, with
    shared experts, ``shared``) alike.  Only the plan of one ``"attn"``
    sub-block per group is carried, as only it is served.
    """
    groups = params["groups"]
    if (set(groups) != {"sub0"} or params.get("tail")
            or "shared_attn" in params):
        raise NotImplementedError(
            "only the dense layer plan is ported (ROADMAP queue 1, "
            "\"gemma2\", \"VLM and Whisper\", \"rwkv6 and mamba2\")")
    out = {k: _tree(params[k], lambda a: _tensor(a, device))
           for k in ("embed", "final_norm", "lm_head") if k in params}
    out["layers"] = [
        _tree(groups["sub0"], lambda a, i=i: _tensor(a[i], device))
        for i in range(cfg.num_layers)]
    return out
