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
reference ``CausalLM``'s parameters, and ``whisper_params_from_numpy`` a
``WhisperModel``'s, as numpy arrays, into the port's per-layer layout.
``lm_params_to_numpy`` and ``whisper_params_to_numpy`` are their
inverses, for any tree of the parameters' structure (gradients, AdamW's
m, v and master), so that the port's training state can be held against
the reference's leaf by leaf.
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.counters import CounterSet, WaveTrace
from repro_torch.core.qmodel import ServiceTimeTable
from repro_torch.core.timing import ScatterUnitParams
from repro_torch.models.transformer import layer_plan


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


def _unstack(stacked, n: int, device) -> list:
    """A tree whose leaves carry a leading axis of ``n`` -> ``n`` trees."""
    return [tree.map(lambda a, i=i: _tensor(a[i], device), stacked)
            for i in range(n)]


def lm_params_from_numpy(params: Mapping, cfg, device="cuda") -> dict:
    """The port's ``CausalLM`` parameters from the reference's.

    ``params`` is the reference's ``CausalLM.init`` output passed through
    ``jax.tree.map(np.asarray, ...)``.  Its layers are stacked along a
    leading group axis, one stack for each sub-block of the group
    (``params["groups"][f"sub{i}"]``); the port keeps one dict per layer,
    layer ``g * k + i`` being group ``g``'s sub-block ``i`` of ``k``, so
    each stack is unstacked, the same for every leaf: a dense layer's
    ``ffn`` (``w_gate``, ``w_up``, ``w_down``), an MoE layer's
    (``router: {w}``, ``w_gate``, ``w_up``, ``w_down`` and, with shared
    experts, ``shared``), gemma2's local and global pair, llama-vision's
    cross layers with their scalar gates, an RWKV layer's ``mix`` and a
    Mamba layer's ``ssm`` alike, each leaf in its own dtype (the f32
    ``decay_base``, ``bonus``, ``a_log``, ``dt_bias`` and ``d_skip`` stay
    f32 in a bf16 model).  zamba2's ``shared_attn`` sub-block has no
    stack: its one dict, ``params["shared_attn"]``, is carried once, as
    the port's ``params["shared_attn"]``, and its layers' entries are
    empty dicts.  ``params["tail"]`` (a list, one dict per layer) follows
    the groups as the last layers, in order.
    """
    plan = layer_plan(cfg)
    k = len(plan.group_kinds)
    groups = params["groups"]
    stacked = [i for i, kind in enumerate(plan.group_kinds)
               if kind != "shared_attn"]
    if set(groups) != {f"sub{i}" for i in stacked}:
        raise ValueError(f"groups {sorted(groups)} do not match the plan "
                         f"{plan.group_kinds}")
    if len(params.get("tail", ())) != len(plan.tail_kinds):
        raise ValueError(f"{len(params.get('tail', ()))} tail layers for "
                         f"the plan's {plan.tail_kinds}")

    def tensors(t):
        return tree.map(lambda a: _tensor(a, device), t)

    out = {key: tensors(params[key])
           for key in ("embed", "final_norm", "lm_head", "shared_attn")
           if key in params}
    subs = {i: _unstack(groups[f"sub{i}"], plan.n_groups, device)
            for i in stacked}
    out["layers"] = [subs[i][g] if i in subs else {}
                     for g in range(plan.n_groups) for i in range(k)]
    out["layers"] += [tensors(p) for p in params.get("tail", ())]
    return out


def whisper_params_from_numpy(params: Mapping, cfg, device="cuda") -> dict:
    """The port's ``WhisperModel`` parameters from the reference's
    (``WhisperModel.init`` through ``jax.tree.map(np.asarray, ...)``):
    ``enc_blocks`` and ``dec_blocks``, stacked along a leading layer axis
    there, become per-layer lists."""
    out = {key: tree.map(lambda a: _tensor(a, device), params[key])
           for key in ("embed", "enc_norm", "dec_norm")}
    out["enc_blocks"] = _unstack(params["enc_blocks"], cfg.encoder_layers,
                                 device)
    out["dec_blocks"] = _unstack(params["dec_blocks"], cfg.num_layers, device)
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor; bf16 comes back as f32 holding the same
    values (numpy has no bf16, and the port reads no ``ml_dtypes``)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def _stack(trees: list, stack=None) -> dict:
    """``n`` trees of one structure -> one tree whose leaves carry a
    leading axis of ``n`` (``_unstack``'s inverse); ``stack`` joins the
    ``n`` leaves of one place (default: ``np.stack`` of their arrays)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    if stack is not None:
        return stack(trees)
    return np.stack([_array(t) for t in trees])


def lm_params_to_numpy(params: Mapping, cfg) -> dict:
    """The reference's ``CausalLM`` layout, as numpy, of the port's
    parameters (or of any tree of their structure): the inverse of
    ``lm_params_from_numpy``.  Each group's sub-block ``i`` is stacked
    over the groups into ``groups[f"sub{i}"]``, zamba2's shared block
    stays one dict and the tail's layers a list."""
    return lm_tree_to_reference(params, cfg, _array, None)


def lm_tree_to_reference(params: Mapping, cfg, leaf, stack) -> dict:
    """``lm_params_to_numpy`` for any leaves: ``leaf`` maps a leaf that
    stays one (the embedding, the norms, the shared block, the tail's),
    ``stack`` the list of a sub-block's leaves over the groups to the
    reference's stacked leaf (None: ``np.stack``)."""
    plan = layer_plan(cfg)
    k = len(plan.group_kinds)
    lay = params["layers"]
    if len(lay) != plan.n_groups * k + len(plan.tail_kinds):
        raise ValueError(f"{len(lay)} layers for the plan {plan}")
    out = {key: tree.map(leaf, params[key])
           for key in ("embed", "final_norm", "lm_head", "shared_attn")
           if key in params}
    out["groups"] = {
        f"sub{i}": _stack([lay[g * k + i] for g in range(plan.n_groups)],
                          stack)
        for i, kind in enumerate(plan.group_kinds) if kind != "shared_attn"}
    if plan.tail_kinds:
        out["tail"] = [tree.map(leaf, p) for p in lay[plan.n_groups * k:]]
    return out


def whisper_params_to_numpy(params: Mapping, cfg) -> dict:
    """The reference's ``WhisperModel`` layout, as numpy, of the port's
    parameters (or of any tree of their structure): the inverse of
    ``whisper_params_from_numpy``."""
    if (len(params["enc_blocks"]), len(params["dec_blocks"])) != (
            cfg.encoder_layers, cfg.num_layers):
        raise ValueError(f"{len(params['enc_blocks'])} + "
                         f"{len(params['dec_blocks'])} blocks for "
                         f"{cfg.encoder_layers} + {cfg.num_layers} layers")
    return whisper_tree_to_reference(params, cfg, _array, None)


def whisper_tree_to_reference(params: Mapping, cfg, leaf, stack) -> dict:
    """``whisper_params_to_numpy`` for any leaves (as
    ``lm_tree_to_reference``)."""
    out = {key: tree.map(leaf, params[key])
           for key in ("embed", "enc_norm", "dec_norm")}
    out["enc_blocks"] = _stack(params["enc_blocks"], stack)
    out["dec_blocks"] = _stack(params["dec_blocks"], stack)
    return out


def params_on_mesh(params, cfg, mesh) -> dict:
    """``params`` (plain tensors, the same on every rank: carried across
    by ``lm_params_from_numpy`` or ``whisper_params_from_numpy``) as
    DTensors on ``mesh``, each placed by ``parallel.sharding``."""
    from repro_torch.parallel import sharding as shd
    return shd.distribute(params, shd.param_shardings(params, cfg, mesh))
