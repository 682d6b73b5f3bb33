"""Shared step-capture helpers for the dry-run grid and the static audit.

The reference's ``repro/launch/lowering.py`` lowers a (config x shape)
step to HLO with ``jax.jit(...).lower``.  ``build_captured`` is its
counterpart: it builds the train, prefill or decode step for a shape
kind, places the meta stand-ins of ``launch/specs.py`` on the mesh as
DTensors, and captures the step under the mesh context
(``launch/capture.py``) without running a kernel or holding a byte of a
weight.

A capture takes one microbatch of a train step and one group of the
layer plan (the reference's scan body, and the tail after it): the loop
markers carry the real trip counts, so that a site's depth and trips are
the reference's and FLOPs, bytes and collectives scale by them.  The
caller sets up the process group the mesh is built on (the audit's
``zoo`` uses a one-rank ``fake`` group, the dry run one of 256 or 512).
"""

from __future__ import annotations

import dataclasses

from torch.distributed.tensor import distribute_tensor

from repro_torch import tree
from repro_torch.launch import capture as capture_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import data_axes_of, mesh_chips
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import layer_plan
from repro_torch.optim import adamw
from repro_torch.parallel import ctx as pctx
from repro_torch.serve import step as serve_mod
from repro_torch.train import step as train_mod

# ---------------------------------------------------------------------------
# Per (arch, shape) config overrides, applied on top of the baseline: the
# reference's hillclimb variants.
# ---------------------------------------------------------------------------
OPTIMIZATIONS: dict[tuple[str, str], dict] = {
    ("command-r-plus-104b", "train_4k"): dict(
        attn_tp_expand=True, train_constrain_grad_sharding=True,
        attn_bf16_score_grad=True),
    ("gemma2-27b", "train_4k"): dict(
        attn_tp_expand=True, train_constrain_grad_sharding=True,
        attn_bf16_score_grad=True),
    ("qwen3-moe-235b-a22b", "train_4k"): dict(
        attn_tp_expand=True, train_constrain_grad_sharding=True,
        moe_bf16_combine=True),
}


def shape_tuned_config(cfg, shape, variant: str = "base"):
    """Per-shape implementation knobs: (config, loss_chunk, train
    keywords)."""
    kw = {}
    if shape.kind == "prefill" and shape.seq_len >= 32768 \
            and not cfg.rwkv and cfg.family != "ssm":
        kw["attn_impl"] = "blockwise"
        kw["kv_block"] = 1024
    if cfg.vocab_size >= 100_000 and shape.kind == "train":
        kw["loss_chunk"] = 455  # divides 4095; keeps f32 logits ~0.5 GiB/dev
    if variant == "opt":
        kw.update(OPTIMIZATIONS.get((cfg.name, shape.name), {}))
    loss_chunk = kw.pop("loss_chunk", 0)
    train_kw = {k[len("train_"):]: kw.pop(k) for k in list(kw)
                if k.startswith("train_")}
    return dataclasses.replace(cfg, **kw) if kw else cfg, loss_chunk, train_kw


def capture_depth(cfg):
    """(the config cut to one group of its layer plan and its tail, the
    loop trips of the whole one)."""
    if cfg.family == "audio":
        return (dataclasses.replace(cfg, num_layers=1, encoder_layers=1),
                {"enc": cfg.encoder_layers, "dec": cfg.num_layers})
    plan = layer_plan(cfg)
    tail = len(plan.tail_kinds)
    per_group = (cfg.num_layers - tail) // plan.n_groups
    return (dataclasses.replace(cfg, num_layers=per_group + tail),
            {"layers": plan.n_groups})


def _placed(values, shardings):
    """Meta stand-ins as DTensors on their shardings' mesh."""
    return tree.map(lambda x, sh: distribute_tensor(x, sh.mesh,
                                                    sh.placements),
                    values, shardings)


def build_captured(cfg, shape, mesh, *, loss_chunk: int = 0,
                   train_kw: dict | None = None, label: str = ""
                   ) -> capture_mod.Capture:
    """Capture the step for ``shape.kind`` under ``mesh``.

    ``cfg`` must already carry any shape-tuned overrides (see
    ``shape_tuned_config``).  The capture's ``meta`` holds the step kind,
    the microbatches and the loop trips.
    """
    daxes = data_axes_of(mesh)
    small, trips = capture_depth(cfg)
    model = build_model(small, "meta")
    chips = mesh_chips(mesh)
    label = label or f"{cfg.name}/{shape.name}"
    meta = {"kind": shape.kind, "trips": dict(trips)}
    with pctx.use_mesh(mesh, data_axes=daxes, tp_axis="model"):
        if shape.kind == "train":
            num_data = pctx.axes_size(mesh, daxes)
            accum = max(1, shape.global_batch // num_data)
            tcfg = train_mod.TrainConfig(accum_steps=accum,
                                         loss_chunk=loss_chunk,
                                         **(train_kw or {}))
            step = train_mod.make_train_step(model, tcfg,
                                             adamw.AdamWConfig())
            state, state_sh = specs_mod.state_specs(model, mesh)
            batch, batch_sh = specs_mod.train_batch_specs(small, shape, mesh)
            meta["accum"] = accum
            cap = capture_mod.capture(
                step, _placed(state, state_sh), _placed(batch, batch_sh),
                label=label, trips=trips, chips=chips)
        elif shape.kind == "prefill":
            prefill = serve_mod.make_prefill(
                model, serve_mod.ServeConfig(max_len=shape.seq_len))
            params, params_sh = specs_mod.param_specs(model, mesh)
            inputs, inputs_sh = specs_mod.prefill_specs(small, shape, mesh)
            inputs = _placed(inputs, inputs_sh)
            tokens = inputs.pop("tokens")
            cap = capture_mod.capture(
                prefill, _placed(params, params_sh), tokens, inputs or None,
                label=label, trips=trips, chips=chips, grad=False)
        else:
            decode = serve_mod.make_decode_step(model)
            params, params_sh = specs_mod.param_specs(model, mesh)
            cache, cache_sh, tokens, tokens_sh, _ = specs_mod.decode_specs(
                small, shape, model, mesh, params)
            tokens = distribute_tensor(tokens, mesh, tokens_sh.placements)
            cap = capture_mod.capture(
                decode, _placed(params, params_sh), _placed(cache, cache_sh),
                tokens, shape.seq_len - 1, label=label, trips=trips,
                chips=chips, grad=False)
    cap.meta.update(meta)
    return cap

