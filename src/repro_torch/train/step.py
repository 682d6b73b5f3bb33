"""Training step: microbatched gradient accumulation in f32, remat,
optional compression of the gradients to a wire dtype, AdamW update: the
reference's ``train/step.py`` on one card.

``make_train_step(model, tcfg, ocfg)`` returns ``step(state, batch) ->
(new_state, metrics)``.  The gradients come from ``torch.autograd.grad``
over the parameter tree; under grad, attention takes K8's forward with
its backward where ``attention.flash_route`` allows (bf16 at head_dim 64
or 128) and the plain ``_sdpa`` otherwise, and an MoE layer's combine is
K5 under autograd.  The microbatch loop is a Python loop over
slices of the global batch, the reference's ``lax.scan``, so that the
activations of one microbatch are live at a time.  ``update`` writes the
optimizer state in place (``optim/adamw.py``).

Under a mesh (``parallel.ctx.use_mesh``) the state's leaves are DTensors
placed by ``parallel/sharding.py`` and the batch is sharded over the data
axes; the step is the same code.  ``constrain_grad_sharding`` pins each
microbatch's gradients to the parameters' placements (the reference's
``with_sharding_constraint``: a reduce-scatter of each microbatch's
gradients instead of a replicated accumulator); without a mesh it does
nothing, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.models import layers, loops
from repro_torch.obs import telemetry
from repro_torch.optim import adamw
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    loss_chunk: int = 0          # sequence-chunked xent (0 = off)
    grad_dtype: str = "bfloat16"  # wire dtype of the gradients
    compress_grads: bool = False  # cast the f32-accumulated gradients to
                                  # grad_dtype before the update
    constrain_grad_sharding: bool = False  # pin each microbatch's
                                  # gradients to the parameters' placements


def make_loss_fn(model, tcfg: TrainConfig):
    """``loss_fn(params, micro_batch) -> (loss, {"xent", "aux"})``."""
    def loss_fn(params, micro_batch):
        return model.loss(params, micro_batch, loss_chunk=tcfg.loss_chunk)
    return loss_fn


def make_grad_fn(model, tcfg: TrainConfig):
    """``grad_fn(params, batch) -> (grads, metrics)``: the loss's gradient
    with respect to every leaf of ``params``, in the leaf's dtype (zeros
    for a leaf the loss does not reach), and the loss's metrics,
    detached."""
    loss_fn = make_loss_fn(model, tcfg)

    def grad_fn(params, batch):
        live = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree.unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return (tree.unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    return grad_fn


def decay_mask(model, params):
    """Which leaves of ``params`` AdamW decays: those of two dimensions
    or more in the reference's layout, where a leaf of a scanned layer
    (``model.stacked``) has one dimension more than here."""
    return tree.map(lambda p, stacked: p.dim() + int(stacked) >= 2, params,
                    model.stacked(params))


def _micro(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n``: rows i*B/n .. (i+1)*B/n of each entry."""
    def rows(x):
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]
    return {k: rows(v) for k, v in batch.items()}


def make_train_step(model, tcfg: TrainConfig, ocfg: adamw.AdamWConfig,
                    grad_pspecs=None):
    """``step(state, batch) -> (new_state, metrics)`` over
    ``{"params", "opt", "step"}`` (``init_state``); metrics are the last
    microbatch's ``xent`` and ``aux`` (as the reference's scan carries
    them), ``grad_norm`` and ``lr``, as 0-d tensors.  ``grad_pspecs``:
    the specs ``constrain_grad_sharding`` pins the gradients to (default:
    the parameters' own, ``sharding.param_pspecs``)."""
    grad_fn = make_grad_fn(model, tcfg)
    wire_dt = layers.torch_dtype(tcfg.grad_dtype)

    def constrain(g):
        ctx = pctx.current()
        if not tcfg.constrain_grad_sharding or ctx is None:
            return g
        specs = grad_pspecs if grad_pspecs is not None \
            else shd.param_pspecs(g, model.cfg)
        return tree.map(lambda x, s: pctx.constrain(x, s), g, specs)

    def step(state: dict, batch: dict):
        params = state["params"]
        n = tcfg.accum_steps
        if n == 1:
            grads, metrics = grad_fn(params, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % n:
                raise ValueError(f"a batch of {rows} rows in {n} "
                                 f"microbatches")
            grads = constrain(tree.map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params))
            for i in loops.repeat("micro", n):
                g, metrics = grad_fn(params, _micro(batch, i, n))
                g = constrain(g)
                for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
                    acc.add_(gi.to(torch.float32))
                del g
            for acc in tree.leaves(grads):
                acc.div_(n)
        if tcfg.compress_grads:
            # the gradients were summed in f32; only the update's input
            # is quantized
            grads = tree.map(lambda g: g.to(wire_dt), grads)
        with telemetry.span("train.optimizer"):
            new_params, new_opt, opt_metrics = adamw.update(
                grads, state["opt"], ocfg, params, decay_mask(model, params))
        del grads
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, dict(metrics, **opt_metrics))

    return step


def init_state(model, gen: torch.Generator, ocfg=None) -> dict:
    """``{"params": model.init(gen), "opt": adamw.init(params), "step":
    0}`` on the model's device."""
    del ocfg  # the reference's signature: AdamW's state needs no config
    params = model.init(gen)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}
