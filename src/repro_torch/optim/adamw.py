"""AdamW with f32 master weights: the reference's optimizer on one card.

State = {m, v, master, count}: m, v and master mirror the parameter tree
in f32; the parameters keep their own dtype (bf16 for compute) and are
re-derived from the master each step.  Global-norm clipping and a cosine
schedule with linear warmup, all math in f32 on the parameters' device,
as in the reference.

``update`` writes m, v, master and count in place: the step donates its
optimizer state, as a jitted step donates its buffers, so that one card
holds one copy of it (granite-moe-1b-a400m's three f32 trees take 16 GB).
The parameters it returns are new tensors.  On DTensor leaves (under a
mesh) every in-place write keeps the leaf's placements, and the new
parameters have their master's.  Where the reference casts
every leaf to the dtype of the tree's first leaf, each leaf here keeps
its own (an f32 leaf of a bf16 model stays f32).

Weight decay goes to the leaves of two dimensions or more, the
reference's rule for norms and biases.  The reference applies it to its
own layout, where every scanned layer's leaf is stacked over the layers
and so has one dimension more: its scanned layers' norm scales and
biases decay, its tail's and its embedding's norms do not.  ``update``
takes the tree of which leaves decay (``decay``); the train step passes
the reference's (``train.step.decay_mask``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), f32: linear
    warmup, then a cosine down to ``min_lr_frac`` of ``lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict:
    """Zero moments, an f32 copy of ``params`` and a step count of 0, on
    the parameters' device."""
    def zeros(p):   # a DTensor's zeros keep its placements
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree.leaves(params)[0].device
    return {
        "m": tree.map(zeros, params),
        "v": tree.map(zeros, params),
        "master": tree.map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(grads) -> torch.Tensor:
    """The f32 L2 norm of every leaf of ``grads`` together."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32)))
         for g in tree.leaves(grads)]).sum())


@torch.no_grad()
def update(grads, state: dict, cfg: AdamWConfig, params, decay=None):
    """One AdamW step.  Returns (new params, ``state`` updated in place,
    {"grad_norm", "lr"}); each new parameter leaf has the dtype of the
    leaf of ``params`` it replaces.  ``decay``: a tree of bools of the
    parameters' structure, the leaves that weight decay reaches (default:
    those of two dimensions or more)."""
    count = state["count"].add_(1)
    step = count.to(torch.float32)
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    c1 = 1 - cfg.b1 ** step
    c2 = 1 - cfg.b2 ** step
    masters = tree.leaves(state["master"])
    decays = ([m.dim() >= 2 for m in masters] if decay is None
              else tree.leaves(decay))
    for g, m, v, master, decayed in zip(
            tree.leaves(grads), tree.leaves(state["m"]),
            tree.leaves(state["v"]), masters, decays):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if decayed:
            upd = upd + cfg.weight_decay * master
        master.sub_(lr * upd)
    new_params = tree.map(lambda p, master: master.to(p.dtype, copy=True),
                          params, state["master"])
    return new_params, state, {"grad_norm": gnorm, "lr": lr}
