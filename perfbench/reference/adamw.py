"""Plain AdamW for the reference's training steps, all in float32.

Global-norm clipping, then Adam's moments with bias correction and
decoupled weight decay on the leaves that decay; the learning rate warms
up linearly over ``warmup_steps`` and then follows a cosine down to
``min_lr_frac`` of ``lr`` at ``total_steps``.  The settings come from
the traffic file's ``optimizer`` section.
"""

from __future__ import annotations

import math

import torch


def learning_rate(opt: dict, step: int) -> float:
    """The rate of optimizer step ``step`` (1 for the first)."""
    warm = opt["warmup_steps"]
    if step < warm:
        return opt["lr"] * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * frac


class AdamW:
    """State over a list of f32 leaves; ``step`` updates them in place."""

    def __init__(self, leaves: list, decays: list, opt: dict):
        self.leaves, self.decays, self.opt = leaves, decays, opt
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """One update; returns the clipped gradients it applied."""
        o = self.opt
        self.count += 1
        lr = learning_rate(o, self.count)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
        c1 = 1 - o["b1"] ** self.count
        c2 = 1 - o["b2"] ** self.count
        clipped = []
        for p, g, m, v, decay in zip(self.leaves, grads, self.m, self.v,
                                     self.decays):
            g = g * scale
            clipped.append(g)
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + o["eps"])
            if decay:
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
        return clipped
