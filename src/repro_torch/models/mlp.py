"""Gated MLP (SwiGLU/GeGLU) — the dense FFN used by every assigned arch.

Under a mesh the gate and up projections' outputs are pinned to the
batch over the data axes and the hidden over the model axis
(``pctx.shard_batch_tp``), so that the products stay tensor-parallel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import ctx as pctx


def init(gen: torch.Generator, d_model: int, d_ff: int,
         dtype=torch.bfloat16, activation: str = "silu") -> dict:
    del activation  # static; passed to apply() instead
    return {
        "w_gate": layers.dense_init(gen, d_model, d_ff, dtype),
        "w_up": layers.dense_init(gen, d_model, d_ff, dtype),
        "w_down": layers.dense_init(gen, d_ff, d_model, dtype),
    }


# jax.nn.gelu is the tanh approximation by default
_ACT = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu}


def apply(p: dict, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = _ACT[activation]
    h = act(pctx.shard_batch_tp(layers.dense(p["w_gate"], x))) * \
        pctx.shard_batch_tp(layers.dense(p["w_up"], x))
    return layers.dense(p["w_down"], h)
