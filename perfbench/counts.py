"""The operations and bytes that the cells' work needs, from the shapes.

FLOPs count the multiply-adds of the matrix products (2 a product term);
norms, rotary embeddings, softmax and other elementwise work are left
out.  Model FLOPs count what the tokens need: causal attention at half
of the square, each token's top-k experts (not the capacity's empty
slots), no recomputation.  Bytes count each input read once and each
output written once, whatever a kernel reads again.

``arch`` is a configuration file's ``port`` section.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind`` (``peaks.json``): dense
    bf16 FLOP/s and HBM bytes/s; KeyError where the table lacks it."""
    table = json.loads(PEAKS.read_text())
    for name, row in table.items():
        if name == device_kind:
            return row
    raise KeyError(f"no peaks for {device_kind!r} in {PEAKS.name}")


def _heads(arch: dict):
    return arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]


def attention_flops(arch: dict, batch: int, seq: int,
                    causal_fraction: float = 0.5) -> float:
    """One attention layer over (batch, seq) tokens: the q, k, v and
    output projections, and q k^T and p v over ``causal_fraction`` of
    the seq x seq square."""
    d = arch["d_model"]
    h, kv, hd = _heads(arch)
    tokens = batch * seq
    proj = 2.0 * tokens * d * (h * hd + 2 * kv * hd) + 2.0 * tokens * h * hd * d
    core = 4.0 * batch * h * seq * seq * hd * causal_fraction
    return proj + core


def moe_flops(arch: dict, tokens: int, expert_rows: float = None) -> float:
    """One MoE layer over ``tokens``: the router and three expert
    products over ``expert_rows`` rows (default tokens x top_k)."""
    d, e, f = arch["d_model"], arch["num_experts"], arch["d_expert"]
    rows = tokens * arch["top_k"] if expert_rows is None else expert_rows
    return 2.0 * tokens * d * e + 6.0 * rows * d * f


def head_flops(arch: dict, tokens: int, vocab: int = None) -> float:
    return 2.0 * tokens * arch["d_model"] * (vocab or arch["vocab_size"])


def forward_flops(arch: dict, batch: int, seq: int,
                  causal_fraction: float = 0.5, vocab: int = None,
                  expert_rows: float = None) -> float:
    """The model's forward over (batch, seq) tokens, logits included."""
    tokens = batch * seq
    per_layer = (attention_flops(arch, batch, seq, causal_fraction)
                 + moe_flops(arch, tokens, expert_rows))
    return arch["num_layers"] * per_layer + head_flops(arch, tokens, vocab)


def train_flops(arch: dict, batch: int, seq: int) -> float:
    """A training step: forward and backward, 3 x the forward."""
    return 3.0 * forward_flops(arch, batch, seq)


def moe_bytes(arch: dict, tokens: int, backward: bool,
              dtype_bytes: int = 2) -> float:
    """One MoE layer's call: forward reads x and the weights and writes
    the output; forward and backward also read the output's gradient
    and write the gradients of x and of every weight."""
    d, e, f = arch["d_model"], arch["num_experts"], arch["d_expert"]
    weights = (d * e + 3 * e * d * f) * dtype_bytes
    act = tokens * d * dtype_bytes
    if not backward:
        return weights + 2 * act
    return 2 * weights + 4 * act


def attention_bytes(arch: dict, batch: int, seq: int,
                    dtype_bytes: int = 2) -> float:
    """One attention layer's forward: reads x and the four projections,
    writes the output."""
    d = arch["d_model"]
    h, kv, hd = _heads(arch)
    weights = (d * (h * hd + 2 * kv * hd) + h * hd * d) * dtype_bytes
    return weights + 2 * batch * seq * d * dtype_bytes


def roofline_share(flops: float, nbytes: float, seconds: float,
                   peak: dict) -> tuple:
    """(percent of the roofline, the bound: "flops" or "bytes")."""
    t_flops = flops / peak["bf16_flops_per_s"]
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    bound = "flops" if t_flops >= t_bytes else "bytes"
    return 100.0 * max(t_flops, t_bytes) / seconds, bound
