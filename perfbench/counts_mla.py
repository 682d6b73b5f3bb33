"""The operations and bytes of the latent-attention cells' work
(DeepSeek-V3: multi-head latent attention in every layer, a dense FFN in
the leading layers and a share of sigmoid-routed experts beside a shared
expert in the rest), from the shapes, as ``counts.py`` counts them: the
multiply-adds of the matrix products (2 a product term), no norm,
rotation, softmax or other elementwise work, each input read once and
each output written once.

Model FLOPs count what the tokens need: causal attention at half of the
square, at q·k head size dn + dr and v head size dv; of the routed
experts, the held ones at their expected rows, top_k x held / E a token
(not the capacity's empty slots); the shared expert over every token;
the published vocabulary.

``arch`` is a configuration file's ``port`` section.
"""

from __future__ import annotations


def _mla_dims(arch: dict):
    """(d, heads, q·k head size, v head size)."""
    return (arch["d_model"], arch["num_heads"],
            arch["qk_nope_head_dim"] + arch["qk_rope_head_dim"],
            arch["v_head_dim"])


def mla_projection_flops(arch: dict, tokens: int) -> float:
    """The five projections of one MLA mixer: wq_a, wq_b, wkv_a, wkv_b,
    wo."""
    d, h, dqk, dv = _mla_dims(arch)
    ql, kl = arch["q_lora_rank"], arch["kv_lora_rank"]
    per_token = (d * ql + ql * h * dqk + d * (kl + arch["qk_rope_head_dim"])
                 + kl * h * (arch["qk_nope_head_dim"] + dv) + h * dv * d)
    return 2.0 * tokens * per_token


def mla_attention_flops(arch: dict, batch: int, seq: int,
                        causal_fraction: float = 0.5) -> float:
    """The attention core (K8): q k^T at dn + dr and p v at dv over
    ``causal_fraction`` of the seq x seq square of each head."""
    _, h, dqk, dv = _mla_dims(arch)
    return 2.0 * batch * h * seq * seq * (dqk + dv) * causal_fraction


def mla_attention_bytes(arch: dict, batch: int, seq: int,
                        dtype_bytes: int = 2) -> float:
    """The attention core's q and k (dn + dr a head), v and the output
    (dv), each once."""
    _, h, dqk, dv = _mla_dims(arch)
    return batch * seq * h * (2 * dqk + 2 * dv) * dtype_bytes


def mla_flops(arch: dict, batch: int, seq: int,
              causal_fraction: float = 0.5) -> float:
    """One MLA mixer over (batch, seq) tokens."""
    return (mla_projection_flops(arch, batch * seq)
            + mla_attention_flops(arch, batch, seq, causal_fraction))


def dense_ffn_flops(arch: dict, tokens: int) -> float:
    return 6.0 * tokens * arch["d_model"] * arch["d_ff_dense"]


def held_rows(arch: dict, tokens: int) -> float:
    """The rows the held experts expect: top_k x held / E a token."""
    held = arch.get("experts_held") or arch["num_experts"]
    return tokens * arch["top_k"] * held / arch["num_experts"]


def moe_flops(arch: dict, tokens: int, expert_rows: float = None) -> float:
    """One MoE layer: the router over all E experts, three products over
    the held experts' ``expert_rows`` (default ``held_rows``), and the
    shared expert over every token."""
    d, f = arch["d_model"], arch["d_expert"]
    rows = held_rows(arch, tokens) if expert_rows is None else expert_rows
    shared = arch.get("d_shared") or f * arch["num_shared_experts"]
    return (2.0 * tokens * d * arch["num_experts"] + 6.0 * rows * d * f
            + 6.0 * tokens * d * shared)


def forward_flops(arch: dict, batch: int, seq: int,
                  causal_fraction: float = 0.5, vocab: int = None,
                  expert_rows: float = None) -> float:
    """The model's forward over (batch, seq) tokens, logits included."""
    tokens = batch * seq
    dense = arch["first_k_dense"]
    layers = arch["num_layers"]
    return (layers * mla_flops(arch, batch, seq, causal_fraction)
            + dense * dense_ffn_flops(arch, tokens)
            + (layers - dense) * moe_flops(arch, tokens, expert_rows)
            + 2.0 * tokens * arch["d_model"] * (vocab or arch["vocab_size"]))
