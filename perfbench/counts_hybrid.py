"""The operations and bytes of the hybrid cells' work (Mamba-2 and
attention mixers, each followed by an MoE with a shared expert), from
the shapes, as ``counts.py`` counts them: the multiply-adds of the
matrix products (2 a product term), no norm, convolution, softmax or
other elementwise work, each input read once and each output written
once.

Model FLOPs count what the tokens need: causal attention and the SSD's
intra-chunk square at half, each token's top-k experts (not the
capacity's empty slots), the published vocabulary.  The SSD is counted
at the configuration's chunk (``ssm_chunk``), as the program computes
it: per chunk of L positions, the scores C B^T (2 L^2 N), the
intra-chunk product over the heads (2 H L^2 P), and the chunk's state
and its read-out (2 L H P N each); the recurrence across chunks is
elementwise.

``arch`` is a configuration file's ``port`` section.
"""

from __future__ import annotations

from perfbench import counts


def _mamba_dims(arch: dict):
    """(d, inner width, state N, heads H, head size P)."""
    d = arch["d_model"]
    p = arch["ssm_head_dim"]
    return d, 2 * d, arch["ssm_state"], 2 * d // p, p


def ssm_flops(arch: dict, batch: int, seq: int,
              causal_fraction: float = 0.5) -> float:
    """One Mamba-2 mixer over (batch, seq) tokens: in_proj, the SSD at the
    configuration's chunk (sequences padded to whole chunks, the
    intra-chunk square at ``causal_fraction``), out_proj."""
    d, d_in, n, h, p = _mamba_dims(arch)
    tokens = batch * seq
    proj = 2.0 * tokens * d * (2 * d_in + 2 * n + h) + 2.0 * tokens * d_in * d
    size = arch["ssm_chunk"]
    chunks = batch * -(-seq // size)
    square = 2.0 * size * size * (n + h * p) * causal_fraction
    return proj + chunks * (square + 4.0 * size * h * p * n)


def ssm_bytes(arch: dict, tokens: int, dtype_bytes: int = 2) -> float:
    """One Mamba-2 mixer's forward: reads x and its weights (the f32
    ``a_log``, ``dt_bias`` and ``d_skip`` at 4 bytes), writes the
    output."""
    d, d_in, n, h, _ = _mamba_dims(arch)
    conv = d_in + 2 * n
    weights = (d * (d_in + conv + h) + 5 * conv + d_in + d_in * d) \
        * dtype_bytes + 3 * h * 4
    return weights + 2 * tokens * d * dtype_bytes


def moe_flops(arch: dict, tokens: int, expert_rows: float = None) -> float:
    """One MoE layer: the router and the routed experts (``counts.py``),
    and the shared expert over every token."""
    return (counts.moe_flops(arch, tokens, expert_rows)
            + 6.0 * tokens * arch["d_model"] * arch["d_shared"])


def moe_bytes(arch: dict, tokens: int, dtype_bytes: int = 2) -> float:
    """One MoE layer's forward: x, the router, the experts and the shared
    expert read, the output written."""
    return (counts.moe_bytes(arch, tokens, False, dtype_bytes)
            + 3 * arch["d_model"] * arch["d_shared"] * dtype_bytes)


def forward_flops(arch: dict, batch: int, seq: int,
                  causal_fraction: float = 0.5, vocab: int = None,
                  expert_rows: float = None) -> float:
    """The model's forward over (batch, seq) tokens, logits included;
    ``causal_fraction`` of attention's and the SSD's squares."""
    tokens = batch * seq
    total = counts.head_flops(arch, tokens, vocab)
    for kind in arch["layer_types"]:
        total += (ssm_flops(arch, batch, seq, causal_fraction)
                  if kind == "mamba" else
                  counts.attention_flops(arch, batch, seq, causal_fraction))
        total += moe_flops(arch, tokens, expert_rows)
    return total
