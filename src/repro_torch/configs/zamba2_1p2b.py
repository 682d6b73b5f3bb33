"""Zamba2-1.2B (arXiv:2411.15242): Mamba2 backbone + shared attention block
every 6 layers (shared weights, per-invocation KV)."""
from repro_torch.configs.base import ModelConfig

# The Mamba2 conv-state ring buffers dominate this config's scan as
# stride-aligned dynamic-update-slice writes, but each slot has exactly
# one producer per step (overwrite, no read-modify-write), so the bank
# hazard is benign here.
# repro: noqa BANK001

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, tie_embeddings=True,
    ssm_state=64, ssm_head_dim=64, attn_every=6, window=4096,
)
