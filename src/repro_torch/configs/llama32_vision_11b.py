"""Llama-3.2-Vision 11B (hf:meta-llama/Llama-3.2-11B-Vision): gated
cross-attention image layers every 5th layer; vision tower stubbed
(input_specs supplies precomputed patch embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, tie_embeddings=False,
    cross_attn_every=5, image_tokens=1600, rope_theta=5e5,
)
