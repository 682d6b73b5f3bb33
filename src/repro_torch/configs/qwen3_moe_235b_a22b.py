"""Qwen3-MoE 235B-A22B family (hf:Qwen/Qwen3-30B-A3B scaled per assignment):
128 experts, top-8, GQA kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, d_expert=1536, num_experts=128, top_k=8,
    vocab_size=151936, qkv_bias=False, tie_embeddings=False,
    rope_theta=1e6,
)
