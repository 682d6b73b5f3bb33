"""Cohere Command R+ 104B (hf:CohereForAI/c4ai-command-r-plus): GQA, no bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, qkv_bias=False, tie_embeddings=True,
    rope_theta=75e4,
)
