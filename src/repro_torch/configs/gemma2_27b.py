"""Gemma-2 27B (arXiv:2408.00118): local+global alternating, logit softcaps."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000, tie_embeddings=True,
    attn_pattern="local_global", window=4096,
    attn_softcap=50.0, final_softcap=30.0, activation="gelu",
)
