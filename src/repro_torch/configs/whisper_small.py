"""Whisper-small (arXiv:2212.04356): enc-dec; conv frontend stubbed
(input_specs supplies precomputed frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, encoder_layers=12, encoder_frames=1500,
    d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865, tie_embeddings=True,
    norm="layernorm", activation="gelu", qkv_bias=True,
)
