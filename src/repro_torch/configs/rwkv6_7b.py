"""RWKV-6 'Finch' 7B (arXiv:2404.05892) — attention-free linear RNN."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", rwkv=True,
    num_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
    attn_pattern="none", tie_embeddings=False,
)
