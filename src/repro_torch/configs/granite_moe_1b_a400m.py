"""IBM Granite 3.0 1B-A400M base (hf:ibm-granite/granite-3.0-1b-a400m-base):
32 experts, top-8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, d_expert=512, num_experts=32, top_k=8,
    vocab_size=49155, tie_embeddings=True,
)
