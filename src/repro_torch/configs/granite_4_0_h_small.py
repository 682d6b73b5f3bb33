"""IBM Granite 4.0-H Small (hf:ibm-granite/granite-4.0-h-small,
``config.json``, ``model_type`` "granitemoehybrid"): 40 layers, 36 Mamba-2
mixers and 4 NoPE GQA attention mixers (at 5, 15, 25 and 35), each
followed by an MoE of 72 experts of width 768, top-10, beside one shared
expert of width 1536; Granite's embedding, residual, attention and logit
scalars.  The port's own: the reference has no such model."""
from repro_torch.configs.base import PortConfig

PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = PortConfig(
    name="granite-4.0-h-small", family="hybrid",
    num_layers=40, layer_types=PERIOD * 4, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, nope=True,
    attention_multiplier=0.0078125,
    d_ff=768, d_expert=768, num_experts=72, top_k=10, num_shared_experts=1,
    d_shared=1536,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
    vocab_size=100352, tie_embeddings=True,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, norm_eps=1e-5,
)
