"""DeepSeek-V3 (hf:deepseek-ai/DeepSeek-V3, ``config.json``, ``model_type``
"deepseek_v3"): 61 layers of multi-head latent attention (MLA: 128 heads,
``q_lora_rank`` 1536, ``kv_lora_rank`` 512, q·k heads of 128 + a 64-wide
rotary part shared by all heads, v heads of 128) with YaRN (factor 40 over
4096 positions); the first 3 layers with a dense FFN of width 18,432, the
other 58 with 256 routed experts of width 2048, top 8 by sigmoid scores
with a selection bias over 8 groups of which the best 4 are kept, weights
renormalised times 2.5, beside one shared expert; an untied head over a
vocabulary of 129,280.  The port's own: the reference has no such model.
Its multi-token-prediction module is not modelled."""
from repro_torch.configs.base import PortConfig

CONFIG = PortConfig(
    name="deepseek-v3", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    first_k_dense=3, d_ff_dense=18432,
    d_ff=2048, d_expert=2048, num_experts=256, top_k=8, num_shared_experts=1,
    router="sigmoid", n_group=8, topk_group=4, routed_scale=2.5,
    rope_theta=10000.0, rope_factor=40.0, rope_original_max=4096,
    beta_fast=32.0, beta_slow=1.0, mscale_all_dim=1.0,
    vocab_size=129280, tie_embeddings=False, norm_eps=1e-6,
)
