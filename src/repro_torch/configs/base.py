"""Config system: one frozen dataclass covers all 10 assigned architectures.

Each ``configs/<arch>.py`` exports ``CONFIG`` (exact published dims) —
``CONFIG.reduced()`` gives the CPU smoke-test variant (same family/topology,
tiny dims).  ``SHAPES`` defines the assigned input-shape set and
``shape_for(cfg, name)`` resolves per-arch applicability (long_500k only
for sub-quadratic archs, decode only for archs with a decoder).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 1e4
    attn_pattern: str = "full"      # full | local_global | none
    window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    norm: str = "rmsnorm"
    activation: str = "silu"
    # MoE
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_bf16_combine: bool = False
    # SSM / RWKV / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    rwkv: bool = False
    attn_every: int = 0             # zamba2: shared attn block cadence
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # VLM
    cross_attn_every: int = 0
    image_tokens: int = 1024
    # numerics / impl knobs (hillclimb levers)
    dtype: str = "bfloat16"
    remat: str = "block"            # none | block
    attn_impl: str = "dense"        # dense | blockwise
    kv_block: int = 1024
    q_block: int = 0          # 0 = no q-chunking
    attn_tp_expand: bool = False   # Megatron GQA TP (expand kv heads)
    attn_bf16_score_grad: bool = False  # bf16 softmax-bwd boundary (P9)
    rwkv_impl: str = "chunked"
    ssm_chunk: int = 64
    scan_layers: bool = True
    collect_dispatch: bool = False  # emit MoE dispatch ids for profiling

    # The fields of the port's own architectures (``PortConfig``), at the
    # values that add no operation.  Class attributes here, not fields, so
    # that the ten configurations shared with the reference keep its
    # fields one for one.
    layer_types = ()            # the published per-layer mixers, if any
    d_shared = 0                # shared-expert width (0: d_expert x count)
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    attention_multiplier = 0.0  # the softmax scale (0: 1 / sqrt(head_dim))
    logits_scaling = 1.0        # logits divided by it
    norm_eps = 1e-6
    nope = False                # attention without position embeddings

    # -- derived -----------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so the embedding/logits shard
        over any TP degree (standard practice; labels never hit pads)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / linear-attn / windowed hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def param_count(self) -> float:
        """Analytic parameter count (embedding included)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            per = (4 * d * d + d * self.d_ff * 2 + d * d  # tm + cm
                   + d * 64 * 2 + d * 5 * 32 * 2)
            return L * per + emb
        if self.family in ("ssm", "hybrid") and not self.rwkv:
            d_inner = 2 * d
            per = d * (2 * d_inner + 2 * self.ssm_state
                       + d_inner // self.ssm_head_dim) + d_inner * d
            total = L * per
            if self.attn_every:
                q = self.num_heads * hd
                kv = self.num_kv_heads * hd
                shared = d * (q + 2 * kv) + q * d + 3 * d * self.d_ff
                total += shared  # shared block counted once
            return total + emb
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * (q + 2 * kv) + q * d
        if self.is_moe:
            ffn = (3 * d * self.d_expert * self.num_experts
                   + d * self.num_experts
                   + 3 * d * self.d_expert * self.num_shared_experts)
        else:
            ffn = 3 * d * self.d_ff
        total = L * (attn + ffn)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ffn)
            total += L * (attn)  # decoder cross-attn
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            total += n_cross * attn
        return total + emb

    def active_param_count(self) -> float:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * (q + 2 * kv) + q * d
        ffn = (3 * d * self.d_expert * (self.top_k + self.num_shared_experts)
               + d * self.num_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn) + emb

    def reduced(self) -> "ModelConfig":
        """Tiny same-topology variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(4, self.num_kv_heads) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512 if self.vocab_size else 0,
            num_experts=min(8, self.num_experts),
            moe_capacity_factor=8.0,
            top_k=min(2, self.top_k),
            d_expert=64 if self.d_expert else 0,
            num_shared_experts=min(1, self.num_shared_experts),
            ssm_state=min(16, self.ssm_state),
            ssm_head_dim=16 if self.ssm_state else 64,
            attn_every=min(2, self.attn_every),
            encoder_layers=min(2, self.encoder_layers),
            encoder_frames=64 if self.encoder_layers else 1500,
            cross_attn_every=min(2, self.cross_attn_every),
            image_tokens=16 if self.cross_attn_every else 1024,
            window=64,
            ssm_chunk=16,
            kv_block=64,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class PortConfig(ModelConfig):
    """An architecture the port has and the reference lacks, given by
    its published ``layer_types``: the fields ``ModelConfig`` holds at
    their defaults, settable.  Granite 4.0-H (``granitemoehybrid``) sets
    them all: ``layer_types`` of "mamba" and
    "attention" mixers, each followed by the MoE FFN beside a shared
    expert of width ``d_shared``; the embedding times
    ``embedding_multiplier``, each mixer's and FFN's output times
    ``residual_multiplier`` before its residual add, attention without
    position embeddings (``nope``) at the softmax scale
    ``attention_multiplier``, and the logits over ``logits_scaling``.

    DeepSeek-V3 (``deepseek_v3``) sets the latent attention's ranks and
    head sizes (``models/mla.py``), YaRN's rotary parameters, the sigmoid
    router's (``models/moe.py``), ``first_k_dense`` leading layers with a
    dense FFN of width ``d_ff_dense``, and, cut to one card of an
    expert-parallel deployment, the share of the routed experts the card
    holds (``experts_held`` from ``expert_offset``)."""
    layer_types: tuple = ModelConfig.layer_types
    d_shared: int = ModelConfig.d_shared
    embedding_multiplier: float = ModelConfig.embedding_multiplier
    residual_multiplier: float = ModelConfig.residual_multiplier
    attention_multiplier: float = ModelConfig.attention_multiplier
    logits_scaling: float = ModelConfig.logits_scaling
    norm_eps: float = ModelConfig.norm_eps
    nope: bool = ModelConfig.nope
    # latent attention (MLA): low-rank q and kv projections, a rotary part
    # of each head shared by all heads, and v at a head size of its own
    q_lora_rank: int = 0
    kv_lora_rank: int = 0       # 0: no latent attention
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense: int = 0      # leading layers with a dense FFN
    d_ff_dense: int = 0         # their width
    # the router: "softmax" (top-k renormalised) or "sigmoid" (a selection
    # bias, group-limited top-k, weights renormalised times routed_scale)
    router: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    # YaRN's rotary frequencies and softmax temperature (rope_factor 1:
    # none)
    rope_factor: float = 1.0
    rope_original_max: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.0
    # the routed experts this card holds: [expert_offset, expert_offset +
    # experts_held) of num_experts (0: all of them)
    experts_held: int = 0
    expert_offset: int = 0

    def __post_init__(self):
        # a configuration file gives a list
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    def _layer_params(self, experts: int) -> list:
        """Each layer's parameters with ``experts`` routed experts a
        token (all of them: the layer's weights)."""
        d, hd = self.d_model, self.resolved_head_dim
        q, kv = self.num_heads * hd, self.num_kv_heads * hd
        d_inner = 2 * d
        heads = d_inner // self.ssm_head_dim
        conv = d_inner + 2 * self.ssm_state
        mamba = (d * (d_inner + conv + heads) + 5 * conv + 3 * heads
                 + d_inner + d_inner * d)
        attn = d * (q + 2 * kv) + q * d
        ffn = (d * self.num_experts + 3 * d * self.d_expert * experts
               + 3 * d * self.d_shared)
        return [(mamba if kind == "mamba" else attn) + ffn + 2 * d
                for kind in self.layer_types]

    def _mla_layer_params(self, experts: int) -> list:
        """Each layer's parameters of a latent-attention model with
        ``experts`` routed experts a token or a layer: the attention's
        projections and norms, then a dense FFN (the first
        ``first_k_dense``) or the router, its bias, the experts and the
        shared expert."""
        d, h = self.d_model, self.num_heads
        qk = self.qk_nope_head_dim + self.qk_rope_head_dim
        attn = (d * self.q_lora_rank + self.q_lora_rank
                + self.q_lora_rank * h * qk
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank
                + self.kv_lora_rank * h * (self.qk_nope_head_dim
                                           + self.v_head_dim)
                + h * self.v_head_dim * d)
        dense = 3 * d * self.d_ff_dense
        moe = (d * self.num_experts + self.num_experts
               + 3 * d * self.d_expert * experts
               + 3 * d * (self.d_shared or self.d_expert
                          * self.num_shared_experts))
        return [attn + (dense if i < self.first_k_dense else moe) + 2 * d
                for i in range(self.num_layers)]

    def _each_layer(self, experts: int) -> list:
        if self.kv_lora_rank:
            return self._mla_layer_params(experts)
        return self._layer_params(experts)

    def param_count(self) -> float:
        """Every parameter: the conv's taps and bias, the norms and the
        heads' vectors included; of the routed experts, those the card
        holds."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                else 2)
        held = self.experts_held or self.num_experts
        return sum(self._each_layer(held)) + emb + self.d_model

    def active_param_count(self) -> float:
        """A token's: its ``top_k`` experts, the shared expert and the
        router."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                else 2)
        return sum(self._each_layer(self.top_k)) + emb + self.d_model

    def reduced(self) -> "PortConfig":
        """``ModelConfig.reduced``, with two periods of a pattern of one
        layer of each published kind and a shared expert twice as wide as
        an expert, as the published one is.  A latent-attention model
        keeps every mechanism: one leading dense layer and three MoE
        layers, q·k and v head sizes that differ, YaRN, two groups of
        experts of which the router keeps one, and half the experts
        held."""
        small = super().reduced()
        if self.kv_lora_rank:
            return dataclasses.replace(
                small, q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
                first_k_dense=min(1, self.first_k_dense), d_ff_dense=256,
                n_group=min(2, self.n_group), topk_group=1,
                experts_held=small.num_experts // 2, expert_offset=0)
        kinds = tuple(dict.fromkeys(self.layer_types)) * 2
        return dataclasses.replace(
            small, num_layers=len(kinds), layer_types=kinds,
            d_shared=2 * small.d_expert if self.d_shared else 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""
