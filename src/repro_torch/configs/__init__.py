"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    PortConfig,
    ShapeConfig,
    shape_applicable,
)

ARCHS = {
    "rwkv6-7b": "rwkv6_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma2-27b": "gemma2_27b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen2-72b": "qwen2_72b",
    "whisper-small": "whisper_small",
    "zamba2-1.2b": "zamba2_1p2b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}

# architectures of the port alone: the reference has none of them, so
# ``ARCHS`` (the reference's table, one for one) leaves them out
PORT_ARCHS = {
    "granite-4.0-h-small": "granite_4_0_h_small",
    "deepseek-v3": "deepseek_v3",
}


def get_config(arch: str) -> ModelConfig:
    table = {**ARCHS, **PORT_ARCHS}
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(table)}")
    mod = importlib.import_module(f"repro_torch.configs.{table[arch]}")
    return mod.CONFIG
