"""Model construction + batch stubs: one entry point for every arch."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.transformer import CausalLM
from repro_torch.models.whisper import WhisperModel


def build_model(cfg: ModelConfig, device="cuda"):
    """The model of ``cfg`` on ``device`` (default the card):
    ``WhisperModel`` for the audio family, else ``CausalLM`` (dense, MoE,
    gemma2, VLM, RWKV-6, zamba2's Mamba-2 with its shared attention)."""
    if cfg.family == "audio":
        return WhisperModel(cfg, device)
    return CausalLM(cfg, device)


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: Optional[torch.Generator] = None,
               device="cuda") -> dict:
    """Synthetic batch drawn from ``gen`` (default: seed 0 on ``device``)
    on the generator's device, with the modality stubs the arch needs:
    ``frames`` (B, encoder_frames, d_model) for the audio family and
    ``image_embeds`` (B, image_tokens, d_model) for the VLM family, normal
    x 0.02 in the config's dtype."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=gen.device, dtype=torch.int32)
    out = {"tokens": tokens, "labels": tokens}
    stubs = {"audio": ("frames", cfg.encoder_frames),
             "vlm": ("image_embeds", cfg.image_tokens)}
    if cfg.family in stubs:
        name, n = stubs[cfg.family]
        out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                device=gen.device,
                                dtype=layers.torch_dtype(cfg.dtype)) * 0.02
    return out
