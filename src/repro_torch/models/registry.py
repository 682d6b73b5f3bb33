"""Model construction + batch stubs: one entry point for every arch."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import CausalLM


def build_model(cfg: ModelConfig, device="cuda") -> CausalLM:
    """The model of ``cfg`` on ``device`` (default the card): the dense
    and the MoE families; raises for what is not ported yet (the audio
    family, layers other than attention)."""
    if cfg.family == "audio":
        raise NotImplementedError(f"{cfg.name}: the Whisper family is not "
                                  f"ported yet (ROADMAP item 10)")
    return CausalLM(cfg, device)


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: Optional[torch.Generator] = None,
               device="cuda") -> dict:
    """Synthetic token batch drawn from ``gen`` (default: seed 0 on
    ``device``) on the generator's device.  The reference's audio and
    image stubs come with their families (ROADMAP item 10)."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=gen.device, dtype=torch.int32)
    return {"tokens": tokens, "labels": tokens}
