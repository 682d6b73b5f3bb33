"""The loops of the traffic kinds: ``<kind>.py`` holds a ``Driver`` for
the traffic files whose ``kind`` names it.

A driver's ``setup`` builds the program's objects from the seed and
warms up every shape the cell uses; ``unit`` runs one unit of the closed
loop (a train step, a prefill batch) and returns its
record once its result is on the host; ``after_window`` finishes what the
check needs; ``end_to_end`` gives the window's end-to-end metrics;
``check`` frees the program's state and compares what the window
produced with the plain reference.
"""

from __future__ import annotations

import gc

import torch

from perfbench import inputs


class Driver:
    def __init__(self, run):
        self.run = run
        self.dev = run.device
        self.seed = run.seed
        self.arch = run.arch
        self.traffic = run.traffic

    def build(self) -> None:
        """The program's model of the cell's configuration, and weights
        drawn for the configuration in the layout that model takes (the
        same for every seed: ``inputs.py``)."""
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import layers, registry
        if self.dev.type == "cuda":         # every CUDA kernel, in parallel
            from repro_torch.kernels import _build
            _build.build_all()
        self.cfg = ModelConfig(**self.arch)
        self.model = registry.build_model(self.cfg, self.dev)
        layout = registry.build_model(self.cfg, "meta").init(
            layers.MetaGenerator())
        self.weights = inputs.fill_weights(
            layout, inputs.generator(self.dev, "weights", self.cfg.name),
            self.cfg.vocab_size)
        self.zipf = inputs.Zipf(self.cfg.vocab_size, self.traffic["zipf_s"],
                                self.dev)

    def tokens(self, shape, *names) -> torch.Tensor:
        """Zipf token ids of ``shape`` from the seed's stream ``names``."""
        return self.zipf.draw(shape, inputs.generator(self.dev, self.seed,
                                                      *names))

    def moe_cfg(self):
        from repro_torch.models import moe
        c = self.cfg
        return moe.MoEConfig(
            d_model=c.d_model, d_expert=c.d_expert,
            num_experts=c.num_experts, top_k=c.top_k,
            activation=c.activation, dtype=c.dtype,
            capacity_factor=c.moe_capacity_factor)

    def attn_cfg(self):
        from repro_torch.models import attention
        c = self.cfg
        return attention.AttnConfig(
            d_model=c.d_model, num_heads=c.num_heads,
            num_kv_heads=c.num_kv_heads, head_dim=c.resolved_head_dim,
            qkv_bias=c.qkv_bias, rope_theta=c.rope_theta, dtype=c.dtype)

    @torch.no_grad()
    def moe_input(self, params, tokens) -> torch.Tensor:
        """What the program's MoE layer 0 gets from ``tokens`` (B, T):
        the embedded tokens, plus layer 0's attention over their norm,
        normed by its ``norm2``; (B * T, d), by the program's own
        functions, so that the probe routes and drops as the layer
        does."""
        from repro_torch.models import attention, layers
        p = params["layers"][0]
        h = torch.nn.functional.embedding(tokens.long(),
                                          params["embed"]["table"])
        h = h + attention.attend(p["attn"], layers.rmsnorm(p["norm1"], h),
                                 self.attn_cfg())[0]
        return layers.rmsnorm(p["norm2"], h).reshape(-1, h.shape[-1])

    def after_window(self) -> None:
        pass

    def free(self) -> None:
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
