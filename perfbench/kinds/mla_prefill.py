"""A closed loop of the program's prefill of a latent-attention model:
DeepSeek-V3 (``configs.base.PortConfig``), MLA in every layer, a dense
FFN in the leading layers and, in the rest, the sigmoid-routed experts
this card holds beside a shared expert.  The loop, the sample and the
kept rows are ``hybrid_prefill.py``'s (``prefill.py``'s, and the logits
themselves at ``ROWS`` positions of each sampled sequence); the
reference is ``reference/deepseek_v3.py`` and the FLOPs are
``counts_mla.py``'s.

The check gives the served tokens' gaps below the reference's best
logit (``mean_gap``, ``logit_gap``: the untied head reads no token's own
embedding, so they are not 0 as the hybrid's are) and ``logit_err``, the
kept rows' RMS difference from the reference's over the RMS spread of
those rows.  The limits file compares ``mean_gap`` and ``logit_err``,
which the float8 control fails by far; ``logit_gap``, the largest gap
over every served position, lies too near the control's to compare.

The weights are ``inputs.fill_weights``' draw, but for each MoE layer's
selection bias (``score_bias``, the published ``e_score_correction_
bias``), which it would set to 1 for every expert and so change no
choice.  It is drawn from a stream of the configuration's weights,
normal times ``BIAS_SCALE`` (the configuration file's ``assumed`` says
what share of the router's choices that changes).

The configuration is made before any kernel is built, so that a program
without latent attention (an older commit) refuses the cell at once.
"""

from __future__ import annotations

import time

import torch

from perfbench import counts_mla, inputs
from perfbench.harness import log
from perfbench.kinds import hybrid_prefill
from perfbench.reference import deepseek_v3 as ref
from perfbench.reference import model as precision

BIAS_SCALE = 0.1


def bias_init(params: dict, gen: torch.Generator) -> None:
    """Each MoE layer's ``score_bias`` in ``params``, redrawn in place,
    normal times ``BIAS_SCALE``, from ``gen``."""
    for layer in params["layers"]:
        bias = layer["ffn"].get("score_bias")
        if bias is not None:
            bias.copy_(torch.randn(bias.shape, generator=gen,
                                   device=bias.device) * BIAS_SCALE)


class Driver(hybrid_prefill.Driver):

    def build(self) -> None:
        """``kinds.Driver.build`` of the port's own configuration class,
        made first, then the selection biases."""
        from repro_torch.configs.base import PortConfig
        from repro_torch.models import layers, registry
        self.cfg = PortConfig(**self.arch)
        if self.dev.type == "cuda":         # every CUDA kernel, in parallel
            from repro_torch.kernels import _build
            _build.build_all()
        self.model = registry.build_model(self.cfg, self.dev)
        layout = registry.build_model(self.cfg, "meta").init(
            layers.MetaGenerator())
        self.weights = inputs.fill_weights(
            layout, inputs.generator(self.dev, "weights", self.cfg.name),
            self.cfg.vocab_size)
        bias_init(self.weights, inputs.generator(
            self.dev, "weights", self.cfg.name, "score_bias"))
        self.zipf = inputs.Zipf(self.cfg.vocab_size, self.traffic["zipf_s"],
                                self.dev)

    def unit(self) -> dict:
        """``prefill.Driver.unit``, its FLOPs ``counts_mla.py``'s."""
        j = self.next
        shape = self.cycle[j]
        tokens = self.tokens(shape, "prefill", j)
        keep = j in self.sample
        _, kept = self._call(shape, tokens, keep)
        if keep:
            self.kept[j] = (tokens, kept)
        self.next += 1
        return {"tokens": shape[0] * shape[1],
                "flops": counts_mla.forward_flops(self.arch, *shape)}

    # -- what the per-layer readers call ----------------------------------

    @torch.no_grad()
    def mla_attention_call(self, layer: int = 0):
        """(call, (batch, seq)): the attention core (``mla.attend_core``,
        span ``mla.attend``: K8 at q·k 192 and v 128) of the program's MLA
        mixer of ``layer`` over its own q, k and v from one sequence of
        ``roofline_tokens`` of the cell's tokens, embedded and normed."""
        from repro_torch.models import mla, transformer
        n = self.traffic["roofline_tokens"]
        cfg = self.cfg
        p = self.weights["layers"][layer]
        tokens = self.tokens((1, n), "probe-mla")
        xn = transformer._norm(cfg, p["norm1"], self.model._embed(
            self.weights, tokens))
        mcfg = transformer._mla_cfg(cfg)
        q, k, v = mla.heads(p["attn"], xn, mcfg)

        @torch.no_grad()
        def call():
            mla.attend_core(q, k, v, mcfg.scale)
        return call, (1, n)

    # -- the check ---------------------------------------------------------

    def _numbers(self, samples, prec=None) -> dict:
        return ref.numbers(*ref.all_compared(
            self.weights, samples, ref.Arch.from_config(self.arch), prec))

    def check(self) -> dict:
        del self.prefill
        self.free()
        self.samples = list(self.kept.values())
        t0 = time.perf_counter()
        gaps, errs = ref.all_compared(self.weights, self.samples,
                                      ref.Arch.from_config(self.arch))
        self.gaps = gaps
        log(f"check: the f32 reference over {len(self.samples)} sampled "
            f"batches in {time.perf_counter() - t0:.1f} s")
        return ref.numbers(gaps, errs)

    def details(self, full: bool = False) -> dict:
        """The spread of the program's gaps (after ``check``); ``full``:
        also the control's numbers and gaps, and those of the reference
        with bf16 products."""
        out = {"program": precision.gap_stats(self.gaps)}
        if not full:
            return out
        arch = ref.Arch.from_config(self.arch)
        for name, prec in (("control", precision.FP8),
                           ("bf16", precision.BF16)):
            gaps, errs = ref.all_compared(self.weights, self.samples, arch,
                                          prec)
            out[name] = dict(ref.numbers(gaps, errs),
                             **precision.gap_stats(gaps))
        return out
