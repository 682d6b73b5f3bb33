"""A closed loop of the program's prefill of a hybrid model: Mamba-2 and
attention mixers, each followed by an MoE with a shared expert (Granite
4.0-H, ``configs.base.PortConfig``).  The loop and the sample are
``prefill.py``'s; the reference is ``reference/granite_hybrid.py`` and
the FLOPs are ``counts_hybrid.py``'s.

The check compares what ``prefill.py``'s does, and the program's logits
themselves at ``ROWS`` positions of each sampled sequence (drawn from the
seed, the last among them): ``logit_err``, the RMS of their difference
from the reference's rows over the RMS spread of those rows.  Under
this configuration's weight draw the tied head, read after the
embedding's multiplier of 12, puts the prompt's own token first at
nearly every position, by a margin that no precision moves: the served
tokens alone could not tell the program from the float8 control, nor
from a fault in the layers.

The weights are ``inputs.fill_weights``' draw, but for each Mamba-2
mixer's ``a_log`` and ``dt_bias``, which it would set to 1 (dt about
1.3 and A = -e: every head forgets its state within a token, and no
fault of the recurrence across chunks could show).  They are drawn by
Mamba-2's published init from a stream of the configuration's weights:
A ~ U[1, 16], dt log-uniform in [0.001, 0.1] and floored at 1e-4,
``dt_bias`` its inverse softplus.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import counts_hybrid, inputs
from perfbench.harness import log
from perfbench.kinds import prefill
from perfbench.reference import granite_hybrid as ref
from perfbench.reference import model as precision

ROWS = 64
A_RANGE = (1.0, 16.0)
DT_RANGE = (0.001, 0.1)
DT_FLOOR = 1e-4


def mamba_init(params: dict, gen: torch.Generator) -> None:
    """Each Mamba-2 mixer's ``a_log`` and ``dt_bias`` in ``params``,
    redrawn in place by the published init from ``gen``."""
    for layer in params["layers"]:
        ssm = layer.get("ssm")
        if ssm is None:
            continue
        h = ssm["a_log"].shape[0]
        dev = ssm["a_log"].device
        a = torch.empty(h, device=dev).uniform_(*A_RANGE, generator=gen)
        lo, hi = (math.log(v) for v in DT_RANGE)
        dt = torch.exp(torch.empty(h, device=dev).uniform_(
            lo, hi, generator=gen)).clamp_(min=DT_FLOOR)
        ssm["a_log"].copy_(torch.log(a))
        ssm["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))


class Driver(prefill.Driver):

    def build(self) -> None:
        """``kinds.Driver.build`` of the port's own configuration class,
        then the Mamba-2 init."""
        from repro_torch.configs.base import PortConfig
        from repro_torch.models import layers, registry
        if self.dev.type == "cuda":         # every CUDA kernel, in parallel
            from repro_torch.kernels import _build
            _build.build_all()
        self.cfg = PortConfig(**self.arch)
        self.model = registry.build_model(self.cfg, self.dev)
        layout = registry.build_model(self.cfg, "meta").init(
            layers.MetaGenerator())
        self.weights = inputs.fill_weights(
            layout, inputs.generator(self.dev, "weights", self.cfg.name),
            self.cfg.vocab_size)
        mamba_init(self.weights, inputs.generator(
            self.dev, "weights", self.cfg.name, "mamba"))
        self.zipf = inputs.Zipf(self.cfg.vocab_size, self.traffic["zipf_s"],
                                self.dev)

    def unit(self) -> dict:
        shape = self.cycle[self.next]
        out = super().unit()
        out["flops"] = counts_hybrid.forward_flops(self.arch, *shape)
        return out

    def _call(self, shape, tokens, keep: bool = False):
        """``prefill.Driver._call``; where ``keep``, what the check reads:
        (the first token of every position, the positions of the rows,
        the logits' rows there)."""
        logits, cache = self.prefill[shape](self.weights, tokens)
        first = logits[:, -1].argmax(-1).cpu()   # the first tokens, served
        kept = None
        if keep:
            at = self.rows_at(shape)
            kept = (logits.argmax(-1).to(torch.int32), at, logits.gather(
                1, at[..., None].expand(-1, -1, logits.shape[-1])))
        del logits, cache
        return first, kept

    def rows_at(self, shape) -> torch.Tensor:
        """(batch, ``ROWS``) positions of each sequence of ``shape``: its
        last and others drawn from the seed."""
        b, t = shape
        gen = inputs.generator(self.dev, self.seed, "rows", *shape)
        at = torch.randint(0, t, (b, ROWS), generator=gen, device=self.dev)
        at[:, -1] = t - 1
        return at

    def moe_cfg(self):
        from repro_torch.models import transformer
        return transformer._moe_cfg(self.cfg)

    # -- what the per-layer readers call ----------------------------------

    @torch.no_grad()
    def ssm_input(self, params, tokens) -> torch.Tensor:
        """What the program's Mamba-2 mixer of layer 0 gets from
        ``tokens`` (B, T): the embedded tokens, normed."""
        from repro_torch.models import transformer
        h = self.model._embed(params, tokens)
        return transformer._norm(self.cfg, params["layers"][0]["norm1"], h)

    @torch.no_grad()
    def moe_input(self, params, tokens) -> torch.Tensor:
        """What the program's MoE layer 0 gets from ``tokens`` (B, T):
        the embedded tokens plus layer 0's Mamba-2 mixer, normed; (B * T,
        d), by the program's own functions."""
        from repro_torch.models import mamba2, transformer
        cfg = self.cfg
        p = params["layers"][0]
        h = self.model._embed(params, tokens)
        xn = transformer._norm(cfg, p["norm1"], h)
        h = h + mamba2.apply(p["ssm"], xn, transformer._mamba_cfg(cfg)) \
            * cfg.residual_multiplier
        return transformer._norm(cfg, p["norm2"], h).reshape(-1, h.shape[-1])

    def ssm_call(self, layer: int = 0):
        """(call, tokens): one forward of the program's Mamba-2 mixer of
        layer 0 over its input from ``roofline_tokens`` of the cell's
        tokens, one sequence."""
        from repro_torch.models import mamba2, transformer
        n = self.traffic["roofline_tokens"]
        x = self.ssm_input(self.weights, self.tokens((1, n), "probe-ssm"))
        mcfg = transformer._mamba_cfg(self.cfg)
        p = self.weights["layers"][layer]["ssm"]

        @torch.no_grad()
        def call():
            mamba2.apply(p, x, mcfg)
        return call, n

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

    def control(self) -> dict:
        """The numbers of the reference in float8 in the program's place,
        at the same positions (after ``check``)."""
        return self._numbers(self.samples, precision.FP8)

    def faults(self) -> dict:
        """The numbers of an answer altered where it is produced: one
        served token of each sample, drawn from the seed, replaced by
        another token (after ``check``)."""
        gen = inputs.generator("cpu", self.seed, "fault")
        altered = []
        for tokens, (served, at, rows) in self.samples:
            served = served.clone()
            flat = served.view(-1)
            i = int(torch.randint(0, flat.numel(), (), generator=gen))
            flat[i] = (flat[i] + 1 + int(torch.randint(
                0, self.cfg.vocab_size - 1, (), generator=gen))) \
                % self.cfg.vocab_size
            altered.append((tokens, (served, at, rows)))
        return {"answer_altered": self._numbers(altered)}

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
