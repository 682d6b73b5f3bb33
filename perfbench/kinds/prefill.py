"""A closed loop of the program's prefill
(``repro_torch.serve.step.make_prefill``) on Zipf prompts.

Each batch holds the same number of tokens in one of the traffic's
``shapes`` (batch, length), cycled in an order drawn from the seed.  A
batch ends when its first token, the argmax of its last position, is on
the host.  For the batches of the check's sample (the first of the
longest prompts, and one drawn from the seed among the first
``sample_range``), the window also keeps the argmax of every position:
the token each position's logits put first.

The check runs the reference over each sampled batch in f32 and reads,
at every position, how far below the reference's best logit the
program's token lies; the widest such gap is compared.
"""

from __future__ import annotations

import torch

from perfbench import counts, inputs
from perfbench.kinds import Driver as Base
from perfbench.reference import model as ref


class Driver(Base):
    metric = "prefill_tokens_per_s"

    def setup(self) -> None:
        from repro_torch.serve import step as serve_step
        self.build()
        t = self.traffic
        self.cycle = inputs.ShapeCycle(t["shapes"], self.seed)
        longest = max(s[1] for s in self.cycle.shapes)
        first = next(j for j in range(len(self.cycle.shapes))
                     if self.cycle[j][1] == longest)
        drawn = int(torch.randint(
            0, t["sample_range"], (),
            generator=inputs.generator("cpu", self.seed, "sample")))
        self.first = first
        self.sample = {first, drawn}
        self.kept: dict = {}
        self.prefill = {
            shape: serve_step.make_prefill(
                self.model, serve_step.ServeConfig(max_len=shape[1]))
            for shape in self.cycle.shapes}
        for shape in self.cycle.shapes:        # one call of every shape
            self._call(shape, self.tokens(shape, "warmup", *shape))
        self.next = 0

    def _call(self, shape, tokens, keep: bool = False):
        logits, cache = self.prefill[shape](self.weights, tokens)
        first = logits[:, -1].argmax(-1).cpu()   # the first tokens, served
        every = logits.argmax(-1).to(torch.int32) if keep else None
        del logits, cache
        return first, every

    def unit(self) -> dict:
        j = self.next
        shape = self.cycle[j]
        tokens = self.tokens(shape, "prefill", j)
        keep = j in self.sample
        _, every = self._call(shape, tokens, keep)
        if keep:
            self.kept[j] = (tokens, every)
        self.next += 1
        return {"tokens": shape[0] * shape[1],
                "flops": counts.forward_flops(self.arch, *shape)}

    def after_window(self) -> None:
        """Finish the sample's first batch where the window ended before
        it (a short window)."""
        while self.next <= self.first:
            self.unit()

    def end_to_end(self) -> dict:
        run = self.run
        return {self.metric: sum(u["tokens"] for u in run.units)
                / run.elapsed}

    # -- what the per-layer readers call ----------------------------------

    def moe_call(self, layer: int = 0):
        """(call, tokens): one forward of the program's MoE layer 0 over
        its input from ``roofline_tokens`` of the cell's tokens
        (``moe_input``)."""
        from repro_torch.models import moe
        n = self.traffic["roofline_tokens"]
        x = self.moe_input(self.weights, self.tokens((1, n), "probe"))
        mcfg = self.moe_cfg()
        p = self.weights["layers"][layer]["ffn"]

        @torch.no_grad()
        def call():
            moe.apply_local(p, x, mcfg)
        return call, n

    def attention_call(self, layer: int = 0):
        """(call, (batch, seq)): one self-attention of the program over a
        batch of ``attention_shape`` of the cell's tokens, embedded."""
        from repro_torch.models import attention
        b, t = self.traffic["attention_shape"]
        x = torch.nn.functional.embedding(
            self.tokens((b, t), "probe-attention").long(),
            self.weights["embed"]["table"])
        acfg = self.attn_cfg()
        p = self.weights["layers"][layer]["attn"]

        @torch.no_grad()
        def call():
            attention.attend(p, x, acfg)
        return call, (b, t)

    # -- the check ---------------------------------------------------------

    def check(self) -> dict:
        del self.prefill
        self.free()
        self.samples = list(self.kept.values())
        self.gaps = ref.all_gaps(self.weights, self.samples,
                                 ref.Arch.from_config(self.arch))
        return ref.serving_numbers(self.gaps)

    def control(self) -> dict:
        """The numbers of the reference in float8 in the program's place,
        at the same positions (after ``check``)."""
        return ref.serving_numbers(ref.all_gaps(
            self.weights, self.samples, ref.Arch.from_config(self.arch),
            ref.FP8))

    def faults(self) -> dict:
        """The numbers of an answer altered where it is produced: one
        served token of each sample, drawn from the seed, replaced by
        another token (after ``check``)."""
        gen = inputs.generator("cpu", self.seed, "fault")
        altered = []
        for tokens, served in self.samples:
            served = served.clone()
            where = torch.nonzero(served.reshape(-1) >= 0)[:, 0]
            at = where[int(torch.randint(0, where.numel(), (),
                                         generator=gen))]
            flat = served.view(-1)
            flat[at] = (flat[at] + 1 + int(torch.randint(
                0, self.cfg.vocab_size - 1, (), generator=gen))) \
                % self.cfg.vocab_size
            altered.append((tokens, served))
        return {"answer_altered": ref.serving_numbers(ref.all_gaps(
            self.weights, altered, ref.Arch.from_config(self.arch)))}

    def details(self, full: bool = False) -> dict:
        """The spread of the program's gaps (after ``check``); ``full``:
        also the control's, and those of the reference with bf16
        products."""
        arch = ref.Arch.from_config(self.arch)
        out = {"program": ref.gap_stats(self.gaps)}
        if not full:
            return out
        for name, prec in (("control", ref.FP8), ("bf16", ref.BF16)):
            g = ref.all_gaps(self.weights, self.samples, arch, prec)
            out[name] = dict(ref.serving_numbers(g), **ref.gap_stats(g))
        return out
