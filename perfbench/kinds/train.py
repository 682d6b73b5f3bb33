"""A closed loop of the program's train steps
(``repro_torch.train.step.make_train_step``) on Zipf batches.

Set-up builds one train state from the configuration's weights, with
AdamW's f32 master, and drives it through the traffic's ``check_steps``
steps: the same step function and feed as the window, each on a batch
of its own.  They warm up every shape, and give the check its readings:
each step's loss, the first gradient as AdamW got it (its first moment
after one step over 1 - b1) and each leaf's change after the steps
(AdamW's f32 master less the starting weights).  The window then goes
on with the same state.

The check runs the reference's f32 model and AdamW over the same
starting weights and batches, with the master and the stored weights
that the configuration states (an f32 master, bf16 weights).  It
compares the steps' widest relative gap of the loss, and for each leaf
the gap between the program's and the reference's norm of its first
gradient, and of its change, over the larger of the reference's norm of
that leaf and of the median leaf, at the worst leaf.  A leaf whose
reference gradient is under ``tiny_leaf`` of the median leaf's moves by
round-off alone and is left out of the change.
"""

from __future__ import annotations

import statistics

import torch

from perfbench import counts, inputs
from perfbench.kinds import Driver as Base
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import model as ref


def _norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in zip(inputs.leaf_paths(tree), inputs.leaves(tree))}


def _leaf_gaps(prog: dict, want: dict, keep=None) -> dict:
    """Each leaf's |prog - want| / max(want, the median leaf's want)."""
    names = [n for n in want if keep is None or keep[n]]
    med = statistics.median(want[n] for n in names)
    return {n: abs(prog[n] - want[n]) / max(want[n], med) for n in names}


def _worst(gaps: dict) -> tuple:
    """(the widest gap, its leaf)."""
    return max((g, n) for n, g in gaps.items())


class Driver(Base):
    metric = "train_tokens_per_s"

    def setup(self) -> None:
        from repro_torch.optim import adamw
        from repro_torch.train import step as train_step
        self.build()
        t = self.traffic
        self.shape = (t["batch"], t["seq"])
        ocfg = adamw.AdamWConfig(**t["optimizer"])
        self.b1 = ocfg.b1
        self.step_fn = train_step.make_train_step(
            self.model, train_step.TrainConfig(), ocfg)
        self.state = {"params": self.weights,
                      "opt": adamw.init(self.weights),
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.dev)}
        self.flops = counts.train_flops(self.arch, *self.shape)
        self.losses = []
        self.check_batches = []
        for i in range(t["check_steps"]):
            batch = self._batch(i)
            self.check_batches.append(batch["tokens"])
            metrics = self._step(batch)
            self.losses.append(float(metrics["xent"] + self.aux_weight
                                     * metrics["aux"]))
            if i == 0:
                self.grad = {p: v / (1 - self.b1) for p, v in
                             _norms(self.state["opt"]["m"]).items()}
        master = self.state["opt"]["master"]
        start = dict(zip(inputs.leaf_paths(self.weights),
                         inputs.leaves(self.weights)))
        self.change = {
            p: float(torch.linalg.vector_norm(m - start[p].float()))
            for p, m in zip(inputs.leaf_paths(master), inputs.leaves(master))}
        self.next = t["check_steps"]

    @property
    def aux_weight(self) -> float:
        return self.run.cell.config.get("router_aux_loss_coef", 0.001)

    def _batch(self, i: int) -> dict:
        tokens = self.tokens(self.shape, "train", i)
        return {"tokens": tokens, "labels": tokens}

    def _step(self, batch: dict) -> dict:
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def unit(self) -> dict:
        metrics = self._step(self._batch(self.next))
        self.next += 1
        float(metrics["xent"])          # the step's loss on the host
        return {"tokens": self.shape[0] * self.shape[1],
                "flops": self.flops}

    def end_to_end(self) -> dict:
        run = self.run
        return {self.metric: sum(u["tokens"] for u in run.units)
                / run.elapsed}

    # -- what the per-layer readers call ----------------------------------

    def moe_call(self, layer: int = 0):
        """(call, tokens): one forward and backward of the program's MoE
        layer 0 over its input from a train batch of the cell's tokens
        (``moe_input``), at the window's weights."""
        from repro_torch.models import moe
        params = self.state["params"]
        ffn = params["layers"][layer]["ffn"]
        p = {k: v.detach().requires_grad_() for k, v in ffn.items()
             if k != "router"}
        p["router"] = {"w": ffn["router"]["w"].detach().requires_grad_()}
        tokens = self.tokens(self.shape, "probe")
        x = self.moe_input(params, tokens).requires_grad_()
        mcfg = self.moe_cfg()
        grad = torch.ones_like(x)

        def call():
            with torch.enable_grad():
                out = moe.apply_local(p, x, mcfg)[0]
                torch.autograd.backward(out, grad)
        return call, tokens.numel()

    # -- the check ---------------------------------------------------------

    def readings(self, prec=ref.F32, rows=None, stored=True) -> dict:
        """The reference's readings over the check's batches from the
        same starting weights: each step's loss, each leaf's first
        clipped gradient and its change, by leaf path.  AdamW keeps an
        f32 master; each step's forward reads it as the configuration
        stores its weights, each leaf rounded to that leaf's dtype and
        computed in f32 (``stored=False``: the master itself).  ``prec``
        is the precision of its products (the control: ``ref.FP8``);
        ``rows`` keeps only those rows of each batch (a fault: part of
        the batch left out)."""
        arch = ref.Arch.from_config(self.arch)
        arch = ref.Arch(**{**arch.__dict__, "aux_weight":
                           self.aux_weight})
        start = inputs.leaves(self.weights)
        masters = [w.detach().to(torch.float32, copy=True) for w in start]
        paths = inputs.leaf_paths(self.weights)
        skip = self.traffic["decay_skip"]
        decays = [not any(p == s or p.startswith(s + ".") for s in skip)
                  for p in paths]
        opt = ref_adamw.AdamW(masters, decays, self.traffic["optimizer"])
        losses, grad = [], None
        with ref.exact_f32():
            for tokens in self.check_batches:
                if rows is not None:
                    tokens = tokens[rows]
                work = [(m.to(w.dtype) if stored else m)
                        .to(torch.float32, copy=True).requires_grad_()
                        for m, w in zip(masters, start)]
                params = inputs.unflatten(self.weights, work)
                total = ref.loss(params, tokens, arch, prec)[0]
                grads = torch.autograd.grad(total, work)
                losses.append(float(total.detach()))
                del params, work, total
                clipped = opt.step(grads)
                del grads
                if grad is None:
                    grad = {p: float(torch.linalg.vector_norm(g))
                            for p, g in zip(paths, clipped)}
                del clipped
        change = {p: float(torch.linalg.vector_norm(m - w.float()))
                  for p, m, w in zip(paths, masters, start)}
        return {"losses": losses, "grad": grad, "change": change}

    def _moved(self, want: dict) -> dict:
        """The leaves that move by more than round-off: a reference
        gradient of ``tiny_leaf`` of the median leaf's or more."""
        med = statistics.median(want["grad"].values())
        return {p: g >= self.traffic["tiny_leaf"] * med
                for p, g in want["grad"].items()}

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers the check compares: the steps' widest relative
        loss gap, and the worst leaf's gap of the first gradient's norm
        and of the change's norm."""
        grad = _leaf_gaps(got["grad"], want["grad"])
        change = _leaf_gaps(got["change"], want["change"], self._moved(want))
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                                zip(got["losses"], want["losses"])),
                "worst_grad_gap": _worst(grad)[0],
                "worst_change_gap": _worst(change)[0]}

    def check(self) -> dict:
        del self.state, self.step_fn
        self.free()
        self.want = self.readings()
        return self.compare({"losses": self.losses, "grad": self.grad,
                             "change": self.change}, self.want)

    def control(self) -> dict:
        """The numbers of the reference in float8 in the program's place
        (after ``check``)."""
        self.control_readings = self.readings(ref.FP8)
        return self.compare(self.control_readings, self.want)

    def details(self, full: bool = False) -> dict:
        """Each step's loss and the leaves that read worst (after
        ``check``, and ``control`` where it ran); ``full``: also the
        program's numbers against the reference with no stored weights,
        its forward reading the f32 master itself."""
        def leaves(got):
            grad = _leaf_gaps(got["grad"], self.want["grad"])
            change = _leaf_gaps(got["change"], self.want["change"],
                                self._moved(self.want))
            return {"worst_grad": _worst(grad), "worst_change": _worst(change),
                    "median_grad": statistics.median(grad.values()),
                    "median_change": statistics.median(change.values())}
        got = {"losses": self.losses, "grad": self.grad,
               "change": self.change}
        out = {"losses": {"program": self.losses,
                          "reference": self.want["losses"]},
               "program": leaves(got),
               "left_out_of_change": sorted(
                   p for p, m in self._moved(self.want).items() if not m)}
        if hasattr(self, "control_readings"):
            out["losses"]["control"] = self.control_readings["losses"]
            out["control"] = leaves(self.control_readings)
        if full:
            master = self.readings(stored=False)
            out["losses"]["master_reference"] = master["losses"]
            out["against_master_reference"] = dict(
                self.compare(got, master), worst_change_leaf=_worst(
                    _leaf_gaps(got["change"], master["change"],
                               self._moved(master)))[1])
        return out

    def faults(self) -> dict:
        """The numbers of the faults a train step can have, planted in
        the reference in the program's place (after ``check``): half of
        each batch left out, the mean taken over the rest; and a step
        that returns its state unchanged (the losses repeat, the first
        moment stays zero, nothing moves)."""
        half = torch.arange(self.shape[0] // 2, device=self.dev)
        unchanged = {"losses": [self.want["losses"][0]] * len(
                         self.want["losses"]),
                     "grad": {p: 0.0 for p in self.want["grad"]},
                     "change": {p: 0.0 for p in self.want["change"]}}
        half = self.readings(rows=half)
        return {"half_batch": self.compare(half, self.want),
                "state_unchanged": self.compare(unchanged, self.want)}
