"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault its cell can have: a step that returns its state
unchanged, half of the batch left out, a token or an answer altered
where it is produced.  (One chip: no exchange between chips to leave
out.  A train step produces no token.)  The harness runs as it does on
the card, but on the CPU at a reduced size (``harness.Hook``)."""

import pytest
import torch

from perfbench import harness
from perfbench.cpu_cells import args


def _correct(cell, hook, capsys) -> bool:
    result = harness.main(args(cell), hook=hook)
    capsys.readouterr()
    return result["correct"]


# -- train ---------------------------------------------------------------------


def _train_state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update(grads, state, cfg, params, decay=None):
        zero = torch.zeros(())
        return params, state, {"grad_norm": zero, "lr": zero}
    monkeypatch.setattr(adamw, "update", update)


def _train_half_batch(monkeypatch):
    from repro_torch.train import step as train_step
    real = train_step.make_train_step

    def make(model, tcfg, ocfg, grad_pspecs=None):
        step = real(model, tcfg, ocfg, grad_pspecs)

        def half(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})
        return half
    monkeypatch.setattr(train_step, "make_train_step", make)


# -- prefill -------------------------------------------------------------------


def _wrap_prefill(monkeypatch, alter):
    from repro_torch.serve import step as serve_step
    real = serve_step.make_prefill

    def make(model, scfg):
        prefill = real(model, scfg)

        def broken(params, tokens, extras=None):
            logits, cache = prefill(params, tokens, extras)
            return alter(logits), cache
        return broken
    monkeypatch.setattr(serve_step, "make_prefill", make)


def _prefill_answer_altered(monkeypatch):
    def alter(logits):
        logits[0, -1] = -logits[0, -1]     # the served token: the worst
        return logits
    _wrap_prefill(monkeypatch, alter)


def _prefill_half_batch(monkeypatch):
    def alter(logits):
        half = logits.shape[0] // 2
        logits[half:] = logits[:logits.shape[0] - half]
        return logits
    _wrap_prefill(monkeypatch, alter)


FAULTS = [
    ("granite-train-zipf-8x2048", _train_state_unchanged),
    ("granite-train-zipf-8x2048", _train_half_batch),
    ("qwen3moe-prefill-zipf-8k", _prefill_answer_altered),
    ("qwen3moe-prefill-zipf-8k", _prefill_half_batch),
]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f.__name__.lstrip("_") for _, f in FAULTS])
def test_a_broken_timed_path_reads_not_correct(cell, plant, hook, capsys,
                                              monkeypatch):
    assert _correct(cell, hook, capsys)              # sound, as a control
    plant(monkeypatch)
    assert not _correct(cell, hook, capsys)
