"""The train check's reference keeps AdamW's master in f32 and reads it,
at every step, as the configuration stores its weights: each leaf
rounded to that leaf's dtype, then computed in f32."""

import pytest
import torch

from perfbench import harness, inputs
from perfbench.cpu_cells import shrink
from perfbench.reference import model as ref


def _bf16(arch, traffic):
    shrink(arch, traffic, dtype="bfloat16")


@pytest.mark.parametrize("stored", [True, False])
def test_each_step_reads_the_master_as_stored(stored, torch_threads,
                                             monkeypatch):
    run = harness.start("granite-train-zipf-8x2048", 3000000029, 0.1,
                        False, harness.Hook(device="cpu", adjust=_bf16))
    d = run.driver
    seen = []
    real = ref.loss

    def loss(params, tokens, arch, prec):
        seen.append([t.detach().clone() for t in inputs.leaves(params)])
        return real(params, tokens, arch, prec)
    monkeypatch.setattr(ref, "loss", loss)
    got = d.readings(stored=stored)
    assert len(seen) == len(d.check_batches) == 3
    start = inputs.leaves(d.weights)
    assert all(t.dtype == torch.float32 for t in seen[0])
    assert all(torch.equal(t, w.float()) for t, w in zip(seen[0], start))
    moved = [t for t, w in zip(seen[-1], start) if not torch.equal(
        t, w.float())]
    assert moved                          # the steps moved the weights
    rounded = [torch.equal(t, t.to(w.dtype).float())
               for t, w in zip(seen[-1], start)]
    assert all(rounded) if stored else not all(rounded)
    assert len(got["losses"]) == 3 and set(got["change"]) == set(
        inputs.leaf_paths(d.weights))
