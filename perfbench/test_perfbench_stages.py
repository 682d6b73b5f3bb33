"""The per-stage readers (``stages.py``) on the CPU, at the cells' reduced
sizes: every one of them finite in a traced run; none of them in the
line of a program without stage spans or a rows counter; the split's
sums within the slice's busy and idle time; and the attribution rules
on a remat MoE block, whose forward, recompute and backward each land
in the stage they belong to."""

import json
import math

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness, stages
from perfbench.cpu_cells import CELLS, args

NEW = {
    "granite-train-zipf-8x2048": {
        "attention_ms.train", "moe_dispatch_ms.train", "moe_experts_ms.train",
        "moe_combine_ms.train", "optimizer_ms.train", "moe_idle_ms.train",
        "moe_drop.train"},
    "qwen3moe-prefill-zipf-8k": {
        "attention_ms.prefill", "moe_dispatch_ms.prefill",
        "moe_experts_ms.prefill", "moe_combine_ms.prefill",
        "moe_idle_ms.prefill", "moe_drop.prefill"},
}


def _line(cell, hook, capsys):
    harness.main(args(cell, trace=1), hook=hook)
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_each_cell_lists_its_stage_metrics():
    names = set()
    for cell in CELLS:
        got = {e["name"] for e in harness.load_cell(cell).per_layer}
        assert NEW[cell] <= got
        names |= NEW[cell]
    assert len(names) == 13


@pytest.mark.parametrize("cell", CELLS)
def test_stage_readers_are_finite_in_a_traced_run(cell, hook, capsys):
    line, err = _line(cell, hook, capsys)
    metrics = line["metrics"]
    assert NEW[cell] <= set(metrics)
    for name in NEW[cell]:
        assert math.isfinite(metrics[name]["value"]), name
        assert metrics[name]["value"] >= 0
    drop = next(v["value"] for n, v in metrics.items()
                if n.startswith("moe_drop."))
    assert 0 < drop < 100
    assert "stage moe.combine: device" in err


@pytest.mark.parametrize("cell", CELLS)
def test_a_program_without_spans_gives_them_nothing(cell, hook, capsys,
                                                    monkeypatch):
    """As the parent commit does: no range opens and nothing counts, so
    the readers return None and the line leaves the metrics out."""
    from repro_torch.obs import telemetry
    monkeypatch.setattr(telemetry, "tracing", lambda: False)
    line, _ = _line(cell, hook, capsys)
    assert not NEW[cell] & set(line["metrics"])
    assert line["correct"] is True


def test_split_sums_stay_within_the_slice(hook, capsys):
    run = harness.start(CELLS[0], 3000000029, 0.1, True, hook)
    got = stages.split(run)
    assert stages.split(run) is got                 # profiled once
    busy, window = got["busy_us"], got["window_us"]
    assert 0 < busy <= window
    assert sum(got["device_us"].values()) <= busy * (1 + 1e-9)
    assert sum(got["idle_us"].values()) == pytest.approx(window - busy)
    assert got["seen"] == set(stages.STAGES)
    assert got["rows"]["routed"] > got["rows"]["kept"] > 0


def _remat_moe_block_events():
    """A profile of one remat'd block (a norm, then the MoE) and its
    backward."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=32, d_expert=16, num_experts=8, top_k=2,
                        dtype="float32")
    p = moe.init(torch.Generator().manual_seed(0), cfg)
    for leaf in (p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"]):
        leaf.requires_grad_()
    x = torch.randn(64, 32, requires_grad=True)

    def block(h):
        return moe.apply_local(
            p, torch.nn.functional.layer_norm(h, (32,)), cfg)[0] + h

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(stages.WINDOW):
            out = torch.utils.checkpoint.checkpoint(
                block, x, use_reentrant=False, preserve_rng_state=False)
            out.sum().backward()
    return prof.events()


def test_forward_recompute_and_backward_land_in_their_stages():
    events = _remat_moe_block_events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    stage = stages._Stages(host)
    under = {}
    for e in host:
        parent = e.cpu_parent
        if parent is not None and parent.name.startswith(stages.EVALUATE):
            under.setdefault(parent.name[len(stages.EVALUATE):], set()).add(
                stage(e))
    # the three gathers' and the products' backward
    assert under["IndexBackward0"] == {"moe.dispatch", "moe.combine"}
    assert under["IndexPutBackward0"] == {"moe.dispatch"}
    assert under["BmmBackward0"] == {"moe.experts"}
    assert under["SoftmaxBackward0"] == {"moe.route"}
    assert under["NativeLayerNormBackward0"] == {stages.OTHER}
    # the recompute: the norm outside any stage is "other", the MoE's
    # operations their own stage, though all run under a backward node
    recompute = [e for e in host if e.name == "aten::layer_norm"
                 and e.cpu_parent is not None
                 and e.cpu_parent.name != stages.WINDOW]
    assert recompute and {stage(e) for e in recompute} == {stages.OTHER}
    bmm = [e for e in host if e.name == "aten::bmm" and e.sequence_nr >= 0]
    assert len(bmm) == 6 and {stage(e) for e in bmm} == {"moe.experts"}
    split = stages.attribute(events, on_device=False)
    assert set(stages.MOE) == split["seen"]
    assert all(split["device_us"][s] > 0 for s in stages.MOE)
