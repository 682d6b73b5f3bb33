"""The latent-attention prefill cell (``deepseekv3-prefill-zipf-16k``) on
the CPU, through the harness's own code at a reduced size
(``harness.Hook``): the result line, the program against the plain
reference and the float8 control failing a limit, planted faults (the
rotation on the wrong columns, YaRN's temperature left out, the
selection bias in the weights) each read not ``correct``,
``counts_mla.py`` against the FLOP counter at the published widths, and
``stages_mla.py``'s split."""

import json
import math
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts_mla, harness, stages_mla
from perfbench.cpu_cells import SMALL, args

HERE = Path(__file__).resolve().parent
CELL = "deepseekv3-prefill-zipf-16k"
CONFIG = HERE / "configs" / "mla" / "deepseek-v3-ep32-32l.json"
# the stage metrics a traced CPU run reads (the roofline and the MFU read
# nothing off the card)
STAGE_METRICS = {"device_idle.mla_prefill", "mla_ms.mla_prefill",
                 "mla_attend_ms.mla_prefill", "moe_ms.mla_prefill",
                 "moe_drop.mla_prefill", "moe_held.mla_prefill"}


def shrink(arch: dict, traffic: dict) -> None:
    """The cell at a CPU test's size: ``cpu_cells.SMALL``'s widths but its
    head size (MLA has its own: q·k 16 + 8, v 16), one dense layer and
    three MoE layers, two groups of four experts of which one is kept,
    half the experts held; batches of 64 tokens."""
    small = {k: v for k, v in SMALL.items() if k != "head_dim"}
    arch.update(small, num_layers=4, num_kv_heads=4, first_k_dense=1,
                d_ff_dense=64, q_lora_rank=48, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                n_group=2, topk_group=1, experts_held=4, dtype="float32")
    traffic.update(shapes=[[1, 64], [2, 32], [4, 16]], roofline_tokens=64,
                   sample_range=3, trace_units=2)


@pytest.fixture
def small(hook):
    return harness.Hook(device="cpu", adjust=shrink)


def test_the_cell_is_in_the_benchmark():
    cell = harness.load_cell(CELL)
    assert cell.traffic["kind"] == "mla_prefill" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "prefill_tokens_per_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names == STAGE_METRICS | {"mfu.mla_prefill",
                                     "mla_attention_roofline.mla_prefill"}
    assert set(cell.limits["numbers"]) == {"mean_gap", "logit_err"}
    assert cell.config["published"] == {"num_hidden_layers": 61,
                                        "n_routed_experts": 256}
    arch = cell.arch
    assert (arch["num_experts"], arch["experts_held"], arch["num_layers"],
            arch["first_k_dense"]) == (256, 8, 32, 3)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_prints_the_contract_line(trace, small, capsys):
    result = harness.main(args(CELL, trace=trace), hook=small)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    if trace:
        assert set(line["metrics"]) == STAGE_METRICS
        for name, m in line["metrics"].items():
            assert math.isfinite(m["value"]) and m["value"] >= 0, name
        assert 0 < line["metrics"]["moe_held.mla_prefill"]["value"] < 100
        assert "stage mla.attend: device" in err
        assert "stage moe.shared: device" in err
    else:
        assert set(line["metrics"]) == {"setup_s", "prefill_tokens_per_s"}


def _started(small, seed=3000000023):
    run = harness.start(CELL, seed, 0.3, False, small)
    harness.window(run)
    return run


def test_program_agrees_and_the_control_fails(small):
    """In f32 the program reads far inside every limit; the reference in
    float8 in its place fails one, and an altered answer fails one."""
    limits = harness.load_cell(CELL).limits["numbers"]
    run = _started(small)
    got = run.driver.check()
    assert set(limits) <= set(got)
    for name in limits:
        assert got[name] <= 0.1 * limits[name]["limit"], (name, got[name])
    for bad in (run.driver.control(),
                run.driver.faults()["answer_altered"]):
        assert any(bad[n] > limits[n]["limit"] for n in limits), bad


def _rotate_halves(x, cos, sin):
    """The rotation on the two halves of the rotary columns, as the other
    models' RoPE, not on adjacent pairs."""
    from repro_torch.models import layers
    return layers.apply_rope(x, cos, sin)


def _bias_in_the_weights(monkeypatch):
    """The router weighs the chosen experts by their biased scores."""
    from repro_torch.models import moe
    real = moe._route_sigmoid

    def route(p, x, cfg):
        _, ids, aux = real(p, x, cfg)
        s = torch.sigmoid(x.float() @ p["router"]["w"].float()) \
            + p["score_bias"].float()
        g = s.gather(1, ids.long())
        return g / g.sum(-1, keepdim=True) * cfg.routed_scale, ids, aux
    monkeypatch.setattr(moe, "_route_sigmoid", route)


def _mscale_left_out(monkeypatch):
    from repro_torch.models import mla
    monkeypatch.setattr(mla.MLAConfig, "scale", property(
        lambda self: self.qk_head_dim ** -0.5))


def _wrong_halves(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "apply_rope_pairs", _rotate_halves)


@pytest.mark.parametrize("plant", [_wrong_halves, _mscale_left_out,
                                   _bias_in_the_weights])
def test_planted_faults_read_not_correct(plant, small, capsys, monkeypatch):
    assert harness.main(args(CELL), hook=small)["correct"]
    plant(monkeypatch)
    result = harness.main(args(CELL), hook=small)
    capsys.readouterr()
    assert not result["correct"], result["checks"]


# -- the counts ------------------------------------------------------------


def _published(**over) -> dict:
    return {**json.loads(CONFIG.read_text())["port"], **over}


@pytest.mark.parametrize("b,t", [(2, 64), (1, 100)])
def test_forward_flops_equal_the_flop_counter(b, t):
    """At the published widths, one dense layer and one MoE layer: the
    attention's whole square (K8's formula), the held experts' capacity
    slots, the shared expert, the router over all 256; the model FLOPs
    count less."""
    from repro_torch.configs.base import PortConfig
    from repro_torch.models import layers, registry
    arch = _published(num_layers=2, first_k_dense=1)
    cfg = PortConfig(**arch)
    model = registry.build_model(cfg, "meta")
    params = model.init(layers.MetaGenerator())
    tokens = torch.zeros((b, t), dtype=torch.int32, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.forward(params, tokens)
    slots = arch["experts_held"] * max(1, int(
        b * t * arch["top_k"] / arch["num_experts"]
        * arch["moe_capacity_factor"]))
    want = counts_mla.forward_flops(arch, b, t, causal_fraction=1.0,
                                    vocab=cfg.padded_vocab,
                                    expert_rows=slots)
    assert fc.get_total_flops() == want
    assert counts_mla.forward_flops(arch, b, t) < want


def test_the_roofline_bound_of_a_16k_prefill():
    """K8's 128 heads at 16,384 tokens: 1.1e13 useful flop, 11.1 ms at
    989 TFLOP/s, far above the bytes' 0.8 ms at 3.35 TB/s."""
    arch = _published()
    flops = counts_mla.mla_attention_flops(arch, 1, 16384)
    assert flops == 128 * 2 * (192 + 128) * 16384 ** 2 / 2
    assert round(flops / 989e12 * 1e3, 1) == 11.1
    assert counts_mla.mla_attention_bytes(arch, 1, 16384) / 3.35e12 < 1e-3


# -- the stages --------------------------------------------------------------


def test_k8_and_the_projections_land_in_their_stages(small):
    run = harness.start(CELL, 3000000029, 0.1, True, small)
    got = stages_mla.split(run)
    assert stages_mla.split(run) is got                  # profiled once
    assert got["seen"] == set(stages_mla.STAGES)
    # K8 (off the card its plain version's softmax) in the core; the
    # projections and rotations around it in "mla"
    assert "aten::amax" in got["kernels"]["mla.attend"]
    assert "aten::amax" not in got["kernels"]["mla"]
    assert {"aten::mm", "aten::stack"} <= set(got["kernels"]["mla"])
    assert "aten::bmm" in got["kernels"]["moe.experts"]
    busy, window = got["busy_us"], got["window_us"]
    assert 0 < busy <= window
    assert sum(got["device_us"].values()) <= busy * (1 + 1e-9)
    assert sum(got["idle_us"].values()) == pytest.approx(window - busy)
    units = run.traffic["trace_units"]
    assert got["tokens"] == units * 64
    assert got["rows"]["routed"] >= got["rows"]["kept"] > 0
    assert stages_mla.union_ms(run, stages_mla.MLA) >= stages_mla.union_ms(
        run, ("mla.attend",)) > 0
    assert 0 < stages_mla.held_percent(run) <= 100


def test_a_program_without_spans_gives_them_nothing(small, capsys,
                                                    monkeypatch):
    from repro_torch.obs import telemetry
    monkeypatch.setattr(telemetry, "tracing", lambda: False)
    result = harness.main(args(CELL, trace=1), hook=small)
    capsys.readouterr()
    assert set(result["metrics"]) == {"device_idle.mla_prefill"}
    assert result["correct"] is True
