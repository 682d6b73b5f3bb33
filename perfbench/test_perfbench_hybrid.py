"""The hybrid prefill cell (``granite4h-prefill-zipf-32k``) on the CPU,
through the harness's own code at a reduced size (``harness.Hook``): the
result line, the program against the plain reference and the float8
control failing a limit, a planted fault in the SSD's recurrence across
chunks, ``counts_hybrid.py`` against the FLOP counter at the published
widths, and ``stages_hybrid.py``'s split."""

import json
import math
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts_hybrid, harness, stages_hybrid
from perfbench.cpu_cells import SMALL, args

HERE = Path(__file__).resolve().parent
CELL = "granite4h-prefill-zipf-32k"
CONFIG = HERE / "configs" / "hybrid" / "granite-4.0-h-small-20l.json"
# the stage metrics a traced CPU run reads (the rooflines and the MFU
# read nothing off the card)
STAGE_METRICS = {"device_idle.hybrid_prefill", "ssm_ms.hybrid_prefill",
                 "ssm_scan_us_per_chunk.hybrid_prefill",
                 "ssm_idle_ms.hybrid_prefill", "moe_ms.hybrid_prefill",
                 "moe_drop.hybrid_prefill"}
CHUNK = 16


def shrink(arch: dict, traffic: dict) -> None:
    """The cell at a CPU test's size: ``cpu_cells.SMALL``'s widths, two
    periods of one Mamba-2 and one attention layer, a shared expert twice
    an expert's width, chunks of 16; batches of 64 tokens.  The embedding
    multiplier keeps the embedding's share of the residual stream at the
    published width's (12 / sqrt(4096) = 1.5 / sqrt(64)): at 12 the tied
    head would read little but the embedding here."""
    arch.update(SMALL, num_layers=4, layer_types=["mamba", "attention"] * 2,
                d_shared=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=CHUNK,
                embedding_multiplier=1.5, dtype="float32")
    traffic.update(shapes=[[1, 64], [2, 32], [4, 16]], roofline_tokens=64,
                   sample_range=3, trace_units=2)


@pytest.fixture
def small(hook):
    return harness.Hook(device="cpu", adjust=shrink)


def test_the_cell_is_in_the_benchmark():
    cell = harness.load_cell(CELL)
    assert cell.traffic["kind"] == "hybrid_prefill" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "prefill_tokens_per_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names == STAGE_METRICS | {"mfu.hybrid_prefill",
                                     "ssm_roofline.hybrid_prefill",
                                     "moe_roofline.hybrid_prefill"}
    assert set(cell.limits["numbers"]) >= {"mean_gap", "logit_gap"}


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
        assert 0 < line["metrics"]["moe_drop.hybrid_prefill"]["value"] < 100
        assert "stage ssm.scan: device" in err
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


def test_state_dropped_between_chunks_reads_not_correct(small, capsys,
                                                        monkeypatch):
    """Each chunk of the SSD computed from a zero state, as if the state
    passed from one chunk to the next were lost: the rows' logits move
    past a limit."""
    assert harness.main(args(CELL), hook=small)["correct"]
    from repro_torch.models import mamba2
    real = mamba2._ssd_chunked

    def each_chunk_alone(x, dt, a, b_mat, c_mat, chunk):
        t = x.shape[1]
        ys = [real(x[:, i:i + chunk], dt[:, i:i + chunk], a,
                   b_mat[:, i:i + chunk], c_mat[:, i:i + chunk], chunk)[0]
              for i in range(0, t, chunk)]
        return torch.cat(ys, 1), None
    monkeypatch.setattr(mamba2, "_ssd_chunked", each_chunk_alone)
    result = harness.main(args(CELL), hook=small)
    capsys.readouterr()
    assert not result["correct"], result["checks"]


# -- the counts ------------------------------------------------------------


def _published(**over) -> dict:
    return {**json.loads(CONFIG.read_text())["port"], **over}


def _model(arch: dict):
    from repro_torch.configs.base import PortConfig
    from repro_torch.models import layers, registry
    cfg = PortConfig(**{**arch, "remat": "none"})
    model = registry.build_model(cfg, "meta")
    return cfg, model, model.init(layers.MetaGenerator())


@pytest.mark.parametrize("b,t", [(2, 256), (1, 300)])
def test_forward_flops_equal_the_flop_counter(b, t):
    """At the published widths, one layer of each kind; the SSD's square
    and attention's whole, each expert's capacity, the padded vocabulary,
    a sequence padded to whole chunks; the model FLOPs count less."""
    arch = _published(num_layers=2, layer_types=["mamba", "attention"])
    cfg, model, params = _model(arch)
    tokens = torch.zeros((b, t), dtype=torch.int32, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.forward(params, tokens)
    e = arch["num_experts"]
    rows = e * max(1, int(b * t * arch["top_k"] / e
                          * arch["moe_capacity_factor"]))
    want = counts_hybrid.forward_flops(arch, b, t, causal_fraction=1.0,
                                       vocab=cfg.padded_vocab,
                                       expert_rows=rows)
    assert fc.get_total_flops() == want
    assert counts_hybrid.forward_flops(arch, b, t) < want


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


TINY = dict(SMALL, ssm_state=16, ssm_head_dim=16, ssm_chunk=CHUNK,
            d_shared=64, moe_capacity_factor=1.25)


def test_ssm_bytes_read_each_input_once(torch_threads):
    from repro_torch.models import mamba2
    cfg = mamba2.Mamba2Config(d_model=64, state_dim=16, head_dim=16,
                              chunk=CHUNK)
    p = mamba2.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 40, 64).to(torch.bfloat16)
    with torch.no_grad():
        out = mamba2.apply(p, x, cfg)
    nbytes = sum(t.numel() * t.element_size()
                 for t in [x, out, *_leaves(p)])
    assert counts_hybrid.ssm_bytes(TINY, 40) == nbytes


def test_moe_bytes_read_each_input_once(torch_threads):
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_expert=32, num_experts=8, top_k=2,
                        num_shared_experts=1)
    p = moe.init(torch.Generator().manual_seed(0), cfg, 64)
    x = torch.randn(40, 64).to(torch.bfloat16)
    with torch.no_grad():
        out = moe.apply_local(p, x, cfg)[0]
    nbytes = sum(t.numel() * t.element_size()
                 for t in [x, out, *_leaves(p)])
    assert counts_hybrid.moe_bytes(TINY, 40) == nbytes


# -- the stages --------------------------------------------------------------


def test_ssd_and_shared_expert_land_in_their_stages(small):
    run = harness.start(CELL, 3000000029, 0.1, True, small)
    got = stages_hybrid.split(run)
    assert stages_hybrid.split(run) is got              # profiled once
    assert got["seen"] == set(stages_hybrid.STAGES)
    # the SSD's chunk loop and its products; the shared MLP's products
    assert {"aten::cumsum", "aten::stack"} <= set(got["kernels"]["ssm.scan"])
    assert not {"aten::cumsum", "aten::stack"} & set(got["kernels"]["ssm"])
    assert "aten::mm" in got["kernels"]["moe.shared"]
    assert "aten::bmm" not in got["kernels"]["moe.shared"]
    busy, window = got["busy_us"], got["window_us"]
    assert 0 < busy <= window
    assert sum(got["device_us"].values()) <= busy * (1 + 1e-9)
    assert sum(got["idle_us"].values()) == pytest.approx(window - busy)
    units = run.traffic["trace_units"]
    assert got["chunks"] == units * 2 * (64 // CHUNK)   # 2 Mamba layers
    assert got["rows"]["routed"] > got["rows"]["kept"] > 0
    ssm = stages_hybrid.union_ms(run, stages_hybrid.SSM)
    assert ssm >= got["device_us"]["ssm.scan"] / 1e3 / units > 0


def test_nearest_stage_decides():
    """An operation under ``ssm.scan`` inside ``ssm`` is the scan's; one
    under no stage is "other"."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(stages_hybrid.WINDOW):
            with record_function("ssm"):
                torch.ones(4).add_(1)
                with record_function("ssm.scan"):
                    with record_function("inner"):
                        torch.ones(4).cumsum(0)
            torch.ones(4).mul_(2)
    split = stages_hybrid.attribute(prof.events(), on_device=False)
    assert "aten::cumsum" in split["kernels"]["ssm.scan"]
    assert "aten::add_" in split["kernels"]["ssm"]
    assert "aten::mul_" in split["kernels"]["other"]
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    assert {"ssm", "ssm.scan"} <= {e.name for e in host}


def test_a_program_without_spans_gives_them_nothing(small, capsys,
                                                    monkeypatch):
    from repro_torch.obs import telemetry
    monkeypatch.setattr(telemetry, "tracing", lambda: False)
    result = harness.main(args(CELL, trace=1), hook=small)
    capsys.readouterr()
    assert set(result["metrics"]) == {"device_idle.hybrid_prefill"}
    assert result["correct"] is True
