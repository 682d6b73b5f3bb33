"""``counts.py`` against what the program does: its FLOP formulas equal
``torch.utils.flop_counter.FlopCounterMode`` over the program's own
steps on meta tensors, at the two configurations' published widths and
two layers, but for the exclusions ``counts.py`` states (attention's
masked half, the capacity's empty expert slots; the train loss's last
position); its byte counts read each input of a call once and write each
output once."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts

HERE = Path(__file__).resolve().parent
CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))


def _arch(name: str, **over) -> dict:
    arch = json.loads((HERE / "configs" / f"{name}.json").read_text())["port"]
    return {**arch, "num_layers": 2, **over}


def _model(arch: dict):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers, registry
    cfg = ModelConfig(**{**arch, "remat": "none"})
    model = registry.build_model(cfg, "meta")
    return cfg, model, model.init(layers.MetaGenerator())


def _capacity_rows(arch: dict, tokens: int) -> int:
    e = arch["num_experts"]
    cap = max(1, int(tokens * arch["top_k"] / e * arch["moe_capacity_factor"]))
    return e * cap


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_equal_the_flop_counter(name):
    arch = _arch(name)
    cfg, model, params = _model(arch)
    b, t = 2, 256
    tokens = torch.zeros((b, t), dtype=torch.int32, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.forward(params, tokens)
    want = counts.forward_flops(arch, b, t, causal_fraction=1.0,
                                vocab=cfg.padded_vocab,
                                expert_rows=_capacity_rows(arch, b * t))
    assert fc.get_total_flops() == want
    # the model FLOPs: causal attention at half, each token's top-k
    # experts, the published vocabulary
    assert counts.forward_flops(arch, b, t) < want


@pytest.mark.parametrize("name", CONFIGS)
def test_train_flops_equal_the_flop_counter(name):
    arch = _arch(name)
    cfg, model, params = _model(arch)
    b, t = 2, 128
    tokens = torch.zeros((b, t), dtype=torch.int32, device="meta")
    live = [p.requires_grad_() for p in _leaves(params)]
    with FlopCounterMode(display=False) as fc:
        total, _ = model.loss(params, {"tokens": tokens, "labels": tokens})
        torch.autograd.grad(total, live, allow_unused=True)
    n = b * t
    per_layer = (counts.attention_flops(arch, b, t, causal_fraction=1.0)
                 + counts.moe_flops(arch, n, _capacity_rows(arch, n)))
    head = counts.head_flops(arch, b * (t - 1), cfg.padded_vocab)
    assert fc.get_total_flops() == 3 * (arch["num_layers"] * per_layer
                                        + head)
    assert counts.train_flops(arch, b, t) == 3 * counts.forward_flops(
        arch, b, t)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


TINY = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
            num_experts=8, top_k=2, d_expert=32, moe_capacity_factor=1.25)


@pytest.mark.parametrize("backward", [False, True])
def test_moe_bytes_read_each_input_once(backward, torch_threads):
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_expert=32, num_experts=8, top_k=2)
    gen = torch.Generator().manual_seed(0)
    p = moe.init(gen, cfg)
    x = torch.randn(40, 64, generator=gen).to(torch.bfloat16)
    inputs = [x, *_leaves(p)]
    with torch.set_grad_enabled(backward):
        if backward:
            for t in inputs:
                t.requires_grad_()
        out = moe.apply_local(p, x, cfg)[0]
        outputs = [out]
        if backward:
            g = torch.ones_like(out)
            grads = torch.autograd.grad(out, inputs, g)
            inputs.append(g)
            outputs.extend(grads)
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    assert counts.moe_bytes(TINY, 40, backward) == nbytes


def test_attention_bytes_read_each_input_once(torch_threads):
    from repro_torch.models import attention
    acfg = attention.AttnConfig(d_model=64, num_heads=4, num_kv_heads=2,
                                head_dim=16)
    p = attention.init(torch.Generator().manual_seed(0), acfg)
    x = torch.randn(2, 12, 64).to(torch.bfloat16)
    with torch.no_grad():
        out, _ = attention.attend(p, x, acfg)
    nbytes = sum(t.numel() * t.element_size()
                 for t in [x, out, *_leaves(p)])
    assert counts.attention_bytes(TINY, 2, 12) == nbytes


def test_roofline_share_takes_the_larger_bound():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    share, bound = counts.roofline_share(989e12, 0.0, 2.0, peak)
    assert (share, bound) == (50.0, "flops")
    share, bound = counts.roofline_share(0.0, 3.35e12, 4.0, peak)
    assert (share, bound) == (25.0, "bytes")
