"""The Granite 4.0-H fields of ``ModelConfig`` at their defaults add no
operation: the forwards of the benchmark's granite-moe-1b-a400m and
qwen3-moe configurations, at a reduced size on meta tensors, run each
aten and ``repro_torch`` operation as many times as before those fields
existed (the counts below were read at that commit, by the same code):
no multiplier, softmax scale, norm epsilon or shared expert adds one.
The granite case under grad is the train cell's forward at these widths,
whose head_dim 16 keeps attention under grad on the plain path (the
cell's own 64 takes K8's forward with its backward:
``tests/test_torch_flash_grad.py``).  The forwards without grad have
run one ``aten.cat`` and one ``aten.full`` more a layer since the MoE
dispatch gathers its buffer slot by slot there (``moe._slot_buffer``: a
zero row past x and each slot's token); every other count is the one
read at that commit."""

import collections
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.cpu_cells import SMALL  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402

GRANITE = {
    "aten._softmax": 2, "aten._to_copy": 39, "aten._unsafe_view": 11,
    "aten.add": 17, "aten.arange": 6, "aten.bitwise_and": 2,
    "aten.bmm": 6, "aten.cat": 6, "aten.clamp": 4, "aten.clone": 4,
    "aten.cos": 4, "aten.cumsum": 2, "aten.div": 6, "aten.embedding": 1,
    "aten.eq": 2, "aten.full": 4, "aten.index": 8, "aten.index_put_": 4,
    "aten.lift_fresh": 4, "aten.lt": 4, "aten.mean": 9, "aten.mm": 11,
    "aten.mul": 45, "aten.new_zeros": 4, "aten.permute": 1,
    "aten.rsqrt": 5, "aten.scalar_tensor": 2, "aten.scatter": 2,
    "aten.select": 2, "aten.silu": 2, "aten.sin": 4, "aten.slice": 18,
    "aten.sort": 4, "aten.sub": 8, "aten.sum": 4, "aten.transpose": 8,
    "aten.unsqueeze": 8, "aten.view": 29, "aten.where": 2,
    "repro_torch.bincount": 2, "repro_torch.flash_attention": 2,
    "repro_torch.scatter_add": 2}
GRANITE_GRAD = {
    "aten._softmax": 4, "aten._to_copy": 45, "aten._unsafe_view": 13,
    "aten.add": 19, "aten.arange": 6, "aten.bitwise_and": 4,
    "aten.bmm": 10, "aten.cat": 4, "aten.clamp": 4, "aten.clone": 4,
    "aten.cos": 4, "aten.cumsum": 2, "aten.detach": 9, "aten.div": 6,
    "aten.embedding": 1, "aten.eq": 2, "aten.full": 2, "aten.ge": 2,
    "aten.index": 8, "aten.index_put_": 4, "aten.le": 2,
    "aten.lift_fresh": 4, "aten.lt": 4, "aten.mean": 9, "aten.mm": 11,
    "aten.mul": 47, "aten.new_zeros": 4, "aten.permute": 21,
    "aten.rsqrt": 5, "aten.scalar_tensor": 6, "aten.scatter": 2,
    "aten.select": 2, "aten.silu": 2, "aten.sin": 4, "aten.slice": 18,
    "aten.sort": 4, "aten.sub": 8, "aten.sum": 4, "aten.transpose": 8,
    "aten.unsqueeze": 26, "aten.view": 47, "aten.where": 4,
    "repro_torch.bincount": 2, "repro_torch.scatter_add": 2}
QWEN3 = {
    "aten._softmax": 2, "aten._to_copy": 39, "aten._unsafe_view": 11,
    "aten.add": 17, "aten.arange": 6, "aten.bitwise_and": 2,
    "aten.bmm": 6, "aten.cat": 6, "aten.clamp": 4, "aten.clone": 4,
    "aten.cos": 4, "aten.cumsum": 2, "aten.div": 6, "aten.embedding": 1,
    "aten.eq": 2, "aten.full": 4, "aten.index": 8, "aten.index_put_": 4,
    "aten.lift_fresh": 4, "aten.lt": 4, "aten.mean": 9, "aten.mm": 11,
    "aten.mul": 45, "aten.new_zeros": 4, "aten.rsqrt": 5,
    "aten.scalar_tensor": 2, "aten.scatter": 2, "aten.select": 2,
    "aten.silu": 2, "aten.sin": 4, "aten.slice": 18, "aten.sort": 4,
    "aten.sub": 8, "aten.sum": 4, "aten.transpose": 8,
    "aten.unsqueeze": 8, "aten.view": 29, "aten.where": 2,
    "repro_torch.bincount": 2, "repro_torch.flash_attention": 2,
    "repro_torch.scatter_add": 2}
CASES = [("granite-moe-1b-a400m", False, GRANITE),
         ("granite-moe-1b-a400m", True, GRANITE_GRAD),
         ("qwen3-moe-235b-a22b-12l", False, QWEN3)]


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("name,grad,want", CASES,
                         ids=[f"{n}-{'grad' if g else 'nograd'}"
                              for n, g, _ in CASES])
def test_forward_runs_the_operations_it_ran(name, grad, want):
    port = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["port"]
    cfg = ModelConfig(**dict(port, **SMALL, remat="none"))
    model = registry.build_model(cfg, "meta")
    params = model.init(layers.MetaGenerator())
    if grad:
        for leaf in _leaves(params):
            leaf.requires_grad_()
    tokens = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    with torch.set_grad_enabled(grad), _Count() as count:
        model.forward(params, tokens)
    assert dict(count.ops) == want
