"""The LM path's stage spans and the MoE's rows counter.

``telemetry.span`` opens a profiler range only while the profiler
records, so a step without the profiler enters no ``record_function``
and computes the same bits either way.  Under the profiler every stage
of a train step and a prefill appears, and the backward of each of the
MoE's row gathers points, by its sequence number, at a forward gather
inside ``moe.dispatch`` or ``moe.combine``; each MoE stage's span opens
once an ``apply_local`` call.  ``repro_moe_rows_total``
counts what K7's counts say the layer kept, without reading a tensor
while it counts.  The models are the benchmark's two cells at the sizes
of ``perfbench/cpu_cells.py``.
"""

import collections
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.cpu_cells import SMALL  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels.scatter_add import kernel as sk  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import step as serve_step  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

CONFIGS = {"train": "granite-moe-1b-a400m",
           "prefill": "qwen3-moe-235b-a22b-12l"}
MOE_STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
EVALUATE = "autograd::engine::evaluate_function: "


def _model(kind: str):
    port = json.loads((ROOT / "perfbench" / "configs" /
                       f"{CONFIGS[kind]}.json").read_text())["port"]
    cfg = ModelConfig(**dict(port, **SMALL, dtype="float32"))
    model = registry.build_model(cfg, "cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(7))


def _tokens(cfg, shape, seed=11):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         dtype=torch.int32)


def _train(profiled: bool):
    """One train step from fresh weights: (its metrics and new state,
    the profile's events or None)."""
    cfg, model, params = _model("train")
    tokens = _tokens(cfg, (2, 32))
    step = train_step.make_train_step(model, train_step.TrainConfig(),
                                      adamw.AdamWConfig())
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {"tokens": tokens, "labels": tokens}
    if not profiled:
        return step(state, batch), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(state, batch)
    return out, prof.events()


def _prefill(profiled: bool):
    cfg, model, params = _model("prefill")
    tokens = _tokens(cfg, (2, 32))
    fn = serve_step.make_prefill(model, serve_step.ServeConfig(max_len=32))
    if not profiled:
        return fn(params, tokens)[0], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = fn(params, tokens)[0]
    return logits, prof.events()


def _grads(profiled: bool):
    cfg, model, params = _model("train")
    tokens = _tokens(cfg, (2, 32))
    grad_fn = train_step.make_grad_fn(model, train_step.TrainConfig())
    if not profiled:
        return grad_fn(params, {"tokens": tokens, "labels": tokens})
    with profile(activities=[ProfilerActivity.CPU]):
        return grad_fn(params, {"tokens": tokens, "labels": tokens})


def _bits_equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture
def ranges_entered(monkeypatch):
    """The names of every ``record_function`` made while the test runs."""
    names = []
    real = autograd_profiler.record_function

    class Counted(real):
        def __init__(self, name, *args, **kwargs):
            names.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", Counted)
    return names


@pytest.mark.parametrize("run", [_train, _prefill], ids=["train", "prefill"])
def test_no_profiler_enters_no_range(run, ranges_entered):
    assert not telemetry.tracing()
    run(False)
    assert ranges_entered == []
    run(True)                 # the same spans do open ranges under it
    assert set(MOE_STAGES) <= set(ranges_entered)


def test_profiler_leaves_the_bits_unchanged():
    (state_off, metrics_off), _ = _train(False)
    (state_on, metrics_on), _ = _train(True)
    assert _bits_equal(metrics_off, metrics_on)
    assert _bits_equal(state_off, state_on)
    grads_off, loss_off = _grads(False)
    grads_on, loss_on = _grads(True)
    assert _bits_equal(grads_off, grads_on)
    assert _bits_equal(loss_off, loss_on)
    assert torch.equal(_prefill(False)[0], _prefill(True)[0])


def _ancestor_stage(event):
    """The nearest stage range above ``event``, or None."""
    walk = event.cpu_parent
    while walk is not None:
        if walk.name in ("attention", "train.optimizer", *MOE_STAGES):
            return walk.name
        if walk.name.startswith(EVALUATE):
            return None
        walk = walk.cpu_parent
    return None


@pytest.mark.parametrize("run,want", [
    (_train, {"attention", "train.optimizer", *MOE_STAGES}),
    (_prefill, {"attention", *MOE_STAGES})], ids=["train", "prefill"])
def test_every_span_appears_under_the_profiler(run, want):
    _, events = run(True)
    names = {e.name for e in events if e.device_type == DeviceType.CPU}
    assert want <= names
    assert ("train.optimizer" in names) == (run is _train)


def test_each_gather_backward_points_into_its_moe_stage():
    """Per layer and step: the backward of ``x[order // k]`` maps to
    ``moe.dispatch`` and that of the gates' gather to ``moe.combine``,
    each by its forward thread and sequence number, under remat; no
    gather of the expert output is left to map."""
    (_, _), events = _train(True)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    forward = {}
    for e in cpu:
        if e.name == "aten::index" and e.sequence_nr >= 0:
            forward.setdefault((e.thread, e.sequence_nr), []).append(e)
    found = {"moe.dispatch": 0, "moe.combine": 0}
    for e in cpu:
        if e.name != EVALUATE + "IndexBackward0":
            continue
        made = forward.get((e.fwd_thread, e.sequence_nr), [])
        stages = {_ancestor_stage(f) for f in made}
        assert len(stages) == 1, stages
        stage = stages.pop()
        if stage is not None:
            assert stage in found, stage
            found[stage] += 1
    layers = SMALL["num_layers"]
    assert found == {"moe.dispatch": layers, "moe.combine": layers}


def test_rows_counter_matches_k7_in_every_layer(monkeypatch):
    """``kept`` is, per layer, the sum over experts of min(count, C)
    from K7's counts; ``routed`` is T·k."""
    counts, deltas = [], []
    bincount, dispatch = sk.bincount_launch, moe.dispatch

    def spy_bincount(ids, n):
        out = bincount(ids, n)
        counts.append(out.clone())
        return out

    def spy_dispatch(x, ids, cfg):
        before = (moe.ROWS.value(outcome="routed"),
                  moe.ROWS.value(outcome="kept"))
        out = dispatch(x, ids, cfg)
        deltas.append((moe.ROWS.value(outcome="routed") - before[0],
                       moe.ROWS.value(outcome="kept") - before[1],
                       out["buf"].shape[1]))
        return out

    monkeypatch.setattr(sk, "bincount_launch", spy_bincount)
    monkeypatch.setattr(moe, "dispatch", spy_dispatch)
    cfg, model, params = _model("prefill")
    tokens = _tokens(cfg, (2, 32))
    fn = serve_step.make_prefill(model, serve_step.ServeConfig(max_len=32))
    fn(params, tokens)              # without the profiler nothing counts
    assert deltas and all(d[:2] == (0.0, 0.0) for d in deltas)
    counts.clear()
    deltas.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn(params, tokens)
    assert len(counts) == len(deltas) == SMALL["num_layers"]
    for c, (routed, kept, capacity) in zip(counts, deltas):
        assert routed == tokens.numel() * SMALL["top_k"] == int(c.sum())
        assert kept == int(torch.clamp(c, max=capacity).sum())
        assert 0 < kept < routed          # these layers drop rows


@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("shared", [0, 1])
def test_each_moe_span_opens_once_a_call(grad, shared, ranges_entered):
    """Under the profiler one ``apply_local`` call opens each of its
    stages' spans once, ``moe.shared`` only with a shared expert, with
    and without autograd (the backward opens none)."""
    cfg = moe.MoEConfig(d_model=32, d_expert=16, num_experts=8, top_k=2,
                        num_shared_experts=shared, capacity_factor=1.0,
                        dtype="float32")
    p = moe.init(torch.Generator().manual_seed(0), cfg, 32)
    x = torch.randn(24, 32, generator=torch.Generator().manual_seed(1),
                    requires_grad=grad)
    with torch.set_grad_enabled(grad), \
            profile(activities=[ProfilerActivity.CPU]):
        out = moe.apply_local(p, x, cfg)[0]
        if grad:
            out.sum().backward()
    want = dict.fromkeys(MOE_STAGES + ("moe.shared",) * shared, 1)
    assert collections.Counter(
        n for n in ranges_entered if n.startswith("moe.")) == want


class _Pending:
    """A device count stand-in: adds without being read; reading it (as
    a number or a truth value) raises until ``ready``."""

    ready = False

    def __init__(self, n):
        self.n = n

    def __add__(self, other):
        return _Pending(self.n + other.n)

    def __float__(self):
        if not _Pending.ready:
            raise AssertionError("read while counting")
        return float(self.n)

    def __bool__(self):
        raise AssertionError("read as a truth value")

    def __lt__(self, other):
        raise AssertionError("compared while counting")


def test_counter_keeps_a_tensor_amount_pending(monkeypatch):
    monkeypatch.setattr(_Pending, "ready", False)
    reg = telemetry.MetricsRegistry()
    c = reg.counter("rows_total", "rows", ("outcome",))
    c.inc(_Pending(3), outcome="kept")
    c.inc(_Pending(4), outcome="kept")
    c.inc(2, outcome="kept")
    monkeypatch.setattr(_Pending, "ready", True)
    assert c.value(outcome="kept") == 9.0
    c.inc(torch.tensor(5), outcome="kept")
    assert 'rows_total{outcome="kept"} 14' in reg.render()
    assert c.value(outcome="kept") == 14.0
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1, outcome="kept")
    with telemetry.disabled():
        c.inc(_Pending(1), outcome="kept")
    assert c.value(outcome="kept") == 14.0


def test_span_records_in_a_scope_and_ranges_under_the_profiler(
        ranges_entered):
    with telemetry.trace_scope("t1") as rec:
        with telemetry.span("outer", k=1):
            pass
    assert [s["name"] for s in rec["spans"]] == ["outer"]
    assert ranges_entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.tracing()
        with telemetry.trace_scope("t2") as rec2:
            with telemetry.span("inner"):
                pass
        with telemetry.span("no-scope"):
            pass
    assert not telemetry.tracing()
    assert [s["name"] for s in rec2["spans"]] == ["inner"]
    assert ranges_entered == ["inner", "no-scope"]
