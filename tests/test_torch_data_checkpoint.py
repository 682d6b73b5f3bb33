"""The port's data pipeline, checkpoints, fault-tolerance runtime and
training launcher against the reference's.

The data stream is held to the reference's bit for bit (the same numpy
Philox); checkpoints round-trip bit for bit, bf16 leaves included, and a
tree saved by either package restores in the other; the runtime's tests
are the reference's ``tests/test_runtime.py`` on the port.
``launch.train`` on the CPU, with a failure and a restart, follows the
reference's ``launch.train`` from the same initial parameters: each
step's xent within 1e-3 relative (they agree within about 3e-7; the
bound leaves room for f32 sums taken in other orders to compound over 20
AdamW steps, whose first steps move each weight by about lr x sign(g)).
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import store as ref_store
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import train as ref_launch
from repro.train import step as ref_train
from _port_compare import load_example
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import stragglers
from repro_torch.train import step as train_mod

CPU = "cpu"
XENT_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the test workers share the machine's
    cores, where torch's thread pools in several processes only contend
    (a training loop ran 20 times slower beside one other worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipe(gb=8, seq=32, seed=7):
    return SyntheticLM(DataConfig(vocab_size=1000, seq_len=seq,
                                  global_batch=gb, seed=seed))


# -- the data pipeline -------------------------------------------------------


@pytest.mark.parametrize("alpha,vocab,seed", [(1.1, 49155, 0), (1.2, 4096, 3),
                                              (0.0, 1000, 7), (0.5, 7, 1)])
def test_tokens_equal_the_reference(alpha, vocab, seed):
    """Global batches and shards, bit for bit the reference's."""
    kw = dict(vocab_size=vocab, seq_len=64, global_batch=4, seed=seed,
              zipf_alpha=alpha)
    ours, theirs = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(
        RefDataConfig(**kw))
    for step in (0, 1, 17):
        a = ours.global_batch_at(step)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, theirs.global_batch_at(step))
        np.testing.assert_array_equal(ours.shard_batch_at(step, 1, 2),
                                      theirs.shard_batch_at(step, 1, 2))
    for k, v in ours.batch_dict(2).items():
        np.testing.assert_array_equal(v, theirs.batch_dict(2)[k])


def test_restart_replay_exact():
    """Batches at step s are identical across fresh pipeline objects."""
    a, b = _pipe(), _pipe()
    for step in (0, 3, 17):
        np.testing.assert_array_equal(a.global_batch_at(step),
                                      b.global_batch_at(step))


@settings(max_examples=20, deadline=None)
@given(step=st.integers(0, 50), num_shards=st.sampled_from([1, 2, 4, 8]))
def test_shards_partition_global_batch(step, num_shards):
    p = _pipe()
    g = p.global_batch_at(step)
    parts = [p.shard_batch_at(step, s, num_shards) for s in range(num_shards)]
    np.testing.assert_array_equal(np.concatenate(parts), g)


def test_distinct_steps_distinct_data():
    p = _pipe()
    assert not np.array_equal(p.global_batch_at(0), p.global_batch_at(1))


def test_zipf_skew():
    p = _pipe(gb=32, seq=256)
    counts = np.bincount(p.global_batch_at(0).ravel(), minlength=1000)
    assert counts.max() > 20 * max(np.median(counts), 1)


# -- checkpoints -------------------------------------------------------------


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1.0, -2.5], dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)},
            "layers": [{"w": torch.full((2,), 0.1)}, {}]}


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 5, t)
    restored, step = store.restore(str(tmp_path), t)
    assert step == 5
    _assert_trees_equal(restored, t)
    assert sorted(os.listdir(tmp_path / "step_5")) == [
        "leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
        "leaf_00003.npy", "manifest.json"]


def test_restore_puts_each_leaf_on_the_device_of_like(tmp_path):
    """Each leaf goes to the device of ``like``'s leaf: here the meta
    device stands for a card; a leaf of another shape raises."""
    t = _tree()
    store.save(str(tmp_path), 1, t)
    like = dict(t, a=t["a"].to("meta"))
    restored, _ = store.restore(str(tmp_path), like)
    assert restored["a"].device.type == "meta"
    assert restored["b"]["c"].device.type == "cpu"
    with pytest.raises(ValueError, match="leaf_00000"):
        store.restore(str(tmp_path), dict(t, a=torch.zeros(4, 3)))


def test_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        store.save(str(tmp_path), s, t)
    assert store.latest_step(str(tmp_path)) == 4
    store.gc(str(tmp_path), keep=2)
    dirs = sorted(os.listdir(str(tmp_path)))
    assert "step_3" in dirs and "step_4" in dirs and "step_1" not in dirs


def test_torn_write_never_visible(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 1, t)
    # a crashed writer's stray tmp dir must not be visible
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_9"))
    assert store.latest_step(str(tmp_path)) == 1
    _, step = store.restore(str(tmp_path), t)
    assert step == 1


def test_async_checkpointer(tmp_path):
    t = _tree()
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ck.submit(s, t)
    t["a"].add_(1.0)   # written after submit: the checkpoint keeps the old
    ck.close()
    assert store.latest_step(str(tmp_path)) == 30
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_20", "step_30"]
    restored, _ = store.restore(str(tmp_path), t)
    t["a"].sub_(1.0)
    _assert_trees_equal(restored, t)


def _ref_tree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": {"c": jnp.asarray([1.0, -2.5], jnp.bfloat16),
                  "d": jnp.asarray(3, jnp.int32)},
            "layers": [{"w": jnp.full((2,), 0.1, jnp.float32)}, {}]}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The layout, leaf numbering and bf16 encoding are the reference's:
    a tree saved by one package restores, bit for bit, in the other."""
    ours, theirs = _tree(), _ref_tree()
    store.save(str(tmp_path / "port"), 3, ours)
    got, step = ref_store.restore(str(tmp_path / "port"), theirs)
    assert step == 3
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(theirs)):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref_store.save(str(tmp_path / "ref"), 4, theirs)
    back, step = store.restore(str(tmp_path / "ref"), ours)
    assert step == 4
    _assert_trees_equal(back, ours)
    assert np.asarray(theirs["b"]["c"]).dtype == ml_dtypes.bfloat16


# -- the fault-tolerance runtime (tests/test_runtime.py on the port) ----------


def test_coordinator_detects_missed_beats():
    c = ft.Coordinator(num_hosts=3, timeout_s=1.0)
    for h in range(3):
        c.beat(h, now=100.0)
    assert c.healthy(now=100.5)
    c.beat(0, now=102.0)
    c.beat(1, now=102.0)
    assert c.dead_hosts(now=102.5) == [2]


def test_failure_injection_and_restart():
    calls = {"train": 0, "restore": 0, "save": []}

    def train_one(step):
        calls["train"] += 1
        return {"xent": 1.0 / (step + 1)}

    def save(step):
        calls["save"].append(step)

    def restore():
        calls["restore"] += 1
        return calls["save"][-1] if calls["save"] else 0

    out = ft.run_with_restarts(
        num_steps=12, train_one_step=train_one, save_every=5,
        save_fn=save, restore_fn=restore,
        coordinator=ft.Coordinator(num_hosts=2),
        injector=ft.FailureInjector({7: 1}))
    assert out["restarts"] == 1
    assert calls["restore"] == 1
    # steps 5..6 replayed after restore-from-5
    assert calls["train"] == 12 + 2
    assert [h["step"] for h in out["history"]][-1] == 11


def test_restart_budget_enforced():
    with pytest.raises(RuntimeError, match="restart budget"):
        ft.run_with_restarts(
            num_steps=5, train_one_step=lambda s: {},
            save_every=100, save_fn=lambda s: None, restore_fn=lambda: 0,
            coordinator=ft.Coordinator(num_hosts=1),
            injector=ft.FailureInjector({i: 0 for i in range(10)}),
            max_restarts=2)


def test_plan_remesh_shrink():
    plan = ft.plan_remesh((2, 16, 16), ("pod", "data", "model"), 300)
    assert plan.action == "shrink"
    assert plan.new_shape == (1, 16, 16)
    assert not ft.plan_remesh((2, 16, 16), ("pod", "data", "model"),
                              512).changed


def test_straggler_detection():
    times = {0: [1.0] * 20, 1: [1.02] * 20, 2: [1.5] * 20, 3: [0.98] * 20}
    reports = stragglers.detect(times)
    assert [r.host_id for r in reports if r.is_straggler] == [2]
    slow = [r for r in reports if r.host_id == 2][0]
    np.testing.assert_allclose(slow.barrier_utilization, 1.0)
    assert "2" in stragglers.mitigation(reports)


def test_no_stragglers_on_uniform_fleet():
    times = {h: list(np.random.default_rng(h).normal(1.0, 0.01, 20))
             for h in range(8)}
    assert not [r for r in stragglers.detect(times) if r.is_straggler]


# -- the training launcher ---------------------------------------------------


ARGV = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "20",
        "--batch", "4", "--seq", "64", "--save-every", "5",
        "--simulate-failure-at", "12"]


def test_launch_train_follows_the_reference_through_a_restart(
        tmp_path, monkeypatch, capsys):
    """20 steps with a failure at step 12 and saves every 5: one restart
    from step 10, steps 10 and 11 replayed, and every step's xent (the
    replayed ones included) within 1e-3 of the reference's launcher started
    from the same parameters; the replayed steps equal their first pass
    (the data stream and the checkpoint are exact)."""
    init, seen = ref_train.init_state, {}

    def ref_init(model, rng, ocfg=None):
        state = init(model, rng, ocfg)
        seen.update(cfg=model.cfg, params=jax.tree.map(np.array,
                                                       state["params"]))
        return state

    def port_init(model, gen, ocfg=None):
        p = convert.lm_params_from_numpy(seen["params"], seen["cfg"], CPU)
        return {"params": p, "opt": adamw.init(p),
                "step": torch.zeros((), dtype=torch.int32)}

    monkeypatch.setattr(ref_train, "init_state", ref_init)
    monkeypatch.setattr(train_mod, "init_state", port_init)
    want = ref_launch.main(ARGV + ["--ckpt-dir", str(tmp_path / "ref")])
    got = launch_train.main(ARGV + ["--ckpt-dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    assert got["restarts"] == want["restarts"] == 1
    steps = [h["step"] for h in got["history"]]
    assert steps == [h["step"] for h in want["history"]]
    assert steps == list(range(12)) + list(range(10, 20))
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["xent"], w["xent"], rtol=XENT_RTOL)
    first = {h["step"]: h["xent"] for h in got["history"][:12]}
    for h in got["history"][12:14]:
        assert h["xent"] == first[h["step"]]
    out = capsys.readouterr().out
    assert "restored from checkpoint at step 10" in out
    assert "on cpu: steps=22 restarts=1" in out
    assert store.latest_step(str(tmp_path / "port")) == 20


def test_training_example_runs_through_a_restart(capsys):
    """``examples/torch_train_lm.py`` on the CPU: 52 steps, a checkpoint
    at step 25, the failure at step 26, one restart, the loss falling."""
    out = load_example("torch_train_lm").main(["--steps", "52",
                                                "--torch-device", "cpu"])
    assert out["restarts"] == 1 and len(out["history"]) == 53
    assert out["history"][-1]["xent"] < out["history"][0]["xent"]
    assert "after 53 executed steps with 1 restart(s)" in \
        capsys.readouterr().out


def test_launch_train_default_device_raises_without_a_card(tmp_path):
    """No fallback: without ``--device cpu`` ``launch.train`` builds on the
    card, and without one it raises before any step."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    with pytest.raises((RuntimeError, AssertionError)):
        launch_train.main(["--arch", "qwen2-72b", "--reduced", "--steps",
                           "2", "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
