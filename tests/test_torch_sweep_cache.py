"""The port's persistent sweep cache and telemetry, against the reference's.

``repro_torch.analysis.sweep_cache`` keeps the reference's entry format
(``.npz``, ``CACHE_VERSION = 1``) under its own root
(``results/torch/cache/``) and with its own key, whose code digest also
hashes the CUDA sources.  ``repro_torch.obs.telemetry`` is a stdlib copy
of the reference's registry and spans, with the same metric names.
"""

import dataclasses
import os

import numpy as np
import pytest

from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefSpec
from repro.analysis import sweep_cache as ref_sweep_cache
from repro.obs import telemetry as ref_telemetry
from repro_torch import convert
from repro_torch.analysis import Session, SweepCache, WorkloadSpec
from repro_torch.analysis import sweep_cache as sc
from repro_torch.analysis.providers import InstrumentedKernelProvider
from repro_torch.core import counters
from repro_torch.core.counters import CounterSet
from repro_torch.data.images import make_image
from repro_torch.kernels import _build
from repro_torch.models import moe
from repro_torch.obs import telemetry

KERNEL = InstrumentedKernelProvider(torch_device="cpu")


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    return Session("v5e", cache_dir=tmp_path_factory.mktemp("t")).table


def _uniform(n=1 << 13, bins=256, seed=0):
    return np.random.default_rng(seed).integers(0, bins, n)


def _grid_specs():
    ids = _uniform(4096, 128).astype(np.int32)
    base = [
        WorkloadSpec.from_indices(_uniform(), 256, label="idx"),
        WorkloadSpec.from_scatter_add(ids, np.ones((4096, 1), np.float32),
                                      128, label="scatter"),
        WorkloadSpec.from_histogram(make_image("solid", 3000), label="hist",
                                    variant="hist2"),
    ]
    return [s for b in base for s in b.grid(waves_per_tile=[2, 8])]


# -- entries ------------------------------------------------------------------


def test_round_trip(tmp_path, table):
    cache = SweepCache(tmp_path / "cache")
    sess = Session("v5e", table=table)
    cset = sess.collect(WorkloadSpec.from_indices(
        np.zeros(1 << 13, np.int64), 256, label="solid", waves_per_tile=8))
    key = cache.key("trace", "fp", sess.device.table_key())
    assert cache.get(key) is None
    cache.put(key, cset)
    back = cache.get(key)
    assert counters.bitwise_equal(back, cset)
    assert back.wall_time_s is None             # None survives, not 0.0
    assert len(cache) == 1
    assert cache.clear() == 1 and len(cache) == 0
    timed = CounterSet(label="timed", num_cores=2, wall_time_s=1.25,
                       meta={"k": "v"})
    cache.put("k1", timed)
    assert cache.get("k1").wall_time_s == 1.25
    assert cache.get("k1").meta == {"k": "v"}


def test_entries_read_across_packages(tmp_path, table):
    """One format: an entry either package writes, the other reads back
    field by field."""
    sess = Session("v5e", table=table)
    cset = sess.collect(WorkloadSpec.from_indices(_uniform(), 256, label="u"),
                        provider="microbench")
    sc.save_counter_set(cset, tmp_path / "port.npz")
    ref_back = ref_sweep_cache.load_counter_set(tmp_path / "port.npz")
    assert counters.bitwise_equal(
        cset, convert.counter_set_from_numpy(dataclasses.asdict(ref_back)))
    ref_sweep_cache.save_counter_set(ref_back, tmp_path / "ref.npz")
    assert counters.bitwise_equal(sc.load_counter_set(tmp_path / "ref.npz"),
                                  cset)


def test_corrupt_entry_is_a_miss_and_quarantined(tmp_path):
    cache = SweepCache(tmp_path)
    cache.put("bad", CounterSet(label="x", num_cores=1))
    cache.put("good", CounterSet(label="y", num_cores=1))
    cache.path("bad").write_bytes(b"not an npz")
    assert cache.get("bad") is None
    assert not cache.path("bad").exists()
    stats = cache.stats()
    assert stats["quarantined"] == 1 and stats["entries"] == 1
    assert list(cache.get_many(["bad", "good"])) == ["good"]
    (cache.root / "orphan.tmp").write_bytes(b"half-written")
    removed, freed = cache.prune()
    assert removed == 2 and freed > 0
    assert cache.stats()["quarantined"] == 0 and len(cache) == 1


def _fill(root, n):
    cache = SweepCache(root)
    for i in range(n):
        cache.put(cache.key("trace", f"fp{i}", "tbl"), CounterSet(
            label=f"e{i}", source="trace", num_cores=1,
            O=np.array([float(i)]), N_f=np.array([1.0]), num_waves=2))
    return cache


def test_stats_and_prune(tmp_path):
    cache = _fill(tmp_path / "c", 4)
    stats = cache.stats()
    assert stats["entries"] == 4 and stats["bytes"] > 0
    assert stats["by_provider"]["trace"]["entries"] == 4
    removed, freed = cache.prune(max_bytes=0)
    assert removed == 4 and freed == stats["bytes"]
    assert cache.stats()["entries"] == 0
    with pytest.raises(ValueError):
        cache.prune(max_bytes=-1)


def test_prune_evicts_oldest_first(tmp_path):
    cache = _fill(tmp_path / "c", 3)
    old = sorted(p for p, _ in cache.iter_entries())[0]
    os.utime(old, (1, 1))
    removed, _ = cache.prune(max_bytes=cache.stats()["bytes"] - 1)
    assert removed == 1 and not old.exists()
    assert cache.stats()["entries"] == 2


# -- keys and roots -----------------------------------------------------------


def test_key_and_root_are_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_RESULTS", raising=False)
    monkeypatch.delenv("REPRO_TORCH_RESULTS", raising=False)
    port_root, ref_root = sc.default_cache_root(), \
        ref_sweep_cache.default_cache_root()
    assert port_root.parts[-3:] == ("results", "torch", "cache")
    assert port_root != ref_root and ref_root.parts[-2:] == ("results",
                                                            "cache")
    spec = WorkloadSpec.from_indices(_uniform(), 256, label="k")
    args = ("kernel", spec.fingerprint(), "v5e-key")
    assert SweepCache(tmp_path).key(*args) != \
        ref_sweep_cache.SweepCache(tmp_path).key(*args)
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "elsewhere"))
    assert sc.default_cache_root() == tmp_path / "elsewhere" / "cache"
    assert Session("v5e", table=Session("v5e", cache_dir=tmp_path).table,
                   persistent_cache=True).sweep_cache.root == \
        tmp_path / "elsewhere" / "cache"


def test_key_tracks_provider_fingerprint_and_device(tmp_path):
    cache = SweepCache(tmp_path)
    base = cache.key("trace", "fp1", "v5e-key")
    assert cache.key("kernel", "fp1", "v5e-key") != base
    assert cache.key("trace", "fp2", "v5e-key") != base
    assert cache.key("trace", "fp1", "v5p-key") != base
    assert cache.key("trace", "fp1", "v5e-key") == base


@pytest.mark.parametrize("suffix", [".cu", ".cuh", ".py"])
def test_changed_kernel_source_changes_the_digest(monkeypatch, suffix):
    """An edited CUDA kernel (or kernel module) invalidates old entries."""
    digest = sc._collection_code_digest.__wrapped__()
    assert digest == sc._collection_code_digest()
    sources = [p for p in _build.CSRC.iterdir() if p.suffix == suffix] \
        if suffix != ".py" else [_build.CSRC.parent / "_build.py"]
    assert sources
    original = type(sources[0]).read_bytes

    def edited(path):
        data = original(path)
        return data + b"\n// edited" if path.name == sources[0].name \
            else data

    monkeypatch.setattr(type(sources[0]), "read_bytes", edited)
    assert sc._collection_code_digest.__wrapped__() != digest


# -- the Session over the cache -----------------------------------------------


@pytest.mark.parametrize("provider", ["trace", KERNEL])
def test_warm_session_collects_nothing(tmp_path, table, provider):
    """A fresh Session over a populated cache collects no point and
    reproduces the cold sweep's report exactly."""
    specs = _grid_specs()
    cold = Session("v5e", table=table, provider=provider,
                   persistent_cache=tmp_path)
    r_cold = cold.sweep(specs)
    assert cold.stats["collected"] == len(specs)
    warm = Session("v5e", table=table, provider=provider,
                   persistent_cache=SweepCache(tmp_path))
    r_warm = warm.sweep(specs)
    assert warm.stats == {"collected": 0, "memo_hits": 0,
                          "disk_hits": len(specs), "batch_calls": 0}
    assert r_warm.render("json") == r_cold.render("json")
    assert r_warm.render("text") == r_cold.render("text")


def test_sweep_stats_match_reference_with_cache(tmp_path, table):
    ids = _uniform()
    ref_specs = [RefSpec.from_indices(ids, 256, label="i")] * 2
    specs = [WorkloadSpec.from_indices(ids, 256, label="i")] * 2
    ref = RefSession("v5e", cache_dir=tmp_path / "t",
                     persistent_cache=tmp_path / "ref")
    port = Session("v5e", table=table, persistent_cache=tmp_path / "port")
    for _ in range(2):
        want, got = ref.sweep(ref_specs), port.sweep(specs)
        assert got.render("json") == want.render("json")
        assert port.stats == ref.stats


# -- telemetry ----------------------------------------------------------------


def test_spans_record_inside_scope_only(table):
    sess = Session("v5e", table=table)
    specs = [WorkloadSpec.from_indices(_uniform(), 256, label="s")]
    sess.sweep(specs)
    with telemetry.trace_scope("tid123") as rec:
        assert rec["spans"] == []       # the sweep outside left nothing
        with telemetry.span("outer", label="x"):
            sess.sweep(specs)
        assert rec["id"] == "tid123"
    names = [s["name"] for s in rec["spans"]]
    assert names == ["session.collect", "session.model", "session.analyze",
                     "session.sweep", "outer"]
    assert rec["spans"][3]["attrs"] == {"points": 1}
    assert rec["spans"][4]["attrs"] == {"label": "x"}
    assert all(s["dur_ms"] >= 0 for s in rec["spans"])
    with telemetry.disabled(), telemetry.trace_scope() as off:
        sess.profile(specs[0])
    assert off["spans"] == []


def test_metric_names_match_reference(table, tmp_path):
    sess = Session("v5e", table=table, persistent_cache=tmp_path)
    sess.profile(WorkloadSpec.from_indices(_uniform(), 256, label="m"))
    names = {line.split()[2] for line in telemetry.render().splitlines()
             if line.startswith("# TYPE")}
    assert {"repro_session_calls_total", "repro_session_seconds",
            "repro_session_points_total",
            "repro_sweep_cache_lookups_total"} <= names
    # the LM layers' own counters have no counterpart in the reference
    assert names - {moe.ROWS.name} <= set(ref_telemetry.REGISTRY._metrics)
    calls = telemetry.REGISTRY._metrics["repro_session_calls_total"]
    assert calls.value(method="profile") >= 1


def test_registry_renders_and_bounds_series():
    reg = telemetry.MetricsRegistry(max_series=2)
    c = reg.counter("jobs_total", "jobs", ("kind",))
    for kind in ("a", "b", "c", "d"):
        c.inc(kind=kind)
    assert c.value(kind=telemetry.OVERFLOW) == 2.0
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.5)
    text = reg.render()
    assert '# TYPE jobs_total counter' in text
    assert 'lat_seconds_bucket{le="1"} 1' in text
    with pytest.raises(ValueError, match="re-registered"):
        reg.counter("jobs_total", "jobs", ())
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1, kind="a")
