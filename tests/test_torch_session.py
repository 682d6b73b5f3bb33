"""The slice as a whole: the port's Session against the reference's.

Both packages run the §5 case study's pipeline on the same images: the
table resolve, the trace and kernel providers, the queue model and the
verdicts.  The port's kernel provider runs on the CPU here
(``InstrumentedKernelProvider(torch_device="cpu")``, the kernels' plain
versions); the reference's runs its Pallas kernels in interpret mode.
Reports must be identical, and the modeled and measured counters must
agree exactly (``validate``'s max relative error is 0).
"""

import numpy as np
import pytest

from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefSpec
from repro.analysis import device as ref_device
from repro.core.profiler import CacheModel as RefCacheModel
from repro.data.images import make_image
from repro_torch import convert
from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.analysis import device as device_mod
from repro_torch.analysis.providers import InstrumentedKernelProvider
from repro_torch.core.profiler import CacheModel

PX = 4096


@pytest.fixture
def sessions(tmp_path):
    ref_device._TABLE_MEMO.clear()
    device_mod._TABLE_MEMO.clear()
    return (RefSession("v5e", cache_dir=tmp_path / "ref", provider="kernel"),
            Session("v5e", cache_dir=tmp_path / "port",
                    provider=InstrumentedKernelProvider(torch_device="cpu")))


def _specs(cls, kind, **kw):
    img = make_image(kind, PX)
    return [cls.from_histogram(img, label=f"{kind}/{v}", variant=v,
                               waves_per_tile=8, **kw)
            for v in ("hist", "hist2")]


@pytest.mark.parametrize("kind", ["solid", "uniform"])
def test_sweep_reports_identical(sessions, kind):
    ref, port = sessions
    want = ref.sweep(_specs(RefSpec, kind))
    got = port.sweep(_specs(WorkloadSpec, kind))
    assert got.render("json") == want.render("json")
    assert got.render("text") == want.render("text")
    assert port.stats == {k: ref.stats[k] for k in port.stats}


@pytest.mark.parametrize("kind", ["solid", "uniform"])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_validate_trace_against_kernel_exactly(sessions, kind, variant):
    _, port = sessions
    spec = WorkloadSpec.from_histogram(make_image(kind, PX + 100),
                                       label=kind, variant=variant)
    report = port.validate(
        spec, ("trace", InstrumentedKernelProvider(torch_device="cpu")))
    assert report.max_rel_err == 0.0
    assert [c.batch_bitwise_equal for c in report.comparisons] == [True, True]


def test_classify_verdicts_match(sessions):
    ref, port = sessions
    for kind in ("solid", "uniform"):
        for force_fao in (True, False):
            img = make_image(kind, PX)
            kw = dict(label=kind, force_fao=force_fao, waves_per_tile=32)
            want = ref.classify(RefSpec.from_histogram(img, **kw))
            got = port.classify(WorkloadSpec.from_histogram(img, **kw))
            assert (got.bottleneck, got.saturated, got.comment) == \
                (want.bottleneck, want.saturated, want.comment)
            assert got.utilization == want.utilization


def test_compare_case_study_shifts_match(tmp_path):
    """``repro compare``'s size sweep: the same verdicts and shift events
    through the port's kernel provider as through the reference's trace
    provider, on the case study's LLC emulation."""
    cache = dict(llc_bytes=1 << 21, miss_latency_cycles=800,
                 hide_concurrency=48.0)
    ref_device._TABLE_MEMO.clear()
    device_mod._TABLE_MEMO.clear()
    ref = RefSession(ref_device.get_device("v5e").with_(
        cache=RefCacheModel(**cache)), cache_dir=tmp_path / "ref")
    port = Session(device_mod.get_device("v5e").with_(
        cache=CacheModel(**cache)), cache_dir=tmp_path / "port",
        provider=InstrumentedKernelProvider(torch_device="cpu"))
    sizes = [2 ** p for p in range(5, 15, 3)]
    for variant in ("hist", "hist2"):
        def specs(cls):
            return [cls.from_histogram(make_image("solid", px),
                                       label=f"{px}/{variant}",
                                       variant=variant, waves_per_tile=8)
                    for px in sizes]
        want, got = ref.sweep(specs(RefSpec)), port.sweep(specs(WorkloadSpec))
        assert [v.bottleneck for v in got.verdicts] == \
            [v.bottleneck for v in want.verdicts]
        assert [(s.unit_before, s.unit_after, s.label_before)
                for s in got.shifts] == \
            [(s.unit_before, s.unit_after, s.label_before)
             for s in want.shifts]


def test_port_session_runs_on_the_reference_table(tmp_path):
    ref_table = RefSession("v5e", cache_dir=tmp_path).table
    path = tmp_path / "table.npz"
    ref_table.save(str(path))
    with np.load(path) as arrays:
        table = convert.table_from_numpy(dict(arrays))
    img = make_image("solid", PX)
    got = Session("v5e", table=table).profile(
        WorkloadSpec.from_histogram(img, label="s", waves_per_tile=32))
    want = RefSession("v5e", table=ref_table).profile(
        RefSpec.from_histogram(img, label="s", waves_per_tile=32))
    assert got.scatter_utilization == want.scatter_utilization
    assert got.bottleneck == want.bottleneck


def test_port_table_cache_is_its_own(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TABLE_CACHE", str(tmp_path / "port"))
    assert device_mod.default_cache_dir() == tmp_path / "port"
    monkeypatch.delenv("REPRO_TORCH_TABLE_CACHE")
    assert device_mod.default_cache_dir().parts[-3:] == \
        ("results", "torch", "tables")
    assert device_mod.default_cache_dir() != ref_device.default_cache_dir()


def test_later_slices_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="sweep cache"):
        Session("v5e", cache_dir=tmp_path, persistent_cache=True)
    sess = Session("v5e", cache_dir=tmp_path,
                   provider=InstrumentedKernelProvider(torch_device="cpu"))
    ids = np.zeros(2048, np.int32)
    scatter = WorkloadSpec.from_scatter_add(
        ids, np.ones(2048, np.float32), 256, label="scatter")
    with pytest.raises(NotImplementedError, match="scatter slice"):
        sess.collect(scatter)
    with pytest.raises(NotImplementedError, match="scatter slice"):
        sess.collect(scatter, provider="trace")
    with pytest.raises(NotImplementedError, match="scatter slice"):
        sess.collect(WorkloadSpec.from_indices(ids, 256, label="idx"))
