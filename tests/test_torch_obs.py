"""The port's contention heat map against the reference's.

``repro_torch.obs.heatmap`` attributes the trace provider's committed
index stream to bins and waves.  The load-bearing claims, each held to
the reference (``tests/test_obs.py``) on the same specs: the heat map's
json equals the reference's (per-bin counts bit for bit, shares within
rtol 1e-9), its embedded ``CounterSet`` is bitwise-equal to the port's
``collect`` (and to the instrumented kernel's counters), per-bin hits
sum to the committed stream length, ``hist`` peaks at wave degree 32 and
``hist2`` at 8 with a strictly smaller top-bin share, the renderers
round-trip, and streamless and empty streams are well-defined.
"""

import csv
import io
import json

import numpy as np
import pytest

from _port_compare import assert_csv_close, assert_json_close, load_example
from repro.analysis import WorkloadSpec as RefSpec
from repro.cli.main import main as ref_main
from repro.obs import heatmap_for_spec as ref_heatmap_for_spec
from repro.obs import heatmap_from_stream as ref_heatmap_from_stream
from repro_torch.analysis import (InstrumentedKernelProvider, Session,
                                  WorkloadSpec)
from repro_torch.analysis.providers.trace import TraceProvider
from repro_torch.cli.main import main
from repro_torch.core.counters import COMMIT_GROUP, LANES, bitwise_equal
from repro_torch.data.images import make_image
from repro_torch.obs import Heatmap, heatmap_for_spec, heatmap_from_stream

CPU = ["--torch-device", "cpu"]


@pytest.fixture(autouse=True)
def _isolate_artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_TORCH_TABLE_CACHE", str(tmp_path / "tables"))
    yield


def _hist_spec(variant="hist", pixels=1 << 13, cls=WorkloadSpec,
               kind="solid", **kw):
    img = make_image(kind, pixels)
    return cls.from_histogram(img, label=f"{kind}-{variant}",
                              variant=variant, **kw)


# -- equal to the reference ---------------------------------------------------


SPECS = {
    "hist-solid-8K": lambda cls: _hist_spec("hist", cls=cls),
    "hist2-solid-8K": lambda cls: _hist_spec("hist2", cls=cls),
    "hist-uniform-4K": lambda cls: _hist_spec("hist", 1 << 12, cls,
                                              "uniform"),
    "hist2-solid-64K-wpt8": lambda cls: _hist_spec(
        "hist2", 1 << 16, cls, waves_per_tile=8),
    "hist-solid-5000px-3ch": lambda cls: cls.from_histogram(
        make_image("solid", 5000)[:, :3].copy(), label="3ch"),
    "weighted-hist": lambda cls: _hist_spec("hist", 1 << 12, cls,
                                            weighted=True),
    "indices-solid": lambda cls: cls.from_indices(
        np.zeros(1 << 12, np.int64), 256, label="solid-4096"),
    "indices-uniform-wpt4": lambda cls: cls.from_indices(
        np.random.default_rng(0).integers(0, 256, 1 << 12), 256,
        label="uniform-4096", waves_per_tile=4),
    "scatter-add": lambda cls: cls.from_scatter_add(
        np.random.default_rng(1).integers(0, 64, 5000),
        np.ones(5000, np.float32), 64, label="scatter-5000"),
}


@pytest.mark.parametrize("case", list(SPECS))
def test_heatmap_equals_reference(case):
    got = heatmap_for_spec(SPECS[case](WorkloadSpec))
    want = ref_heatmap_for_spec(SPECS[case](RefSpec))
    assert_json_close(json.loads(got.render("json", top_k=64)),
                      json.loads(want.render("json", top_k=64)))
    assert_csv_close(got.render("csv"), want.render("csv"))
    assert got.render("text") == want.render("text")
    for field in ("bins", "hits", "replays", "max_wave_degree",
                  "wave_degree"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_heatmap_from_stream_equals_reference():
    stream = np.random.default_rng(2).integers(0, 40, 3000)
    kw = dict(label="raw", num_cores=4, waves_per_tile=3, hot_degree=3.0)
    got, want = heatmap_from_stream(stream, **kw), \
        ref_heatmap_from_stream(stream, **kw)
    assert_json_close(json.loads(got.render("json", top_k=40)),
                      json.loads(want.render("json", top_k=40)))


def test_paper_shares_at_64k_solid():
    """The §5 solid image at 64 Kpx, wave geometry 8: hist's hottest bin
    replays 31/128 of the stream (24.2%) at wave degree 32, hist2's 7/32
    (21.9%) at degree 8 — the reference's numbers, exactly."""
    shares = {}
    for variant in ("hist", "hist2"):
        got = heatmap_for_spec(_hist_spec(variant, 1 << 16,
                                          waves_per_tile=8))
        want = ref_heatmap_for_spec(_hist_spec(variant, 1 << 16, RefSpec,
                                               waves_per_tile=8))
        assert (got.top_bin_share, got.peak_degree) == \
            (want.top_bin_share, want.peak_degree)
        shares[variant] = (got.top_bin_share, got.peak_degree)
    assert shares == {"hist": (31 / 128, 32.0), "hist2": (7 / 32, 8.0)}


# -- attribution --------------------------------------------------------------


@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_heatmap_bit_consistent_with_counterset(variant):
    """Same stream, same kernels, same counters: the trace provider's
    ``collect`` bitwise, and the instrumented kernel's (plain version on
    the CPU) but for its source."""
    prov = TraceProvider()
    spec = _hist_spec(variant)
    hm = heatmap_for_spec(spec)
    cset = prov.collect(spec, None)
    assert bitwise_equal(hm.counters, cset)
    measured = InstrumentedKernelProvider(torch_device="cpu").collect(
        spec, None)
    assert bitwise_equal(hm.counters, measured, ignore=("source", "meta"))
    # hits sum to the committed stream length (pixels x channels)
    stream, _, _ = prov.committed_stream(spec)
    assert int(hm.hits.sum()) == stream.size
    assert hm.total_hits == stream.size
    # the wave series is the trace's degree array: one entry per wave
    # job, summing (per core) into the CounterSet's O
    assert hm.num_waves == cset.num_waves
    assert np.isclose(hm.wave_degree.sum(), cset.total_O)


def test_heatmap_localizes_hist_and_hist2_disperses():
    """Identical hit totals; strictly lower top-bin replay share for
    hist2 — the §5 story the heat map exists to show."""
    hist = heatmap_for_spec(_hist_spec("hist"))
    hist2 = heatmap_for_spec(_hist_spec("hist2"))
    assert np.array_equal(hist.bins, hist2.bins)
    assert np.array_equal(hist.hits, hist2.hits)
    assert hist.peak_degree == 32.0 and hist2.peak_degree == 8.0
    assert hist2.top_bin_share < hist.top_bin_share
    assert len(hist.hot_bins) >= 1
    assert list(hist.hot_bins) == list(hist2.hot_bins)


def test_heatmap_session_method_and_indices_source(tmp_path):
    idx = np.array([7] * LANES + [1, 2, 3], np.int64)
    spec = WorkloadSpec.from_indices(idx, 16, label="idx")
    hm = Session("v5e", cache_dir=tmp_path).heatmap(spec)
    assert isinstance(hm, Heatmap)
    assert hm.total_hits == idx.size
    assert hm.top_bin == 7
    # bin 7: one full wave of LANES hits, each commit group all-7s
    i7 = list(hm.bins).index(7)
    assert hm.hits[i7] == LANES
    assert hm.replays[i7] == LANES - LANES // COMMIT_GROUP
    assert hm.max_wave_degree[i7] == float(COMMIT_GROUP)


def test_heatmap_rejects_streamless_sources(tmp_path):
    tr = TraceProvider()._synthesize(_hist_spec())
    spec = WorkloadSpec(label="pre-recorded", trace=tr)
    with pytest.raises(ValueError, match="no committed index stream"):
        Session("v5e", cache_dir=tmp_path).heatmap(spec)
    with pytest.raises(ValueError, match="no committed index stream"):
        TraceProvider().committed_stream(spec)


def test_heatmap_empty_stream():
    hm = heatmap_from_stream(np.empty(0, np.int64), label="empty")
    assert hm.total_hits == 0
    assert hm.bins.size == 0
    assert hm.top_bin is None
    assert hm.top_bin_share == 0.0
    assert hm.hot_bins.size == 0
    # all three renderers still produce output, as the reference's do
    want = ref_heatmap_from_stream(np.empty(0, np.int64), label="empty")
    assert hm.render("text") == want.render("text")
    assert json.loads(hm.render("json")) == json.loads(want.render("json"))
    assert json.loads(hm.render("json"))["total_hits"] == 0
    assert hm.render("csv") == want.render("csv")
    assert hm.render("csv").startswith("bin,")


def test_heatmap_single_bin_stream():
    n = 4 * LANES
    hm = heatmap_from_stream(np.zeros(n, np.int64), label="one-bin")
    assert list(hm.bins) == [0]
    assert hm.hits[0] == n
    assert hm.replays[0] == n - n // COMMIT_GROUP
    assert hm.max_wave_degree[0] == float(COMMIT_GROUP)
    assert hm.top_bin == 0
    assert hm.top_bin_share == pytest.approx((COMMIT_GROUP - 1)
                                             / COMMIT_GROUP)
    assert list(hm.hot_bins) == [0]


def test_heatmap_negative_stream_rejected():
    with pytest.raises(ValueError, match="negative"):
        heatmap_from_stream(np.array([-1, 2]))


# -- renderers ----------------------------------------------------------------


def test_render_json_round_trip():
    hm = heatmap_for_spec(_hist_spec())
    body = json.loads(hm.render("json", top_k=64))
    assert body["label"] == hm.label
    assert body["total_hits"] == hm.total_hits
    assert body["hot_bins"] == [int(b) for b in hm.hot_bins]
    assert body["top_bin"] == hm.top_bin
    assert body["top_bin_share"] == pytest.approx(hm.top_bin_share)
    assert body["peak_wave"] == hm.peak_wave
    assert body["counters"]["total_O"] == hm.counters.total_O
    assert len(body["wave_degree"]) == hm.num_waves
    assert np.allclose(body["wave_degree"], hm.wave_degree)
    by_bin = {r["bin"]: r for r in body["bins"]}
    for i, b in enumerate(hm.bins):
        assert by_bin[int(b)]["hits"] == int(hm.hits[i])
        assert by_bin[int(b)]["replays"] == int(hm.replays[i])


def test_render_csv_round_trip():
    hm = heatmap_for_spec(_hist_spec())
    rows = list(csv.DictReader(io.StringIO(hm.render("csv"))))
    assert len(rows) == hm.bins.size
    for i, row in enumerate(sorted(rows, key=lambda r: int(r["bin"]))):
        assert int(row["bin"]) == int(hm.bins[i])
        assert int(row["hits"]) == int(hm.hits[i])
        assert int(row["replays"]) == int(hm.replays[i])
        assert float(row["max_wave_degree"]) == \
            pytest.approx(float(hm.max_wave_degree[i]))
        assert row["hot"] in ("0", "1")


def test_render_text_and_unknown_format():
    hm = heatmap_for_spec(_hist_spec())
    text = hm.render("text")
    assert "contention heat map" in text
    assert "top-bin share" in text
    assert "hot bins: 4" in text
    with pytest.raises(ValueError, match="unknown heat-map format"):
        hm.render("yaml")


# -- the CLI and the example --------------------------------------------------


@pytest.mark.parametrize("fmt", ["text", "json", "csv"])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_cli_heatmap_equals_reference(capsys, fmt, variant):
    argv = ["heatmap", "--workload", "histogram", "--pixels", "2^13",
            "--dist", "solid", "--variant", variant, "--format", fmt,
            "--no-artifact"]
    assert ref_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + CPU) == 0
    got = capsys.readouterr().out
    if fmt == "json":
        body = json.loads(got)
        assert_json_close(body, json.loads(want))
        assert body["peak_degree"] == {"hist": 32.0, "hist2": 8.0}[variant]
        assert len(body["hot_bins"]) >= 1 and body["top_bin_share"] > 0
    elif fmt == "csv":
        assert_csv_close(got, want)
    else:
        assert got == want


def test_cli_heatmap_writes_artifact(tmp_path, capsys):
    rc = main(["heatmap", "--size", "2^12", "--dist", "solid",
               "--format", "csv"])
    capsys.readouterr()
    assert rc == 0
    arts = list((tmp_path / "port" / "cli").rglob("heatmap-*.csv"))
    assert len(arts) == 1
    rows = list(csv.DictReader(arts[0].open()))
    assert sum(int(r["hits"]) for r in rows) == 1 << 12


def test_cli_heatmap_needs_no_kernel(capsys):
    """The heat map reads the trace provider's stream: it runs on a box
    without a card even with ``--provider kernel`` and no device flag."""
    rc = main(["heatmap", "--size", "2^12", "--provider", "kernel",
               "--format", "json", "--no-artifact"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["total_hits"] == 1 << 12


def test_heatmap_example_on_the_cpu(capsys):
    assert load_example("torch_heatmap_histogram").main(CPU) == 0
    out = capsys.readouterr().out
    assert "hist  top-bin share 24.2% (peak wave degree 32)" in out
    assert "hist2 top-bin share 21.9% (peak wave degree 8)" in out
