"""The port's advisor against the reference's, on the same specs.

``repro_torch.advisor`` is the reference's transform search over the
port's Session: each case builds the same spec in both packages and
requires the same transforms, the same ranking and labels (bit for bit)
and the same predicted speedups (rtol 1e-9), then mirrors the
reference's invariants (``tests/test_advisor.py``) on the port: one
batch evaluation per frontier, a warm re-advise that collects nothing,
a deterministic ranking, and the rediscovery of ``hist2`` validated
through the port's kernel provider on the CPU.
"""

import csv as csv_mod
import io
import json

import numpy as np
import pytest

from _port_compare import assert_csv_close, assert_json_close, load_example
from repro.advisor import AdvisorSearch as RefAdvisorSearch
from repro.advisor import default_catalog as ref_default_catalog
from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefSpec
from repro.data.images import make_image
from repro_torch.advisor import (
    AdvisorSearch,
    CasToFao,
    ChannelRotation,
    LaneInterleave,
    Replicate,
    SetPipelineDepth,
    SetWavesPerTile,
    TransformCost,
    default_catalog,
)
from repro_torch.analysis import InstrumentedKernelProvider, Session
from repro_torch.analysis import WorkloadSpec
from repro_torch.core import profiler, timing

CPU_KERNEL = InstrumentedKernelProvider(torch_device="cpu")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return tmp_path_factory.mktemp("tables")


@pytest.fixture
def sess(tables):
    return Session("v5e", cache_dir=tables / "port")


@pytest.fixture
def ref_sess(tables):
    return RefSession("v5e", cache_dir=tables / "ref")


def _solid_idx(n=1 << 12):
    return np.zeros(n, np.int64)


def _clustered_idx(n=1 << 12, bins=64):
    return np.repeat(np.arange(bins, dtype=np.int64), n // bins)


def _sorted_uniform_idx(n=1 << 12, bins=64, seed=7):
    return np.sort(np.random.default_rng(seed).integers(0, bins, n))


# each case: (a maker of the spec from a spec class, advise kwargs); the
# same maker builds the reference's spec and the port's
CASES = {
    "solid-indices": (lambda cls: cls.from_indices(
        _solid_idx(), 256, label="s", waves_per_tile=8), {}),
    "clustered-indices": (lambda cls: cls.from_indices(
        _clustered_idx(), 64, label="cl", waves_per_tile=8),
        {"depth": 2, "beam_width": 8, "top_k": 10}),
    "sorted-uniform-depth3": (lambda cls: cls.from_indices(
        _sorted_uniform_idx(), 64, label="det", waves_per_tile=8),
        {"depth": 3, "beam_width": 4}),
    "cas-membound": (lambda cls: cls.from_indices(
        _clustered_idx(), 64, label="membound", waves_per_tile=8,
        job_class=timing.CAS, bytes_read=1e9), {"depth": 1}),
    "hist-solid-16K": (lambda cls: cls.from_histogram(
        make_image("solid", 1 << 14), label="solid-16K", variant="hist",
        waves_per_tile=8, overhead_cycles=2500.0), {"top_k": 8}),
    "hist-uniform-default-geometry": (lambda cls: cls.from_histogram(
        make_image("uniform", 1 << 13), label="uniform-8K"), {}),
    "weighted-hist": (lambda cls: cls.from_histogram(
        make_image("solid", 1 << 12), label="w", weighted=True,
        waves_per_tile=8), {}),
    "scatter-add-cas": (lambda cls: cls.from_scatter_add(
        _clustered_idx(1 << 12, 64), np.ones(1 << 12, np.float32), 64,
        label="sa", job_class=timing.CAS), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_advise_equals_reference(sess, ref_sess, case):
    """Same candidates, ranking, labels, costs and speedups as the
    reference's AdvisorSearch, in every format."""
    build, kw = CASES[case]
    got = AdvisorSearch(sess, **{k: v for k, v in kw.items()
                                 if k in ("depth", "beam_width")}).search(
        build(WorkloadSpec), top_k=kw.get("top_k", 5))
    want = RefAdvisorSearch(ref_sess, **{k: v for k, v in kw.items()
                                         if k in ("depth", "beam_width")}
                            ).search(build(RefSpec),
                                     top_k=kw.get("top_k", 5))
    assert [c.label for c in got.candidates] \
        == [c.label for c in want.candidates]
    assert [c.names for c in got.candidates] \
        == [c.names for c in want.candidates]
    assert [c.speedup for c in got.candidates] \
        == pytest.approx([c.speedup for c in want.candidates], rel=1e-9)
    assert_json_close(json.loads(got.render("json")),
                      json.loads(want.render("json")))
    assert got.render("text") == want.render("text")
    if got.candidates:
        assert_csv_close(got.render("csv"), want.render("csv"))


def test_default_catalogs_match():
    port = [(type(t).__name__, t.name, t.family, t.params())
            for t in default_catalog()]
    ref = [(type(t).__name__, t.name, t.family, t.params())
           for t in ref_default_catalog()]
    assert port == ref


# -- transforms ---------------------------------------------------------------


def test_rotation_legality_and_apply():
    img = make_image("solid", 1 << 10)
    spec = WorkloadSpec.from_histogram(img, label="h", variant="hist")
    t = ChannelRotation()
    assert t.legal(spec)
    out = t.apply(spec)
    assert out.kernel.params["variant"] == "hist2"
    assert out.label == "h+rotate-channels"
    assert not t.legal(out)              # can't rotate twice
    assert spec.kernel.params["variant"] == "hist"   # original untouched


def test_replicate_apply_splits_bins():
    spec = WorkloadSpec.from_indices(_solid_idx(64), 16, label="s")
    t = Replicate(4)
    assert t.legal(spec)
    out = t.apply(spec)
    assert out.num_bins == 64
    idx = np.asarray(out.indices)
    # all-zero stream becomes round-robin replicas 0..3
    assert set(idx.tolist()) == {0, 1, 2, 3}
    cost = t.cost(spec)
    assert cost.scratch_bytes == 16 * 3 * 4
    assert cost.reduce_flops == 64
    with pytest.raises(ValueError):
        Replicate(1)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_stream_rewrites_equal_reference(factor):
    """Replicate and LaneInterleave rewrite the stream exactly as the
    reference's transforms do."""
    from repro.advisor import LaneInterleave as RefInterleave
    from repro.advisor import Replicate as RefReplicate

    idx = _sorted_uniform_idx(1000)
    for port_t, ref_t in ((Replicate(factor), RefReplicate(factor)),
                          (LaneInterleave(), RefInterleave())):
        got = port_t.apply(WorkloadSpec.from_indices(idx, 64, label="x"))
        want = ref_t.apply(RefSpec.from_indices(idx, 64, label="x"))
        assert np.array_equal(got.indices, want.indices)
        assert got.indices.dtype == want.indices.dtype
        assert (got.num_bins, got.label) == (want.num_bins, want.label)


def test_cas_to_fao_legality_and_apply():
    spec = WorkloadSpec.from_indices(_solid_idx(64), 16, label="c",
                                     job_class=timing.CAS)
    t = CasToFao()
    assert t.legal(spec)
    assert t.apply(spec).job_class == timing.FAO
    assert not t.legal(spec.with_(job_class=timing.FAO))
    weighted = WorkloadSpec.from_histogram(
        make_image("solid", 1 << 8), label="w", weighted=True)
    assert t.legal(weighted)
    out = t.apply(weighted)
    assert out.kernel.params["weighted"] is False
    assert out.kernel.params["force_fao"] is True


def test_geometry_effective_default_is_not_a_candidate():
    spec = WorkloadSpec.from_indices(_solid_idx(64), 16, label="g",
                                     waves_per_tile=8)
    assert not SetWavesPerTile(8).legal(spec)
    assert SetWavesPerTile(32).legal(spec)
    # pipeline_depth None resolves to 2 everywhere: depth=2 is a no-op
    assert spec.pipeline_depth is None
    assert not SetPipelineDepth(2).legal(spec)
    assert SetPipelineDepth(4).legal(spec)
    # unset waves_per_tile resolves per source family: indices -> 1,
    # histogram kernels -> the kernel's own tiling
    unset = WorkloadSpec.from_indices(_solid_idx(64), 16, label="u")
    assert not SetWavesPerTile(1).legal(unset)
    assert SetWavesPerTile(8).legal(unset)
    from repro_torch.kernels.histogram import ops as hist_ops
    img = make_image("solid", 1 << 10)
    hist = WorkloadSpec.from_histogram(img, label="h", variant="hist")
    default = hist_ops.default_waves_per_tile(img)
    assert not SetWavesPerTile(default).legal(hist)
    assert SetWavesPerTile(default * 2).legal(hist)
    scatter = WorkloadSpec.from_scatter_add(
        _solid_idx(64), np.ones(64, np.float32), 16, label="sa")
    from repro_torch.kernels.scatter_add import ops as scat_ops
    assert not SetWavesPerTile(scat_ops.default_waves_per_tile()).legal(
        scatter)


def test_interleave_spreads_clusters():
    spec = WorkloadSpec.from_indices(_clustered_idx(), 64, label="cl")
    t = LaneInterleave()
    assert t.legal(spec)
    out = t.apply(spec)
    idx = np.asarray(out.indices)
    assert sorted(idx.tolist()) == sorted(_clustered_idx().tolist())
    # first commit group now holds distant elements, not one run
    assert len(set(idx[:32].tolist())) > 1


def test_cost_merge_sums_and_joins():
    merged = TransformCost.merge([
        TransformCost(scratch_bytes=8, reduce_flops=2, note="a"),
        TransformCost(scratch_bytes=4, note="b"),
        TransformCost(),
    ])
    assert merged.scratch_bytes == 12
    assert merged.reduce_flops == 2
    assert merged.note == "a; b"


# -- search invariants --------------------------------------------------------


def test_one_batch_eval_per_frontier_no_scalar_profiling(monkeypatch, sess):
    """Every frontier is one profile_batch, zero scalar calls."""
    calls = {"batch": 0, "scalar": 0}
    orig_batch = profiler.profile_batch

    def counting_batch(*a, **kw):
        calls["batch"] += 1
        return orig_batch(*a, **kw)

    def forbidden(*a, **kw):
        calls["scalar"] += 1
        raise AssertionError("advisor must never scalar-profile")

    monkeypatch.setattr(profiler, "profile_batch", counting_batch)
    monkeypatch.setattr(profiler, "profile_counters", forbidden)
    spec = WorkloadSpec.from_indices(_solid_idx(), 256, label="s",
                                     waves_per_tile=8)
    report = sess.advise(spec, depth=2, beam_width=4)
    assert calls["scalar"] == 0
    assert report.stats["frontiers"] == 2
    assert calls["batch"] == report.stats["frontiers"]
    assert report.stats["batch_evals"] == report.stats["frontiers"]


@pytest.mark.parametrize("provider", ["trace", "kernel"])
def test_warm_rerun_with_sweep_cache_collects_nothing(tmp_path, tables,
                                                      provider):
    """A persistent-cache re-advise does zero counter collection, through
    the trace provider and through the kernel provider alike."""
    prov = CPU_KERNEL if provider == "kernel" else provider
    spec = WorkloadSpec.from_indices(_clustered_idx(), 64, label="cl",
                                     waves_per_tile=8)
    cold = Session("v5e", cache_dir=tables / "port", provider=prov,
                   persistent_cache=str(tmp_path))
    r1 = cold.advise(spec, depth=2, beam_width=4)
    assert cold.stats["collected"] > 0
    warm = Session("v5e", cache_dir=tables / "port", provider=prov,
                   persistent_cache=str(tmp_path))
    r2 = warm.advise(spec, depth=2, beam_width=4)
    assert warm.stats["collected"] == 0
    assert warm.stats["disk_hits"] > 0
    # and the served-from-disk ranking is bit-identical
    assert [(c.label, c.speedup) for c in r2.candidates] \
        == [(c.label, c.speedup) for c in r1.candidates]


def test_advisor_deterministic_ranking(tables):
    """Same spec + seed -> identical ranking from independent sessions."""
    reports = []
    for _ in range(2):
        spec = WorkloadSpec.from_indices(_sorted_uniform_idx(), 64,
                                         label="det", waves_per_tile=8)
        reports.append(Session("v5e", cache_dir=tables / "port").advise(
            spec, depth=2, beam_width=4))
    a, b = reports
    assert [c.label for c in a.candidates] == [c.label for c in b.candidates]
    assert [c.speedup for c in a.candidates] \
        == [c.speedup for c in b.candidates]


def test_family_once_and_dedup(sess):
    """No composition reuses a family; no-op rewrites dedup away."""
    spec = WorkloadSpec.from_indices(_solid_idx(), 256, label="s",
                                     waves_per_tile=8)
    report = sess.advise(spec, depth=3, beam_width=8)
    for c in report.candidates:
        fams = c.families
        assert len(fams) == len(set(fams))
        # interleaving an all-equal stream is a no-op: deduped against
        # the baseline fingerprint, so it must not appear alone
        assert c.names != ("interleave-lanes",)


def test_no_legal_transform_reports_baseline_only(sess):
    spec = WorkloadSpec.from_indices(_solid_idx(64), 16, label="tiny")
    report = sess.advise(spec, catalog=[ChannelRotation()])
    assert report.candidates == []
    assert report.best is None
    assert report.stats["frontiers"] == 0
    assert "0 candidates" in report.render("text")
    assert json.loads(report.render("json"))["candidates"] == []


def test_search_rejects_bad_depth_and_beam(sess):
    with pytest.raises(ValueError, match="depth"):
        AdvisorSearch(sess, depth=0)
    with pytest.raises(ValueError, match="beam_width"):
        AdvisorSearch(sess, beam_width=0)


# -- the §5 rediscovery, validated through the port's kernel -----------------


def test_advisor_rediscovers_hist2(sess, ref_sess):
    """From plain hist, the top-ranked fix is the rotation family, its
    predicted speedup is in the paper's up-to-30% band, and the port's
    kernel provider (on the CPU, as the caller asked) confirms the
    modeled counters bit for bit — the reference's report, equal."""
    build, _ = CASES["hist-solid-16K"]
    report = sess.advise(build(WorkloadSpec), depth=2, top_k=5,
                         validate_top=1, kernel_provider=CPU_KERNEL)
    top = report.best
    assert "rotation" in top.families
    assert 1.0 < top.speedup <= 1.30
    assert top.validation is not None
    assert top.validation.rel_err("kernel", "e") == 0.0
    assert top.validation.max_rel_err == 0.0
    assert "validated (kernel vs trace)" in report.render("text")
    want = ref_sess.advise(build(RefSpec), depth=2, top_k=5, validate_top=1)
    assert_json_close(json.loads(report.render("json")),
                      json.loads(want.render("json")))


def test_validate_top_uses_the_callers_kernel_provider(sess, monkeypatch):
    """The validation runs through the provider instance the caller gave,
    never the registered ``"kernel"`` name."""
    seen = []
    orig = Session.validate

    def spying(self, spec, providers=("trace", "kernel"), **kw):
        seen.append(tuple(providers))
        return orig(self, spec, providers, **kw)

    monkeypatch.setattr(Session, "validate", spying)
    build, _ = CASES["hist-solid-16K"]
    sess.advise(build(WorkloadSpec), depth=1, validate_top=2,
                kernel_provider=CPU_KERNEL)
    assert seen and all(p == ("trace", CPU_KERNEL) for p in seen)
    assert AdvisorSearch(sess).kernel_provider == "kernel"


def test_advisor_example_on_the_cpu(capsys, tmp_path, monkeypatch, tables):
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_TABLE_CACHE", str(tables / "port"))
    assert load_example("torch_advisor_histogram").main(
        ["--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK validation" in out and "FAIL" not in out


# -- report rendering ---------------------------------------------------------


def test_report_csv_ragged_roundtrip(sess):
    """Candidates carry different param_* columns: the union-header helper
    must round-trip them with empty holes."""
    spec = WorkloadSpec.from_indices(_clustered_idx(), 64, label="cl",
                                     waves_per_tile=8)
    report = sess.advise(spec, depth=2, beam_width=8, top_k=10)
    rows = list(csv_mod.DictReader(io.StringIO(report.render("csv"))))
    assert len(rows) == len(report.top(10))
    cols = set(rows[0])
    assert {"rank", "transforms", "predicted_speedup",
            "predicted_bottleneck", "scratch_bytes", "cost_note"} <= cols
    param_cols = [c for c in cols if c.startswith("param_")]
    assert param_cols
    assert any(r[c] == "" for r in rows for c in param_cols)


def test_report_json_schema(sess):
    spec = WorkloadSpec.from_indices(_solid_idx(), 256, label="s",
                                     waves_per_tile=8)
    payload = json.loads(sess.advise(spec, depth=1).render("json"))
    assert set(payload) == {"device", "baseline", "candidates", "stats"}
    assert payload["baseline"]["bottleneck"]
    assert payload["baseline"]["hint"] is not None
    assert {"rank", "label", "transforms", "families", "predicted_speedup",
            "predicted_bottleneck", "shifts_bottleneck"} \
        <= set(payload["candidates"][0])
    assert payload["stats"]["batch_evals"] == payload["stats"]["frontiers"]


def test_report_unknown_format_raises(sess):
    spec = WorkloadSpec.from_indices(_solid_idx(64), 16, label="x")
    report = sess.advise(spec, depth=1)
    with pytest.raises(ValueError, match="unknown report format"):
        report.render("yaml")


def test_candidate_cost_uses_pre_transform_spec(sess):
    """Replicate's annotations describe the bins it multiplies."""
    spec = WorkloadSpec.from_indices(_clustered_idx(), 64, label="cl",
                                     waves_per_tile=8)
    report = sess.advise(spec, catalog=[Replicate(8)], depth=1)
    (cand,) = report.candidates
    want = Replicate(8).cost(spec)
    assert cand.cost.scratch_bytes == want.scratch_bytes == 64 * 7 * 4
    assert cand.cost.reduce_flops == want.reduce_flops == 64 * 8


def test_report_U_is_the_bottleneck_units(sess):
    """The utilization printed next to a bottleneck name belongs to that
    unit — an hbm-bound row must not show the scatter model's U."""
    build, _ = CASES["cas-membound"]
    report = sess.advise(build(WorkloadSpec), depth=1, top_k=5)
    assert report.baseline_verdict.bottleneck == "hbm"
    payload = json.loads(report.render("json"))
    assert payload["baseline"]["utilization"] \
        == report.baseline_verdict.utilization
    for row, cand in zip(report.to_rows(), report.top()):
        assert row["predicted_U"] == \
            cand.profile.unit(row["predicted_bottleneck"]).utilization
        assert row["predicted_scatter_U"] == cand.profile.scatter_utilization


def test_candidate_summary_equals_reference(sess, ref_sess):
    build, _ = CASES["hist-solid-16K"]
    got = sess.advise(build(WorkloadSpec), depth=1).best.summary()
    want = ref_sess.advise(build(RefSpec), depth=1).best.summary()
    assert got == want
