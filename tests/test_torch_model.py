"""The port's host-side model against the reference, on the same inputs.

``repro_torch.core`` is a numpy copy of ``repro.core``: counters, the
queue model, the bottleneck verdicts and Tool 1's table build.
Integer and degree results must be bit-identical; the model's floats are
held to rtol 1e-9, the batch-vs-loop bound of ``tests/test_profile_batch``.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import bottleneck as ref_bottleneck
from repro.core import counters as ref_counters
from repro.core import microbench as ref_microbench
from repro.core import profiler as ref_profiler
from repro.core import timing as ref_timing
from repro_torch import convert
from repro_torch.core import bottleneck, counters, microbench, profiler, timing

RTOL = 1e-9


@pytest.fixture(scope="module")
def tables():
    return ref_microbench.build_table(), microbench.build_table()


def _streams():
    rng = np.random.default_rng(0)
    return {
        "solid": np.full(8 * 1024, 7, np.int64),
        "uniform": rng.integers(0, 256, 8 * 1024),
        "partial": rng.integers(0, 16, 5 * 1024 + 77),   # trailing part-wave
        "short": rng.integers(0, 4, 45),
    }


@pytest.mark.parametrize("kind", ["solid", "uniform", "partial", "short"])
def test_wave_degree_and_traces_bitwise(kind):
    idx = _streams()[kind]
    assert counters.wave_degree(idx) == ref_counters.wave_degree(idx)
    full = idx[: idx.size // 1024 * 1024].reshape(-1, 1024)
    if full.size:
        np.testing.assert_array_equal(
            counters._degrees_full_waves(full, 32),
            ref_counters._degrees_full_waves(full, 32))
    kw = dict(num_cores=4, job_class=timing.POPC, waves_per_tile=2)
    got = counters.trace_from_indices(idx, 256, **kw)
    want = ref_counters.trace_from_indices(idx, 256, **kw)
    for f in ("degree", "job_class", "core", "lanes_active"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.waves_per_tile, got.pipeline_depth) == \
        (want.waves_per_tile, want.pipeline_depth)


def test_traces_from_index_batch_bitwise():
    streams = list(_streams().values())
    got = counters.traces_from_index_batch(streams, num_cores=2,
                                           waves_per_tile=[1, 2, 4, 8])
    want = ref_counters.traces_from_index_batch(streams, num_cores=2,
                                                waves_per_tile=[1, 2, 4, 8])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.degree, w.degree)
        np.testing.assert_array_equal(g.core, w.core)
        np.testing.assert_array_equal(g.lanes_active, w.lanes_active)


def test_job_classes_and_chip_constants_match():
    assert (timing.FAO, timing.CAS, timing.POPC) == \
        (ref_timing.FAO, ref_timing.CAS, ref_timing.POPC)
    assert dataclasses.asdict(timing.V5E) == dataclasses.asdict(ref_timing.V5E)
    assert dataclasses.asdict(timing.V5E_SCATTER) == \
        dataclasses.asdict(ref_timing.V5E_SCATTER)


def test_analytic_build_table_equals_reference(tables):
    want, got = tables
    for f in ("n_grid", "e_grid", "cfrac_grid", "T", "popc_T"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.clock_hz == want.clock_hz
    assert got.meta == want.meta


def test_kernel_mode_table_build_waits_for_scatter_slice(tables):
    """The scatter slice has landed: the kernel-mode build runs K6's plain
    version here, and its table and meta equal the reference's."""
    want = ref_microbench.build_table(mode="kernel",
                                      kernel_validation_points=2, seed=3)
    got = microbench.build_table(mode="kernel", kernel_validation_points=2,
                                 seed=3, torch_device="cpu")
    for f in ("n_grid", "e_grid", "cfrac_grid", "T", "popc_T"):
        np.testing.assert_array_equal(getattr(got, f), getattr(tables[1], f))
    assert got.meta == want.meta
    assert got.meta["mode"] == "kernel"
    with pytest.raises(ValueError, match="unknown build_table mode"):
        microbench.build_table(mode="wallclock")


def test_table_interpolator_matches(tables):
    want, got = tables
    rng = np.random.default_rng(3)
    n, e, cf = (rng.uniform(-8, 80, 2048), rng.uniform(0, 40, 2048),
                rng.uniform(-0.3, 1.4, 2048))
    np.testing.assert_allclose(got.interpolator()(n, e, cf),
                               want.interpolator()(n, e, cf), rtol=RTOL)
    np.testing.assert_allclose(got.popc_interpolator()(n, e),
                               want.popc_interpolator()(n, e), rtol=RTOL)
    np.testing.assert_allclose(got.service_time_batch(n, e, cf * n),
                               want.service_time_batch(n, e, cf * n),
                               rtol=RTOL)


def _grid(ctr, prof, seed=0):
    """64 counter sets: 8 streams x 8 launch geometries."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(8):
        idx = rng.integers(0, 2 ** s, 1 << 13)
        for g, (wpt, depth) in enumerate([(1, 1), (2, 2), (4, 2), (8, 2),
                                          (16, 4), (32, 2), (64, 8),
                                          (128, 1)]):
            tr = ctr.trace_from_indices(
                idx, 256, num_cores=8, job_class=[0, 1, 2][(s + g) % 3],
                waves_per_tile=wpt, pipeline_depth=depth)
            out.append(ctr.CounterSet.from_trace(
                tr, label=f"s{s}g{g}", num_cores=8,
                bytes_read=float(1 << (10 + s + g)),
                overhead_cycles=[500.0, 2000.0][g % 2]))
    return out


def test_profile_batch_64_point_grid(tables):
    ref_table, table = tables
    cache = profiler.CacheModel(llc_bytes=1 << 21, miss_latency_cycles=800,
                                hide_concurrency=48.0)
    ref_cache = ref_profiler.CacheModel(
        llc_bytes=1 << 21, miss_latency_cycles=800, hide_concurrency=48.0)
    got = profiler.profile_batch(
        counters.CounterFrame.from_sets(_grid(counters, profiler)), table,
        cache=cache)
    want = ref_profiler.profile_batch(
        ref_counters.CounterFrame.from_sets(_grid(ref_counters,
                                                  ref_profiler)),
        ref_table, cache=ref_cache)
    assert len(got) == len(want) == 64
    for a, b in zip(got, want):
        assert a.label == b.label
        np.testing.assert_allclose(a.scatter_utilization,
                                   b.scatter_utilization, rtol=RTOL)
        np.testing.assert_allclose(a.n_hat, b.n_hat, rtol=RTOL)
        np.testing.assert_allclose(a.e, b.e, rtol=RTOL)
        assert a.bottleneck == b.bottleneck
        va, vb = bottleneck.classify(a), ref_bottleneck.classify(b)
        assert (va.bottleneck, va.comment) == (vb.bottleneck, vb.comment)
    for tol in (bottleneck.SHIFT_TOL, 0.0):
        shifts = [dataclasses.astuple(s)
                  for s in bottleneck.detect_shifts(got, tol=tol)]
        ref_shifts = [dataclasses.astuple(s)
                      for s in ref_bottleneck.detect_shifts(want, tol=tol)]
        assert shifts == ref_shifts


def test_convert_round_trips_reference_table_and_trace(tables, tmp_path):
    ref_table, table = tables
    path = tmp_path / "ref_table.npz"
    ref_table.save(str(path))
    with np.load(path) as arrays:
        got = convert.table_from_numpy(dict(arrays))
    for f in ("n_grid", "e_grid", "cfrac_grid", "T", "popc_T"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref_table, f))
    assert got.clock_hz == ref_table.clock_hz
    assert got.meta == ref_table.meta
    # the dataclass fields convert as well as the saved arrays
    direct = convert.table_from_numpy(dataclasses.asdict(ref_table))
    np.testing.assert_array_equal(direct.T, table.T)

    ref_tr = ref_counters.trace_from_indices(_streams()["partial"], 256,
                                             num_cores=4, waves_per_tile=2)
    tr = convert.trace_from_numpy(dataclasses.asdict(ref_tr))
    for f in ("degree", "job_class", "core", "lanes_active",
              "waves_per_tile", "pipeline_depth"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(ref_tr, f))

    params = convert.scatter_params_from_dict(
        dataclasses.asdict(ref_timing.V5E_SCATTER))
    assert params == timing.V5E_SCATTER
