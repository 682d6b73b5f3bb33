"""The port's scatter-add family (K5-K7), Tool 1's kernel mode and the
scatter/indices provider routes, against the reference's.

The same numpy inputs go through ``repro.kernels.scatter_add.ops`` (Pallas
in interpret mode, as ``tests/test_kernels_scatter.py`` runs it) and
through ``repro_torch.kernels.scatter_add.ops`` on the CPU, where the
wrappers run the kernels' plain versions.  Integer results (bincounts,
committed streams, degrees, N, O, the counter sets) must be bit-equal;
f32 sums agree within rtol/atol 1e-5 (f64 sums rounded once against the
reference's f32 one-hot products) and f16 inputs within the reference
test's 2e-3.  The CUDA kernels themselves are held against these plain
versions on the card by ``test_torch_kernels_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefSpec
from repro.core import counters as ref_counters
from repro.core import microbench as ref_microbench
from repro.kernels import instrumentation as ref_instr
from repro.kernels.scatter_add import ops as ref_ops
from repro.kernels.scatter_add import ref as ref_ref
from repro_torch import convert
from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.analysis.providers import InstrumentedKernelProvider
from repro_torch.core import counters, microbench
from repro_torch.data import streams
from repro_torch.kernels import instrumentation as instr
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.kernels.scatter_add import ops, ref

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(n, d, s, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, d)).astype(dtype)
    ids = rng.integers(0, s, n).astype(np.int32)
    return vals, ids


def _ref_sum(vals, ids, s, **kw):
    return np.asarray(ref_ops.scatter_add(jnp.asarray(vals), jnp.asarray(ids),
                                          num_segments=s, **kw))


# -- K5 / K7 through the ops --------------------------------------------------


@pytest.mark.parametrize("n,d,s", [(1000, 8, 64), (4096, 64, 128),
                                   (5000, 16, 128), (2048, 128, 32)])
def test_scatter_add_matches_reference(n, d, s):
    vals, ids = _case(n, d, s)
    got = ops.scatter_add(vals, ids, num_segments=s, torch_device=CPU)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    np.testing.assert_allclose(got.numpy(), _ref_sum(vals, ids, s), **TOL)
    oracle = ref.scatter_add_ref(torch.as_tensor(vals), torch.as_tensor(ids),
                                 s)
    np.testing.assert_allclose(oracle.numpy(), got.numpy(), **TOL)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(ref_ref.scatter_add_ref(
            jnp.asarray(vals), jnp.asarray(ids), s)), **TOL)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float16, 2e-3)])
def test_scatter_add_dtypes(dtype, tol):
    vals, ids = _case(2048, 8, 64, seed=1, dtype=dtype)
    got = ops.scatter_add(vals, ids, num_segments=64, torch_device=CPU)
    np.testing.assert_allclose(got.numpy(), _ref_sum(vals, ids, 64),
                               rtol=tol, atol=tol)


def test_blocked_segment_axis_vocab_scale():
    """Embedding-grad case: 16,384 segments, four 4096-segment blocks."""
    vals, ids = _case(3000, 8, 16384, seed=2)
    got = ops.scatter_add(vals, ids, num_segments=16384, seg_block=4096,
                          torch_device=CPU)
    np.testing.assert_allclose(
        got.numpy(), _ref_sum(vals, ids, 16384, seg_block=4096), **TOL)
    assert sk.scatter_route(16384, 8) == "global"
    assert sk.scatter_route(4096, 1) == "shared"


@pytest.mark.parametrize("s,d,dtype,offset,route", [
    (4096, 1, torch.float32, 0, "shared"),
    (32768, 1, torch.float32, 0, "global"),
    (1024, 8, torch.float32, 0, "shared"),
    (4096, 8, torch.float32, 0, "global-vector"),
    (4096, 8, torch.bfloat16, 0, "global-vector"),
    (32768, 4, torch.bfloat16, 0, "global"),       # 8-byte rows
    (16384, 6, torch.float32, 0, "global"),        # d % 4 != 0
    (4096, 8, torch.float32, 1, "global"),         # base 4 bytes off
    (4096, 1024, torch.float32, 0, "global-vector"),
    (4096, 2048, torch.float32, 0, "global-owned"),
    (4096, 2048, torch.bfloat16, 0, "global-owned"),
    (4096, 1024, torch.bfloat16, 0, "global-vector"),
])
def test_k5_route_from_shapes_and_alignment(s, d, dtype, offset, route):
    """K5's route: shared when the (S, D) f32 copy fits 96 KB; on the
    global route 16-byte parts where D % 4 == 0 and rows and base are
    16-byte aligned, and owned rows from 2048 values a row."""
    flat = torch.zeros(8 * d + offset, dtype=dtype)
    vals = flat[offset:].view(8, d)
    assert sk.scatter_add_route(vals, s) == route
    assert sk.K5_ROUTES[route] in range(4)


def test_segment_axis_must_be_whole_blocks():
    vals, ids = _case(100, 2, 6000)
    with pytest.raises(AssertionError):
        _ref_sum(vals, ids, 6000)
    with pytest.raises(ValueError, match="whole number"):
        ops.scatter_add(vals, ids, num_segments=6000, torch_device=CPU)
    with pytest.raises(ValueError, match="whole number"):
        ops.instrumented_scatter_add(ids, vals, 6000, torch_device=CPU)


def _bincount_ids(kind, n, s, seed):
    if kind == "skewed":
        return streams.skewed_ids(n, s, seed=seed)
    if kind == "collapsed":
        return np.zeros(n, np.int32)
    return np.random.default_rng(seed).integers(0, s, n).astype(np.int32)


# (stream, n, S, seed): the uniform cases keep their first ids; n % 4 of
# 1-3, S = 1, S = 8192 with 70,001 ids, and the skewed and collapsed
# streams (K7's adversarial cases on the card)
_BINCOUNT_CASES = [
    pytest.param("uniform", 1, 2, 0, id="1-2-0"),
    pytest.param("uniform", 100, 7, 1, id="100-7-1"),
    pytest.param("uniform", 2048, 128, 2, id="2048-128-2"),
    pytest.param("uniform", 3000, 200, 3, id="3000-200-3"),
    pytest.param("uniform", 5000, 8192, 4, id="5000-8192-4"),
    pytest.param("uniform", 4097, 128, 5, id="uniform-4097-128"),
    pytest.param("uniform", 4098, 1000, 6, id="uniform-4098-1000"),
    pytest.param("uniform", 4099, 3, 7, id="uniform-4099-3"),
    pytest.param("uniform", 1000, 1, 8, id="uniform-1000-1"),
    pytest.param("uniform", 70001, 8192, 9, id="uniform-70001-8192"),
    pytest.param("skewed", 70001, 8192, 10, id="skewed-70001-8192"),
    pytest.param("skewed", 5003, 128, 11, id="skewed-5003-128"),
    pytest.param("collapsed", 65536, 128, 0, id="collapsed-65536-128"),
    pytest.param("collapsed", 33, 1, 0, id="collapsed-33-1"),
]


@pytest.mark.parametrize("kind,n,s,seed", _BINCOUNT_CASES)
def test_bincount_matches_reference(kind, n, s, seed):
    ids = _bincount_ids(kind, n, s, seed)
    got = ops.bincount(ids, num_segments=s, torch_device=CPU)
    want = np.asarray(ref_ops.bincount(jnp.asarray(ids), num_segments=s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.bincount_ref(torch.as_tensor(ids), s).numpy(), want)


def test_bincount_refuses_more_than_8192_segments():
    with pytest.raises(ValueError, match="8192"):
        ops.bincount(np.zeros(4, np.int32), num_segments=8193,
                     torch_device=CPU)


@pytest.mark.parametrize("n,s,route", [
    (0, 128, "block"), (32, 128, "block"), (sk.BINCOUNT_BLOCK_IDS, 1, "block"),
    (sk.BINCOUNT_BLOCK_IDS, 8192, "block"),
    (sk.BINCOUNT_BLOCK_IDS + 1, 128, "grid"), (1 << 16, 128, "grid"),
    (1 << 22, 8192, "grid"), (1 << 22, 0, "grid")])
def test_bincount_route_boundaries(n, s, route):
    """One block stores every count up to BINCOUNT_BLOCK_IDS ids (a decode
    step's 32 included); the MoE dispatch's 65,536 ids and longer streams
    take the grid route."""
    assert sk.bincount_route(n, s) == route


@pytest.mark.parametrize("s", [-1, 8193, 1 << 20])
def test_bincount_route_refuses_what_the_kernel_cannot_take(s):
    with pytest.raises(ValueError, match="8192"):
        sk.bincount_route(16, s)


def test_out_of_range_ids_drop_like_the_reference():
    """Negative and too-large ids add nothing: bitwise, with integer-valued
    values so that every sum is exact."""
    rng = np.random.default_rng(5)
    ids = rng.integers(-3, 140, 3000).astype(np.int32)
    ids[:4] = [-1, 200, 128, 127]
    vals = rng.integers(-4, 5, (3000, 3)).astype(np.float32)
    got = ops.scatter_add(vals, ids, num_segments=128, torch_device=CPU)
    np.testing.assert_array_equal(got.numpy(), _ref_sum(vals, ids, 128))
    counts = ops.bincount(ids, num_segments=128, torch_device=CPU)
    np.testing.assert_array_equal(
        counts.numpy(),
        np.asarray(ref_ops.bincount(jnp.asarray(ids), num_segments=128)))
    assert int(counts.sum()) == int(((ids >= 0) & (ids < 128)).sum())


# -- K6: the committed stream and the instrumented scatter --------------------


@pytest.mark.parametrize("s", [128, 8192])
@pytest.mark.parametrize("n", [2048, 3000])
def test_committed_id_stream_bitwise(s, n):
    ids = np.random.default_rng(6).integers(0, s, n)
    got = ops.committed_id_stream(ids, s)
    want = ref_ops.committed_id_stream(ids, s)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.committed_id_stream(torch.as_tensor(ids), s), want)


ADVERSARIAL = streams.adversarial_streams()


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_degrees_of_adversarial_streams_equal_reference(name):
    """K1's plain version, K6's plain version and the port's trace
    synthesis against the reference's ``wave_degrees`` and
    ``_degrees_full_waves``, bit for bit, on each designed stream; the
    value rows stop short of the stream, as past n in a committed one."""
    stream = ADVERSARIAL[name]
    got = instr.wave_degrees_plain(torch.as_tensor(stream))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_instr.wave_degrees(jnp.asarray(stream))))
    want = ref_counters._degrees_full_waves(stream.reshape(-1, 1024), 32)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
    np.testing.assert_array_equal(
        counters._degrees_full_waves(stream.reshape(-1, 1024), 32), want)
    vals = torch.ones((stream.size - 37, 1))
    sums, deg = sk.scatter_add_instrumented_launch(
        vals, torch.as_tensor(stream), streams.SEGMENTS)
    assert torch.equal(deg, got)
    kept = stream[:stream.size - 37]
    kept = kept[(kept >= 0) & (kept < streams.SEGMENTS)]
    np.testing.assert_array_equal(
        sums[:, 0].numpy(), np.bincount(kept, minlength=streams.SEGMENTS))


@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_of_adversarial_streams_equals_reference(name, d, dtype):
    """K5 through the port's ops (its plain version, the kernel's yardstick
    on the card) against the reference's Pallas kernel on each designed
    stream cut to its first size - 37 rows: strays, sentinels and int32
    extremes drop in both; bf16 values are the same rounding of the same
    f32 draws on both sides; sums within rtol/atol 1e-5."""
    ids = ADVERSARIAL[name][:-37]
    vals = np.random.default_rng(10).standard_normal(
        (ids.size, d)).astype(np.float32)
    got = ops.scatter_add(torch.as_tensor(vals).to(getattr(torch, dtype)),
                          ids, num_segments=streams.SEGMENTS,
                          torch_device=CPU)
    want = ref_ops.scatter_add(jnp.asarray(vals).astype(dtype),
                               jnp.asarray(ids),
                               num_segments=streams.SEGMENTS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [128, 8192])
def test_instrumented_scatter_add_bitwise(s):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, s, 3000).astype(np.int32)
    ids[:64] = 3                                    # a hot commit group
    vals = rng.standard_normal((3000, 4)).astype(np.float32)
    kw = dict(num_cores=4, waves_per_tile=3, pipeline_depth=4)
    out, got = ops.instrumented_scatter_add(ids, vals, s, torch_device=CPU,
                                            **kw)
    ref_out, want = ref_ops.instrumented_scatter_add(ids, vals, s, **kw)
    assert (got["N"], got["O"]) == (want["N"], want["O"])
    np.testing.assert_array_equal(got["degree"], want["degree"])
    for f in ("degree", "job_class", "core", "lanes_active"):
        a, b = getattr(got["trace"], f), getattr(want["trace"], f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got["trace"].waves_per_tile, got["trace"].pipeline_depth) == \
        (want["trace"].waves_per_tile, want["trace"].pipeline_depth)
    np.testing.assert_array_equal(
        got["degree"].astype(np.float64),
        counters._degrees_full_waves(
            ops.committed_id_stream(ids, s).reshape(-1, 1024), 32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)


def test_instrumented_scatter_add_defaults_and_1d_values():
    ids = np.random.default_rng(8).integers(0, 128, 4096).astype(np.int32)
    out, c = ops.instrumented_scatter_add(ids, np.ones(4096, np.float32), 128,
                                          torch_device=CPU)
    _, want = ref_ops.instrumented_scatter_add(ids, np.ones(4096, np.float32),
                                               128)
    assert c["N"] == 4096 / 1024 and c["O"] == want["O"]
    assert c["trace"].waves_per_tile == ops.default_waves_per_tile() == 2
    assert float(out.sum()) == 4096.0
    with pytest.raises(ValueError, match="value rows"):
        ops.instrumented_scatter_add(ids, np.ones(100, np.float32), 128,
                                     torch_device=CPU)


def test_collect_counters_field_by_field():
    ids = np.random.default_rng(9).integers(0, 256, 4096).astype(np.int32)
    vals = np.ones((ids.size, 1), np.float32)
    kw = dict(label="hook-s", num_cores=8, waves_per_tile=2)
    got = ops.collect_counters(ids, vals, 256, torch_device=CPU, **kw)
    want = ref_ops.collect_counters(ids, vals, 256, **kw)
    assert got.source == "kernel" and got.bytes_read == ids.size * 4
    assert counters.bitwise_equal(
        got, convert.counter_set_from_numpy(dataclasses.asdict(want)))


# -- Tool 1: build_table(mode="kernel") ---------------------------------------


def test_kernel_mode_validation_equals_reference():
    """Designed (n, e) patterns, recovered from the kernel's degrees."""
    got = microbench.build_table(mode="kernel", kernel_validation_points=6,
                                 torch_device=CPU)
    want = ref_microbench.build_table(mode="kernel",
                                      kernel_validation_points=6)
    assert got.meta["kernel_validation"] == want.meta["kernel_validation"]
    assert len(got.meta["kernel_validation"]) == 6
    for rec in got.meta["kernel_validation"]:
        assert rec["e_rel_err"] < 0.05, rec


# -- providers: trace vs kernel, and against the reference --------------------


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp("tables")
    ref = RefSession("v5e", cache_dir=root / "ref")
    port = Session("v5e", cache_dir=root / "port")
    return ref, port


KERNEL = InstrumentedKernelProvider(torch_device=CPU)


def _dispatch(kind, n=4096, experts=128, seed=3):
    rng = np.random.default_rng(seed)
    ids = {"balanced": rng.integers(0, experts, n),
           "skewed": rng.zipf(1.3, n) % experts,
           "collapsed": np.zeros(n, np.int64)}[kind]
    return ids.astype(np.int32)


def _specs(cls, kind):
    ids = _dispatch(kind)
    vals = np.ones((ids.size, 1), np.float32)
    return [cls.from_scatter_add(ids, vals, 128, label=f"{kind}/scatter",
                                 waves_per_tile=2),
            cls.from_indices(ids, 128, label=f"{kind}/indices",
                             waves_per_tile=4)]


@pytest.mark.parametrize("kind", ["balanced", "skewed", "collapsed"])
def test_trace_and_kernel_providers_agree_bit_for_bit(sessions, kind):
    ref_sess, sess = sessions
    for spec, ref_spec in zip(_specs(WorkloadSpec, kind),
                              _specs(RefSpec, kind)):
        ct = sess.collect(spec, provider="trace")
        ck = sess.collect(spec, provider=KERNEL)
        assert (ct.source, ck.source) == ("trace", "kernel")
        assert counters.bitwise_equal(ct, ck, ignore=("source", "meta"))
        for prov, cset in (("trace", ct), ("kernel", ck)):
            want = ref_sess.collect(ref_spec, provider=prov)
            assert counters.bitwise_equal(
                cset, convert.counter_set_from_numpy(dataclasses.asdict(want)))
        report = sess.validate(spec, ("trace", KERNEL))
        assert report.max_rel_err == 0.0
        assert [c.batch_bitwise_equal for c in report.comparisons] == \
            [True, True]


def test_kernel_provider_rejects_non_tile_multiple_indices(sessions):
    """Sentinel-padded waves would be counted: refuse, don't diverge."""
    _, sess = sessions
    spec = WorkloadSpec.from_indices(
        np.random.default_rng(0).integers(0, 256, 1000), 256, label="odd")
    assert sess.collect(spec, provider="trace").total_jobs == 1
    with pytest.raises(ValueError, match="multiple of the scatter tile"):
        sess.collect(spec, provider=KERNEL)


def test_microbench_provider_wall_time_equals_reference(sessions):
    ref_sess, sess = sessions
    ids = np.random.default_rng(1).integers(0, 256, 8 * 1024)
    spec = WorkloadSpec.from_indices(ids, 256, label="mb", waves_per_tile=4)
    got = sess.collect(spec, provider="microbench")
    want = ref_sess.collect(RefSpec.from_indices(ids, 256, label="mb",
                                                 waves_per_tile=4),
                            provider="microbench")
    assert got.source == "microbench"
    assert got.wall_time_s == want.wall_time_s and got.wall_time_s > 0
    assert got.meta == want.meta
    assert counters.bitwise_equal(
        got, convert.counter_set_from_numpy(dataclasses.asdict(want)))
    report = sess.validate(spec, ("trace", "microbench"))
    assert [c.batch_bitwise_equal for c in report.comparisons] == [True, True]


def test_moe_dispatch_profiles_match_reference(sessions):
    """``benchmarks/run.py``'s MoE dispatch rows: router balance as the
    scatter unit's 'image colour distribution'."""
    ref_sess, sess = sessions
    for kind in ("balanced", "skewed", "collapsed"):
        ids = _dispatch(kind, n=1 << 14, seed=0)
        kw = dict(label=kind, waves_per_tile=32,
                  bytes_read=float(ids.size * 4))
        vals = np.ones((ids.size, 1), np.float32)
        got = Session("v5e", table=sess.table, provider=KERNEL).profile(
            WorkloadSpec.from_scatter_add(ids, vals, 128, **kw))
        want = ref_sess.profile(RefSpec.from_scatter_add(ids, vals, 128, **kw))
        assert (got.e, got.bottleneck) == (want.e, want.bottleneck)
        assert got.scatter_utilization == want.scatter_utilization
