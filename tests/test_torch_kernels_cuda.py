"""The port's CUDA kernels (K1-K8) against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every case here is marked ``cuda`` and
skips where there is no card.  The file imports neither ``jax`` nor the
reference package, so it runs on the machine with the card as it is:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Counts and degrees must be bit-equal; K4's and K5/K6's f32 sums are held
at rtol/atol 1e-5 to the plain versions' f64 sums, because float atomics
add in a different order on every run (K4 and K5 sum equal keys within a
warp first, a shorter chain of f32 adds).  K8's attention is held to the
reference's own bounds (``tests/test_kernels_flash.py``): 2e-4 in f32,
3e-2 in bf16 at its T = 64.  At longer T a bf16 output is small (about
0.03 at T = 2048), so there each element is held within 1.6e-2 |out| (two
bf16 ulps) plus 2^-8 sum_j p_j |v_j| (twice the worst error of rounding P
to bf16 for P V), and the mean |err| within 2^-8 of the mean |out|.
K8's backward (bf16 in and out) is held to autograd through the f32
attention on the same inputs by each gradient's relative Frobenius error,
within 2^-7: four bf16 roundings of at most 2^-9 each, the gradient's
own, P's and dS's as product operands, and the output O that D = rowsum(dO
o O) reads (the materialised bf16 backward reads 0.0023-0.0024 at these
shapes, the kernel 0.0023-0.0028, on the card).
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.core import counters, microbench
from repro_torch.data import streams
from repro_torch.data.images import make_image
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.histogram import ops
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.kernels.scatter_add import ops as scatter_ops
from repro_torch.models import attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _image(kind, n, c):
    if kind == "solid":
        return np.full((n, c), 9, np.int32)
    return np.random.default_rng(3).integers(0, 256, (n, c)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pixels,channels", [(100, 4), (5000, 4),
                                               (70000, 3), (1 << 18, 4)])
@pytest.mark.parametrize("kind", ["solid", "uniform"])
@pytest.mark.parametrize("reorder", [False, True])
def test_kernels_match_plain(cuda, n_pixels, channels, kind, reorder):
    img_np = _image(kind, n_pixels, channels)
    img = torch.as_tensor(img_np, device=cuda)
    w = torch.as_tensor(np.random.default_rng(8).random(n_pixels)
                        .astype(np.float32), device=cuda)
    before = dict(hk.LAUNCHES)
    got = hk.histogram_launch(img, reorder=reorder)
    k3_counts, k3_deg = hk.histogram_launch(img, reorder=reorder,
                                            instrumented=True)
    sums = hk.histogram_launch(img, reorder=reorder, weights=w)
    torch.cuda.synchronize()
    assert all(hk.LAUNCHES[k] == before[k] + 1 for k in before)
    plain_counts, plain_deg = hk.histogram_instrumented_plain(img, 256,
                                                              reorder)
    assert torch.equal(got, hk.histogram_plain(img, 256))
    assert torch.equal(k3_counts, plain_counts)
    assert torch.equal(k3_deg, plain_deg)
    stream = ops.committed_index_stream(
        img_np, variant="hist2" if reorder else "hist")
    np.testing.assert_array_equal(
        k3_deg.cpu().numpy().reshape(-1).astype(np.float64),
        counters._degrees_full_waves(stream.reshape(-1, 1024), 32))
    torch.testing.assert_close(
        sums, hk.histogram_weighted_plain(img, w, 256), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_solid_image_degrees(cuda):
    img = make_image("solid", 1 << 16)
    _, hist = ops.histogram_instrumented(img, variant="hist")
    _, hist2 = ops.histogram_instrumented(img, variant="hist2")
    assert (hist.degree.mean(), hist2.degree.mean()) == (32.0, 8.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["solid", "uniform"])
def test_kernel_provider_validates_exactly(cuda, kind, tmp_path):
    sess = Session("v5e", cache_dir=tmp_path)
    for variant in ("hist", "hist2"):
        spec = WorkloadSpec.from_histogram(make_image(kind, 5000),
                                           label=kind, variant=variant)
        report = sess.validate(spec, ("trace", "kernel"))
        assert report.max_rel_err == 0.0
        assert [c.batch_bitwise_equal for c in report.comparisons] == \
            [True, True]


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    img = torch.zeros((64, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        hk.histogram_launch(img)
    img = torch.zeros((64, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hk.histogram_launch(img, num_bins=1 << 16)
    with pytest.raises(ValueError, match="weights"):
        hk.histogram_launch(img, weights=torch.ones(64, device=cuda,
                                                    dtype=torch.float64))


def _ids(kind, n, s, seed=4):
    """Solid (one hot segment) or uniform ids, with out-of-range ones."""
    rng = np.random.default_rng(seed)
    ids = (np.full(n, s // 2) if kind == "solid"
           else rng.integers(0, s, n)).astype(np.int32)
    ids[rng.integers(0, n, max(n // 100, 1))] = -1
    ids[rng.integers(0, n, max(n // 100, 1))] = s
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,s,dtype", [
    (1000, 8, 64, torch.float32), (5000, 16, 128, torch.float32),
    (2048, 8, 64, torch.float16), (3000, 8, 16384, torch.float32),
    (1 << 16, 1, 4096, torch.float32), (4096, 64, 1024, torch.bfloat16)])
@pytest.mark.parametrize("kind", ["solid", "uniform"])
def test_scatter_kernels_match_plain(cuda, n, d, s, dtype, kind):
    ids_np = _ids(kind, n, s)
    ids = torch.as_tensor(ids_np, device=cuda)
    vals = torch.as_tensor(np.random.default_rng(5).random((n, d)),
                           device=cuda).to(dtype)
    before = dict(sk.LAUNCHES)
    got = sk.scatter_add_launch(vals, ids, s)
    stream = torch.as_tensor(scatter_ops.committed_id_stream(ids_np, s),
                             device=cuda)
    k6_out, k6_deg = sk.scatter_add_instrumented_launch(vals.float(), stream,
                                                        s)
    counts = sk.bincount_launch(ids, min(s, sk.MAX_BINCOUNT_SEGMENTS))
    torch.cuda.synchronize()
    assert all(sk.LAUNCHES[k] == before[k] + 1 for k in before)
    plain = sk.scatter_add_plain(vals, ids, s)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    p_out, p_deg = sk.scatter_add_instrumented_plain(vals.float(), stream, s)
    torch.testing.assert_close(k6_out, p_out, rtol=1e-5, atol=1e-5)
    assert torch.equal(k6_deg, p_deg)
    np.testing.assert_array_equal(
        k6_deg.cpu().numpy().astype(np.float64),
        counters._degrees_full_waves(stream.cpu().numpy().reshape(-1, 1024),
                                     32))
    assert torch.equal(counts, sk.bincount_plain(
        ids, min(s, sk.MAX_BINCOUNT_SEGMENTS)))


ADVERSARIAL = streams.adversarial_streams()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("d,s", [(1, 4096), (1, 32768), (8, 1024), (8, 4096),
                                 (64, 256), (64, 1024)])
def test_k6_on_adversarial_streams(cuda, name, d, s):
    """K6 on each designed stream, on the shared route and on the global
    one at d = 1, 8 and 64, with values for all but the last 37 rows:
    degrees bit-equal, sums within rtol/atol 1e-5."""
    stream_np = ADVERSARIAL[name]
    ids = torch.as_tensor(stream_np, device=cuda)
    n = stream_np.size - 37
    vals = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (n, d), np.float32), device=cuda)
    out, deg = sk.scatter_add_instrumented_launch(vals, ids, s)
    torch.cuda.synchronize()
    p_out, p_deg = sk.scatter_add_instrumented_plain(vals, ids, s)
    torch.testing.assert_close(out, p_out, rtol=1e-5, atol=1e-5)
    assert torch.equal(deg, p_deg)
    np.testing.assert_array_equal(
        deg.cpu().numpy().astype(np.float64),
        counters._degrees_full_waves(stream_np.reshape(-1, 1024), 32))


# (d, S) of each K5 route: shared copies of S x d f32 within the 96 KB
# budget, global ones past it
K5_ROUTES = {(1, "shared"): 4096, (1, "global"): 32768,
             (8, "shared"): 1024, (8, "global"): 4096,
             (64, "shared"): 256, (64, "global"): 1024,
             (2048, "global"): 4096}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("d,route", list(K5_ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_on_adversarial_streams(cuda, name, d, route, dtype):
    """K5 on each designed stream cut to its first size - 37 rows (a
    partial last warp at d = 1), on both routes (the global one with
    vector adds at d = 8, 64, and owned rows at d = 2048): sums within
    rtol/atol 1e-5."""
    s = K5_ROUTES[d, route]
    ids_np = ADVERSARIAL[name][:-37]
    ids = torch.as_tensor(ids_np, device=cuda)
    vals = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (ids_np.size, d), np.float32), device=cuda).to(dtype)
    assert sk.scatter_route(s, d) == route
    if route == "global" and d > 1:
        route = ("global-owned" if d >= sk.OWNED_MIN_COLUMNS
                 else "global-vector")
    assert sk.scatter_add_route(vals, s) == route
    before = sk.LAUNCHES["scatter_add"]
    got = sk.scatter_add_launch(vals, ids, s)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["scatter_add"] == before + 1
    torch.testing.assert_close(got, sk.scatter_add_plain(vals, ids, s),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d % 4 != 0", "unaligned rows",
                                  "unaligned base"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_scalar_global_route(cuda, case, dtype):
    """The global route adds scalars where a row does not split into
    16-byte parts: d = 6; bf16 at d = 4 (8-byte rows); a view of the
    values that starts 4 or 2 bytes past an aligned address."""
    rng = np.random.default_rng(11)
    d = {"d % 4 != 0": 6, "unaligned rows": 4, "unaligned base": 8}[case]
    if case == "unaligned rows" and dtype == torch.float32:
        d = 5
    n, s = 5000, 16384
    flat = torch.as_tensor(rng.standard_normal(n * d + 1, np.float32),
                           device=cuda).to(dtype)
    vals = (flat[1:] if case == "unaligned base" else flat[:-1]).view(n, d)
    ids = torch.as_tensor(_ids("solid" if dtype == torch.bfloat16
                               else "uniform", n, s), device=cuda)
    assert sk.scatter_add_route(vals, s) == "global"
    got = sk.scatter_add_launch(vals, ids, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sk.scatter_add_plain(vals, ids, s),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["solid", "uniform", "skewed"])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 2048),
                                     (torch.bfloat16, 2048)])
def test_k5_owned_route_beyond_one_list(cuda, kind, dtype, d):
    """The owned route on 10,000 rows, more than a block lists before it
    sums (4096): a solid stream sends them all to one block, which sums
    three lists into one output row; strays drop."""
    n, s = 10000, 4096
    rng = np.random.default_rng(13)
    ids_np = (streams.skewed_ids(n, s, seed=13) if kind == "skewed"
              else _ids(kind, n, s))
    vals = torch.as_tensor(rng.standard_normal((n, d), np.float32),
                           device=cuda).to(dtype)
    ids = torch.as_tensor(ids_np, device=cuda)
    assert sk.scatter_add_route(vals, s) == "global-owned"
    got = sk.scatter_add_launch(vals, ids, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sk.scatter_add_plain(vals, ids, s),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("reorder", [False, True])
def test_k4_on_adversarial_images(cuda, name, channels, reorder):
    """K4 on each designed stream laid out as an image, with random
    weights of which a fifth are 0: sums within rtol/atol 1e-5."""
    img = torch.as_tensor(streams.stream_image(ADVERSARIAL[name], channels),
                          device=cuda)
    w_np = np.random.default_rng(12).random(img.shape[0]).astype(np.float32)
    w_np[::5] = 0.0
    w = torch.as_tensor(w_np, device=cuda)
    before = hk.LAUNCHES["hist_weighted"]
    got = hk.histogram_launch(img, reorder=reorder, weights=w)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["hist_weighted"] == before + 1
    torch.testing.assert_close(got, hk.histogram_weighted_plain(img, w, 256),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("reorder", [False, True])
def test_k3_on_adversarial_streams(cuda, name, channels, reorder):
    """K3 on each designed stream laid out as an image: counts and degrees
    bit-equal to the plain version and to the committed stream's."""
    img_np = streams.stream_image(ADVERSARIAL[name], channels)
    img = torch.as_tensor(img_np, device=cuda)
    counts, deg = hk.histogram_launch(img, reorder=reorder, instrumented=True)
    torch.cuda.synchronize()
    p_counts, p_deg = hk.histogram_instrumented_plain(img, 256, reorder)
    assert torch.equal(counts, p_counts)
    assert torch.equal(deg, p_deg)
    committed = ops.committed_index_stream(
        img_np, variant="hist2" if reorder else "hist")
    np.testing.assert_array_equal(
        deg.cpu().numpy().reshape(-1).astype(np.float64),
        counters._degrees_full_waves(committed.reshape(-1, 1024), 32))


def _k7_ids(kind, n, s):
    """K7's streams: uniform or solid with strays (``_ids``), skewed
    (``streams.skewed_ids``) or collapsed (every id 0)."""
    if n == 0:
        return np.zeros(0, np.int32)
    if kind == "skewed":
        return streams.skewed_ids(n, s, seed=5)
    if kind == "collapsed":
        return np.zeros(n, np.int32)
    return _ids(kind, n, s)


_BLOCK = sk.BINCOUNT_BLOCK_IDS
# (stream, n, S, offset of the view ids[offset:]): n % 4 of 0-3, no ids,
# S = 1, 128 and 8192, views 4 bytes into a 16-byte word, both sides of
# the one-block route's limit, and the adversarial streams
_K7_CASES = sorted(
    {("uniform", 1, 2, 0), ("uniform", 65536, 128, 0),
     ("uniform", 70001, 8192, 0)}
    | {("uniform", n, s, off) for n in (0, 1, 3, 5, 70001)
       for s in (1, 128, 8192) for off in (0, 1)}
    | {("uniform", n, s, off) for n in (_BLOCK, _BLOCK + 1)
       for s in (128, 8192) for off in (0, 1)}
    | {("uniform", (1 << 22) + 3, 8192, 1), ("solid", 70001, 8192, 0),
       ("solid", 1 << 20, 8192, 1), ("skewed", 70001, 8192, 1),
       ("skewed", 1 << 20, 8192, 0), ("skewed", 4099, 128, 0),
       ("collapsed", 65536, 128, 0), ("collapsed", 65536, 128, 1),
       ("collapsed", 32, 128, 0)})


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,s,off", _K7_CASES)
def test_bincount_kernel_bitwise(cuda, kind, n, s, off):
    """K7 bit-equal to the plain version on either route, into an output
    block that held 0x7f bytes before the call (the block route stores
    every count into an unzeroed allocation, the grid route's launcher
    zeroes it)."""
    ids = torch.as_tensor(_k7_ids(kind, n + off, s), device=cuda)[off:]
    dirty = torch.full((s,), 0x7F7F7F7F, dtype=torch.int32, device=cuda)
    del dirty  # the caching allocator hands this block to the output
    before = sk.LAUNCHES["bincount"]
    got = sk.bincount_launch(ids, s)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["bincount"] == before + 1
    assert torch.equal(got, sk.bincount_plain(ids, s))


@pytest.mark.cuda
def test_solid_stream_degrees_and_tool1(cuda):
    ids = np.zeros(1 << 16, np.int32)
    _, c = scatter_ops.instrumented_scatter_add(ids, np.ones(ids.size), 4096)
    assert c["degree"].mean() == 32.0
    table = microbench.build_table(mode="kernel", kernel_validation_points=8)
    for rec in table.meta["kernel_validation"]:
        assert rec["e_rel_err"] < 0.05, rec


@pytest.mark.cuda
@pytest.mark.parametrize("skew", ["balanced", "collapsed"])
def test_scatter_kernel_provider_validates_exactly(cuda, skew, tmp_path):
    rng = np.random.default_rng(0)
    ids = (rng.integers(0, 128, 1 << 16) if skew == "balanced"
           else np.zeros(1 << 16)).astype(np.int32)
    sess = Session("v5e", cache_dir=tmp_path)
    for spec in (WorkloadSpec.from_scatter_add(
            ids, np.ones((ids.size, 1), np.float32), 128, label=skew,
            waves_per_tile=32),
            WorkloadSpec.from_indices(ids, 128, label=skew)):
        report = sess.validate(spec, ("trace", "kernel"))
        assert report.max_rel_err == 0.0
        assert [c.batch_bitwise_equal for c in report.comparisons] == \
            [True, True]


@pytest.mark.cuda
def test_audit_finding_specs_validate_through_k6(cuda, tmp_path):
    """Each distinct finding spec of the full-width qwen3-moe decode
    audit through the trace provider and K6 on the card: e relative error
    exactly 0.0, one K6 launch a spec, none during the audit itself."""
    import gzip
    import pathlib

    from _audit_specs import distinct_specs, kernel_ready
    from repro_torch.audit import audit_hlo

    text = gzip.decompress((pathlib.Path(__file__).parent / "data"
                            / "qwen3_moe_235b_a22b__decode.hlo.gz")
                           .read_bytes()).decode()
    sess = Session("v5e", cache_dir=tmp_path)
    before = dict(sk.LAUNCHES)
    rep = audit_hlo(text, session=sess, label="qwen3-moe/decode")
    assert dict(sk.LAUNCHES) == before
    specs = distinct_specs(rep)
    assert len(specs) == 10
    for spec in specs.values():
        report = sess.validate(kernel_ready(spec), ("trace", "kernel"),
                               check_batch=False)
        trace, measured = report.comparisons
        assert report.max_rel_err == 0.0, report.to_dict()
        assert measured.counters["N"] == trace.counters["N"]
        assert measured.counters["O"] == trace.counters["O"]
    torch.cuda.synchronize()
    assert sk.LAUNCHES["scatter_add_instrumented"] - \
        before["scatter_add_instrumented"] == len(specs)


@pytest.mark.cuda
def test_scatter_kernels_refuse_what_they_cannot_take(cuda):
    ids = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="values"):
        sk.scatter_add_launch(torch.ones((64, 2), dtype=torch.float64,
                                         device=cuda), ids, 8)
    with pytest.raises(ValueError, match="ids"):
        sk.scatter_add_launch(torch.ones((64, 2), device=cuda),
                              ids.to(torch.int64), 8)
    with pytest.raises(ValueError, match="values"):
        sk.scatter_add_instrumented_launch(
            torch.ones((64, 2), dtype=torch.float16, device=cuda),
            torch.zeros(1024, dtype=torch.int32, device=cuda), 8)
    with pytest.raises(ValueError, match="8192"):
        sk.bincount_launch(ids, 8193)


def _qkv(b, h, kv, t, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                            device=device).to(dtype)
            for shape in ((b, h, t, d), (b, kv, t, d), (b, kv, t, d))]


FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _assert_flash_close(got, want, q, k, v, causal, group):
    """The reference's bounds, or at bf16 beyond T = 64 the bound scaled
    to the output (module docstring)."""
    if q.dtype == torch.float32 or q.shape[2] <= 64:
        tol = FLASH_TOL[q.dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        return
    err = (got.float() - want.float()).abs()
    mag = want.float().abs()
    p_abs_v = fk.attention_plain(q.float(), k.float(), v.float().abs(),
                                 causal=causal, group=group)
    assert bool((err <= 1.6e-2 * mag + 2.0 ** -8 * p_abs_v).all())
    for rows in (slice(None), slice(q.shape[2] // 2, None)):
        assert err[:, :, rows].mean() <= 2.0 ** -8 * mag[:, :, rows].mean()


# bf16 at d = 64 and 128 runs the Hopper route (TMA, wgmma): one query
# row, a row short of and a row past a 128-row tile, and a long ragged T,
# at GQA groups 1, 4 and 8
HOPPER_SHAPES = [(2, 8, 8 // group, t, d) for d in (64, 128)
                 for t in (1, 127, 129, 2000) for group in (1, 4, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,d", [
    (1, 2, 2, 64, 32), (1, 4, 4, 128, 64), (1, 1, 1, 256, 16),
    (2, 2, 2, 64, 32), (2, 8, 1, 200, 128), (1, 16, 2, 2048, 128),
    (3, 4, 2, 100, 64)] + HOPPER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, b, h, kv, t, d, dtype, causal):
    """f32 and bf16, causal and not, GQA groups 1 to 8, and lengths that
    leave a ragged last tile (1, 100, 127, 129, 200, 2000)."""
    q, k, v = _qkv(b, h, kv, t, d, dtype, cuda)
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention_launch(q, k, v, causal=causal, group=h // kv)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fk.attention_plain(q, k, v, causal=causal, group=h // kv)
    _assert_flash_close(got, want, q, k, v, causal, h // kv)
    if kv == h:
        for i in range(b):
            _assert_flash_close(
                got[i:i + 1],
                flash_ref.attention_ref(q[i], k[i], v[i], causal)[None],
                q[i:i + 1], k[i:i + 1], v[i:i + 1], causal, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,d,causal", [
    (4, 12, 12, 1500, 64, False),    # whisper-small's encoder
    (4, 12, 12, 448, 64, True),      # its decoder's prefill
    (4, 32, 8, 2048, 128, True),     # llama-3.2-vision-11b, GQA group 4
    (4, 32, 32, 2048, 64, True)])    # zamba2-1.2b's shared attention
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_families_shapes(cuda, b, h, kv, t, d, causal,
                                             dtype):
    """K8 where the families' serving path launches it, over every row and
    over the last tile's alone: at T = 1500 (11 x 128 + 92) without a
    causal mask only the key-length check masks that tile."""
    q, k, v = _qkv(b, h, kv, t, d, dtype, cuda, seed=9)
    got = fk.flash_attention_launch(q, k, v, causal=causal, group=h // kv)
    torch.cuda.synchronize()
    want = fk.attention_plain(q, k, v, causal=causal, group=h // kv)
    _assert_flash_close(got, want, q, k, v, causal, h // kv)
    last = slice(t - (t % 128 or 128), None)
    err = (got.float() - want.float())[:, :, last].abs()
    if dtype == torch.float32:
        assert float(err.max()) <= FLASH_TOL[dtype]
    else:
        assert err.mean() <= 2.0 ** -8 * want.float()[:, :, last].abs().mean()


@pytest.mark.cuda
def test_gemma2_local_layer_window_at_full_width(cuda, monkeypatch):
    """One gemma2-27b local layer at its published widths (4608, 32/16 x
    128, window 4096, softcap 50.0) in f32, TF32 off, over 4608 tokens,
    512 rows past the window, within 2e-4 of the banded f64 attention."""
    from _gemma2_window import banded_attention_f64, local_layer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    acfg, p, _, x = local_layer(cuda, 4608)
    assert (acfg.window, acfg.logit_softcap) == (4096, 50.0)
    with torch.no_grad():
        got, _ = attention.attend(p, x, acfg)
        want, _ = banded_attention_f64(p, x, acfg)
    assert float((got.double() - want).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_gemma2_ring_equals_a_full_buffer_at_full_width(cuda, monkeypatch):
    """The same layer decoded 4160 steps through its 4096-slot ring and
    through a 4160-slot buffer, equal within 1e-5 on every step."""
    from _gemma2_window import local_layer, ring_against_full

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    acfg, p, gen, x = local_layer(cuda, 1)
    x = torch.randn((1, 4160, x.shape[-1]), generator=gen, device=cuda)
    slots, worst, _ = ring_against_full(p, x, acfg)
    assert slots == (4096, 4160)
    assert worst <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bkv", [(16, 64), (64, 16), (32, 32)])
def test_flash_ops_blocks_on_the_card(cuda, bq, bkv):
    q, k, v = _qkv(1, 2, 2, 64, 32, torch.float32, cuda, seed=1)
    got = flash_ops.flash_attention(q[0], k[0], v[0], bq=bq, bkv=bkv)
    torch.testing.assert_close(got, flash_ref.attention_ref(q[0], k[0], v[0]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 32, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="backward"):
        fk.flash_attention_launch(q.requires_grad_(), k, v, group=2)
    q = q.detach()
    with torch.no_grad():
        fk.flash_attention_launch(q.requires_grad_(), k, v, group=2)
    q = q.detach()
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_launch(q.half(), k.half(), v.half(), group=2)
    with pytest.raises(ValueError, match="groups"):
        fk.flash_attention_launch(q, k, v, group=4)
    with pytest.raises(ValueError, match="whole number"):
        flash_ops.flash_attention(q, k, v, group=2, bq=48)


# latent attention (DeepSeek-V3's MLA) attends at q·k 192 and v 128 with
# one KV head a query head, at the softmax scale of its YaRN (192^-0.5
# times (0.1 ln 40 + 1)^2); its prefill's three shapes of 16,384 tokens,
# and one query row, a row short of and past a tile, and a ragged T
MLA_SCALE = 192 ** -0.5 * (0.1 * np.log(40.0) + 1.0) ** 2
MLA_SHAPES = [(2, 8, 1), (2, 8, 127), (2, 8, 129), (2, 8, 2000),
              (1, 128, 16384), (2, 128, 8192), (4, 128, 4096)]


def _mla_reference(q, k, v, scale, causal=True, budget=1 << 32):
    """f32 attention of bf16 q, k (B, H, T, 192) over v (B, H, T, 128),
    a block of heads at a time so that the scores fit ``budget`` bytes:
    the output and sum_j p_j |v_j|, both f32 (B, H, T, 128)."""
    b, h, t, _ = q.shape
    per = max(1, budget // (b * t * t * 4))
    out = torch.empty((2, b, h, t, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    above = torch.ones((t, t), dtype=torch.bool, device=q.device).triu_(1)
    for i in range(0, h, per):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, i:i + per].float(),
                         k[:, i:i + per].float()).mul_(scale)
        if causal:
            s.masked_fill_(above, -2.0e38)
        p = torch.softmax(s, dim=-1)
        del s
        vs = v[:, i:i + per].float()
        out[0, :, i:i + per] = p @ vs
        out[1, :, i:i + per] = p @ vs.abs()
    return out[0], out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t", MLA_SHAPES)
def test_flash_kernel_at_latent_attention_head_sizes(cuda, b, h, t):
    """K8's bf16 route at q·k 192, v 128 (``flash_mla_sm90_kernel``)
    against f32 attention, within the bf16 bounds of the module docstring,
    over every row and the last tile's alone; one launch, v's head size
    out."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k = (torch.randn((b, h, t, 192), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, h, t, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention_launch(q, k, v, causal=True, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (b, h, t, 128) and got.dtype == torch.bfloat16
    want, p_abs_v = _mla_reference(q, k, v, MLA_SCALE)
    err = (got.float() - want).abs()
    mag = want.abs()
    assert bool((err <= 1.6e-2 * mag + 2.0 ** -8 * p_abs_v).all())
    last = slice(t - (t % 128 or 128), None)
    for rows in (slice(None), slice(t // 2, None), last):
        assert err[:, :, rows].mean() <= 2.0 ** -8 * mag[:, :, rows].mean()


@pytest.mark.cuda
def test_latent_attention_route_refuses_other_pairs(cuda):
    """(192, 128) takes bf16 alone, and no other pair of head sizes."""
    q = torch.zeros((1, 2, 64, 192), device=cuda)
    v = torch.zeros((1, 2, 64, 128), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_launch(q, q, v)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_launch(q[..., :128].bfloat16(),
                                  q[..., :128].bfloat16(), v[..., :64]
                                  .bfloat16())


@pytest.mark.cuda
def test_deepseek_prefill_launches_k8_each_layer(cuda):
    """DeepSeek-V3 at its published widths, cut to its 3 dense layers and
    2 MoE layers holding 8 of the 256 experts, in bf16: one prefill of 2 x
    2048 tokens through ``serve.step.make_prefill`` launches K8's forward
    once a layer (the (192, 128) route, with no backward kernel), and K7
    and K5 once an MoE layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import step

    cfg = dataclasses.replace(get_config("deepseek-v3"), num_layers=5,
                              experts_held=8)
    model = registry.build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048),
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1), device=cuda, dtype=torch.int32)
    prefill = step.make_prefill(model, step.ServeConfig(max_len=4096))
    fk.reset_launches()
    sk.reset_launches()
    with torch.no_grad():
        logits, cache = prefill(params, tokens)
    torch.cuda.synchronize()
    assert dict(fk.LAUNCHES) == {"flash_attention": 5,
                                 "flash_attention_fwd": 0,
                                 "flash_attention_bwd": 0}
    assert (sk.LAUNCHES["bincount"], sk.LAUNCHES["scatter_add"]) == (2, 2)
    assert logits.shape[:2] == (2, 2048)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_prefill_attention_refuses_a_head_size_the_kernel_lacks(cuda):
    """The prefill route is K8's whatever the head size: one it does not
    take raises on the card rather than running the plain ``_sdpa``."""
    cfg = attention.AttnConfig(d_model=64, num_heads=4, num_kv_heads=2,
                               head_dim=8)
    params = attention.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    x = torch.zeros((1, 128, 64), dtype=torch.bfloat16, device=cuda)
    before = fk.LAUNCHES["flash_attention"]
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        attention.attend(params, x, cfg)
    assert fk.LAUNCHES["flash_attention"] == before


def _grad_reference(q, k, v, dout, causal, group):
    """out and (dq, dk, dv) by autograd through the f32 attention on the
    bf16 inputs."""
    b, h, t, d = q.shape
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    qg = leaves[0].reshape(b, h // group, group, t, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, leaves[1]) * d ** -0.5
    if causal:
        s = s.masked_fill(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device).triu(1), -2.0e38)
    out = torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(s, dim=-1),
                       leaves[2]).reshape(b, h, t, d)
    out.backward(dout.float())
    return out.detach(), [x.grad for x in leaves]


def _rel_err(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


# the live train shapes (granite-moe, qwen3-moe), then ragged T, GQA groups
# 1 to 8, causal and not
GRAD_SHAPES = [(8, 16, 8, 2048, 64, True), (4, 64, 4, 2048, 128, True),
               (2, 4, 2, 200, 64, True), (2, 4, 4, 129, 128, True),
               (1, 8, 1, 300, 64, False), (1, 4, 1, 1000, 128, False),
               (1, 8, 2, 2000, 128, True), (2, 16, 8, 256, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,d,causal", GRAD_SHAPES)
def test_flash_backward_matches_f32_autograd(cuda, b, h, kv, t, d, causal):
    """``flash_attention_fwd`` and ``flash_attention_bwd`` on the card: the
    output bit-equal to the prefill's K8 (the same kernel without the LSE
    store), the LSE within 1e-4 of the plain version's (ex2.approx), and
    dq, dk, dv each within 2^-7 relative Frobenius error of f32 autograd
    (module docstring); one launch of each."""
    q, k, v, dout = _qkv(b, h, kv, t, d, torch.bfloat16, cuda, seed=t) + \
        _qkv(b, h, kv, t, d, torch.bfloat16, cuda, seed=t + 1)[:1]
    group, scale = h // kv, d ** -0.5
    before = dict(fk.LAUNCHES)
    with torch.no_grad():
        prefill = fk.flash_attention_launch(q, k, v, causal=causal,
                                            group=group)
    out, lse = fk.flash_attention_fwd_op(q, k, v, causal, group, scale)
    grads = fk.flash_attention_bwd_op(dout, q, k, v, out, lse, causal, group,
                                      scale)
    torch.cuda.synchronize()
    assert {n: fk.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, "flash_attention_fwd": 1,
        "flash_attention_bwd": 1}
    assert torch.equal(out, prefill)
    _, want_lse = fk.attention_fwd_plain(q.float(), k.float(), v.float(),
                                         causal=causal, group=group)
    assert float((lse - want_lse).abs().max()) <= 1e-4
    _, want = _grad_reference(q, k, v, dout, causal, group)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert bool(torch.isfinite(got).all()), name
        assert _rel_err(got, ref) <= 2.0 ** -7, (name, _rel_err(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,d", [(8, 16, 8, 2048, 64),
                                        (4, 64, 4, 2048, 128),
                                        (2, 8, 2, 333, 64)])
def test_flash_backward_is_deterministic(cuda, b, h, kv, t, d):
    """No float atomics: two runs of the backward give bit-equal dq, dk
    and dv."""
    q, k, v, dout = _qkv(b, h, kv, t, d, torch.bfloat16, cuda, seed=3) + \
        _qkv(b, h, kv, t, d, torch.bfloat16, cuda, seed=4)[:1]
    out, lse = fk.flash_attention_fwd_op(q, k, v, True, h // kv, d ** -0.5)
    first = fk.flash_attention_bwd_op(dout, q, k, v, out, lse, True, h // kv,
                                      d ** -0.5)
    second = fk.flash_attention_bwd_op(dout, q, k, v, out, lse, True,
                                       h // kv, d ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_one_query_row_has_no_query_or_key_gradient(cuda):
    """At T = 1 every softmax is over one key, so dq and dk are 0 in exact
    arithmetic: the kernel's are within f32 rounding of dP - D."""
    q, k, v, dout = _qkv(2, 8, 1, 1, 128, torch.bfloat16, cuda, seed=2) + \
        _qkv(2, 8, 1, 1, 128, torch.bfloat16, cuda, seed=5)[:1]
    out, lse = fk.flash_attention_fwd_op(q, k, v, True, 8, 128 ** -0.5)
    dq, dk, dv = fk.flash_attention_bwd_op(dout, q, k, v, out, lse, True, 8,
                                           128 ** -0.5)
    assert float(dq.float().abs().max()) <= 1e-3
    assert float(dk.float().abs().max()) <= 1e-3
    _, want = _grad_reference(q, k, v, dout, True, 8)
    assert _rel_err(dv, want[2]) <= 2.0 ** -7


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_fwd_op(q, k, v, True, 2, 0.125)
    q, k, v = _qkv(1, 4, 2, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="bf16"):
        fk.flash_attention_fwd_op(q, k, v, True, 2, 0.125)


@pytest.mark.cuda
def test_attend_under_grad_runs_the_backward_kernels(cuda):
    """A bf16 layer at head_dim 64 under grad: one forward launch with the
    LSE and one backward launch, no K8 without it, gradients finite."""
    cfg = attention.AttnConfig(d_model=256, num_heads=4, num_kv_heads=2,
                               head_dim=64)
    params = attention.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    for leaf in (x for p in params.values() for x in p.values()):
        leaf.requires_grad_()
    x = torch.randn((2, 300, 256), device=cuda).to(torch.bfloat16)
    before = dict(fk.LAUNCHES)
    out, _ = attention.attend(params, x, cfg)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: fk.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 0, "flash_attention_fwd": 1,
        "flash_attention_bwd": 1}
    assert all(bool(torch.isfinite(x.grad).all())
               for p in params.values() for x in p.values())


@pytest.mark.cuda
def test_moe_layer_at_full_width(cuda, monkeypatch):
    """One qwen3-moe-235b-a22b MoE layer at its published widths (d_model
    4096, 128 experts x 1536, top-8) in f32, TF32 off, on 2048 seeded
    tokens: one K7 launch, its counts bit-equal to ``bincount_plain`` of
    the same ids; one K5 launch, the layer's output within 1e-5 of the
    plain composition (the same route, sort and products, then the
    reference's unsort and f32 einsum in place of K5's segment sum)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-235b-a22b")
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_expert=cfg.d_expert,
                         num_experts=cfg.num_experts, top_k=cfg.top_k,
                         dtype="float32")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init(gen, mcfg)
    t, e, k = 2048, mcfg.num_experts, mcfg.top_k
    x = torch.randn((t, mcfg.d_model), generator=gen, device=cuda)
    counted = []
    k7 = sk.bincount_launch

    def recorded(ids, segments):
        counted.append((ids, k7(ids, segments)))
        return counted[-1][1]

    monkeypatch.setattr(sk, "bincount_launch", recorded)
    before = dict(sk.LAUNCHES)
    with torch.no_grad():
        out, _, disp = moe.apply_local(p, x, mcfg)
        torch.cuda.synchronize()
        assert (sk.LAUNCHES["bincount"] - before["bincount"],
                sk.LAUNCHES["scatter_add"] - before["scatter_add"]) == (1, 1)
        ids, counts = counted[0]
        assert ids.numel() == t * k
        assert torch.equal(counts, sk.bincount_plain(ids, e))
        gates, rids, _ = moe.route(p, x, mcfg)
        flat, order, sorted_ids, xs = moe._sort(x, rids, k)
        assert torch.equal(disp, flat) and torch.equal(sorted_ids, ids)
        capacity = moe._capacity(t * k, e, mcfg)
        y_sorted = moe._expert_ffn_grouped(p, xs, sorted_ids, e, capacity,
                                           mcfg)
        y = y_sorted[torch.argsort(order, stable=True)].reshape(t, k, -1)
        want = torch.einsum("tkd,tk->td", y, gates)
    assert out.dtype == torch.float32 and out.shape == (t, mcfg.d_model)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,segments", [(131072, 1024, 16384),
                                          (32, 1024, 4), (5000, 3, 70)])
def test_scatter_add_autograd_on_the_card(cuda, n, d, segments):
    """K5 under autograd: the forward is K5 (one launch), within 1e-5 of
    the plain f64 sum; the backward is bit for bit autograd's own
    gradient of the plain version's ``index_add``, 0 on dropped rows.
    K5's own result has no ``grad_fn``: without the Function autograd
    would drop this gradient silently."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    vals = torch.randn((n, d), generator=gen, device=cuda)
    ids = torch.randint(-2, segments + 2, (n,), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.randn((segments, d), generator=gen, device=cuda)
    assert sk.scatter_add_launch(vals, ids, segments).grad_fn is None
    got = vals.clone().requires_grad_()
    before = sk.LAUNCHES["scatter_add"]
    out = sk.scatter_add_autograd(got, ids, segments)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert sk.LAUNCHES["scatter_add"] - before == 1
    want = vals.clone().requires_grad_()
    plain = sk.scatter_add_plain(want, ids, segments)
    (plain * w).sum().backward()
    torch.testing.assert_close(out.detach(), plain.detach(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got.grad, want.grad)
    dropped = (ids < 0) | (ids >= segments)
    assert dropped.any() and not got.grad[dropped].any()


@pytest.mark.cuda
def test_moe_layer_gradients_at_full_width(cuda, monkeypatch):
    """One granite-moe-1b-a400m MoE layer at its published widths in f32,
    TF32 off, on 2048 seeded tokens, under autograd: K7 and K5 launched
    once each; the gradients of x, the router and every expert weight
    within 1e-4 x their largest of the same layer with the plain combine
    (autograd's own ``index_add``), and the expert weights' non-zero."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m")
    mcfg = moe.MoEConfig(d_model=cfg.d_model, d_expert=cfg.d_expert,
                         num_experts=cfg.num_experts, top_k=cfg.top_k,
                         dtype="float32")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = moe.init(gen, mcfg)
    x = torch.randn((2048, mcfg.d_model), generator=gen, device=cuda)
    w = torch.randn((2048, mcfg.d_model), generator=gen, device=cuda)

    def grads():
        leaves = [x, p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"]]
        live = [t.detach().requires_grad_() for t in leaves]
        q = dict(p, router={"w": live[1]}, w_gate=live[2], w_up=live[3],
                 w_down=live[4])
        out, aux, _ = moe.apply_local(q, live[0], mcfg)
        return torch.autograd.grad((out * w).sum() + aux, live)

    before = dict(sk.LAUNCHES)
    got = grads()
    torch.cuda.synchronize()
    assert (sk.LAUNCHES["bincount"] - before["bincount"],
            sk.LAUNCHES["scatter_add"] - before["scatter_add"]) == (1, 1)
    monkeypatch.setattr(sk, "scatter_add_autograd", sk.scatter_add_plain)
    want = grads()
    assert sk.LAUNCHES["scatter_add"] - before["scatter_add"] == 1
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert all(float(g.abs().max()) > 0 for g in got[2:])


# -- the mesh paths on a one-rank NCCL group ----------------------------------


@pytest.fixture(scope="module")
def one_rank_meshes():
    """A one-rank NCCL group (a ``HashStore``, the loopback interface) and
    its (1, 1, 1) ("pod", "data", "model") and (1, 1) meshes on the card;
    the group is destroyed after the module's cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import os

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield (mesh_mod.compat_make_mesh((1, 1, 1), ("pod", "data", "model")),
               mesh_mod.compat_make_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()


def _launch_counts(fn):
    before = {**sk.LAUNCHES, **fk.LAUNCHES}
    out = fn()
    torch.cuda.synchronize()
    after = {**sk.LAUNCHES, **fk.LAUNCHES}
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("path,experts,cf", [("ep", 64, 8.0),
                                             ("sharded", 8, 1.25)])
def test_moe_mesh_paths_on_one_rank(cuda, one_rank_meshes, path, experts,
                                    cf):
    """``apply_ep`` (64 experts, capacity 8.0: nothing drops) and
    ``apply_sharded`` (8 experts, capacity 1.25: rows drop, the same as
    ``apply_local``'s) in f32 on one rank, against ``apply_local``
    within 1e-5: K7 twice (the dispatch and the local experts) or once,
    K5 once."""
    from repro_torch.models import moe
    from repro_torch.parallel import ctx as pctx
    mesh = one_rank_meshes[0] if path == "ep" else one_rank_meshes[1]
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    cfg = moe.MoEConfig(d_model=256, d_expert=128, num_experts=experts,
                        top_k=4, capacity_factor=cf, dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init(gen, cfg)
    x = torch.randn((2, 128, 256), generator=gen, device=cuda)
    want, _, disp_want = moe.apply_local(p, x.reshape(-1, 256), cfg)
    apply = moe.apply_ep if path == "ep" else moe.apply_sharded
    with pctx.use_mesh(mesh, data_axes=data_axes):
        (got, aux, disp), launches = _launch_counts(
            lambda: apply(p, x, cfg, mesh, data_axes=data_axes))
        got = got.full_tensor().reshape(-1, 256)
        disp = disp.full_tensor()
    assert launches == {"bincount": 2 if path == "ep" else 1,
                        "scatter_add": 1}
    assert torch.equal(disp, disp_want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_meshed_loss_and_prefill_on_one_rank(cuda, one_rank_meshes):
    """granite-moe-1b-a400m reduced (f32) with DTensor parameters on the
    (1, 1) mesh: the loss within 1e-5 of the unmeshed one, and a prefill
    (K8 a layer, as unmeshed) within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as shd
    mesh = one_rank_meshes[1]
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = make_batch(cfg, 4, 64, device=cuda)
    want, _ = model.loss(params, batch)
    with torch.no_grad():
        logits, k8 = _launch_counts(
            lambda: model.forward(params, batch["tokens"])[0])
    ps = shd.distribute(params, shd.param_shardings(params, cfg, mesh))
    bs = shd.distribute(batch, shd.shardings_of(
        shd.batch_pspecs(batch, ("data",)), mesh))
    with pctx.use_mesh(mesh, data_axes=("data",)):
        got, _ = model.loss(ps, bs)
        with torch.no_grad():
            mlogits, mk8 = _launch_counts(
                lambda: model.forward(ps, bs["tokens"])[0].full_tensor())
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5,
                               atol=1e-5)
    assert k8["flash_attention"] == mk8["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(mlogits, logits, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [
    "command-r-plus-104b", "gemma2-27b", "granite-moe-1b-a400m",
    "llama-3.2-vision-11b", "qwen1.5-110b", "qwen2-72b",
    "qwen3-moe-235b-a22b", "rwkv6-7b", "whisper-small", "zamba2-1.2b"])
def test_every_model_on_a_one_rank_mesh(cuda, one_rank_meshes, arch):
    """Each model of the zoo, reduced (f32), with DTensor parameters on
    the (1, 1) mesh: its loss and the gradient of every leaf against the
    unmeshed ones (1e-5; 1e-4 x the leaf's largest |g|), through this
    card's PyTorch build's DTensor rules."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as shd
    mesh = one_rank_meshes[1]
    cfg = get_config(arch).reduced()
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = make_batch(cfg, 4, 64, device=cuda)

    def loss_and_grads(p, b):
        live = [x.detach().requires_grad_() for x in tree.leaves(p)]
        loss, _ = model.loss(tree.unflatten(p, live), b)
        return loss, torch.autograd.grad(loss, live, allow_unused=True)

    want, want_g = loss_and_grads(params, batch)
    ps = shd.distribute(params, shd.param_shardings(params, cfg, mesh))
    bs = shd.distribute(batch, shd.shardings_of(
        shd.batch_pspecs(batch, ("data",)), mesh))
    with pctx.use_mesh(mesh, data_axes=("data",)):
        got, got_g = loss_and_grads(ps, bs)
        got = got.full_tensor()
        got_g = [None if g is None else g.full_tensor() for g in got_g]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got_g, want_g):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= 1e-4 * float(
                b.abs().max()) + 1e-7


# -- the kernel lint held to the kernels it models (tests/_lint_card.py) ----


@pytest.mark.cuda
def test_lint_k3_degrees_equal_the_static_derivation(cuda):
    import _lint_card

    hk.reset_launches()
    rows = _lint_card.k3_against_derivation("cuda")
    torch.cuda.synchronize()
    assert [r["name"] for r in rows] == list(_lint_card.STATIC_PROBES)
    assert hk.LAUNCHES["hist_instrumented"] == len(rows)


@pytest.mark.cuda
def test_lint_kern005_specs_through_k6(cuda):
    import _lint_card

    sk.reset_launches()
    rows = _lint_card.kern005_through_k6(Session("v5e"), "cuda")
    torch.cuda.synchronize()
    assert len(rows) == 2
    assert sk.LAUNCHES["scatter_add_instrumented"] == len(rows)
