"""The port's histogram family (K1-K4) against the reference's.

The same numpy images go through ``repro.kernels.histogram.ops`` (Pallas
in interpret mode, as the reference's own tests run it) and through
``repro_torch.kernels.histogram.ops`` on the CPU, where the wrappers run
the kernels' plain versions.  Counts, committed streams and degrees must
be bit-equal; weighted sums agree within the reference test's rtol/atol
1e-5 (f32 sums in another order).  The CUDA kernels themselves are held
against these plain versions on the card by ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as ref_counters
from repro.kernels import instrumentation as ref_instr
from repro.kernels.histogram import ops as ref_ops
from repro.kernels.histogram import ref as ref_ref
from repro_torch.core import timing
from repro_torch.data import streams
from repro_torch.kernels import instrumentation as instr
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.histogram import ops, ref

CPU = "cpu"


def _image(kind, n, c=4, seed=0):
    if kind == "solid":
        return np.full((n, c), 9, np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, c)).astype(np.int32)


def _ref_trace(img, variant, **kw):
    return ref_ops.histogram_instrumented(jnp.asarray(img), variant=variant,
                                          **kw)


@pytest.mark.parametrize("n_pixels", [256, 2048, 5000, 8192])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_histogram_matches_reference(n_pixels, variant):
    img = _image("uniform", n_pixels)
    got = ops.histogram(img, variant=variant, torch_device=CPU)
    want = ref_ops.histogram(jnp.asarray(img), variant=variant)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = ref.histogram_ref(torch.as_tensor(img))
    np.testing.assert_array_equal(oracle.numpy(), got.numpy())
    np.testing.assert_array_equal(
        oracle.numpy(), np.asarray(ref_ref.histogram_ref(jnp.asarray(img))))


@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_histogram_weighted_matches_reference(variant):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (3000, 4)).astype(np.int32)
    w = rng.random(3000).astype(np.float32)
    got = ops.histogram_weighted(img, w, variant=variant, torch_device=CPU)
    want = ref_ops.histogram_weighted(jnp.asarray(img), jnp.asarray(w),
                                      variant=variant)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    oracle = ref.histogram_weighted_ref(torch.as_tensor(img),
                                        torch.as_tensor(w))
    np.testing.assert_allclose(oracle.numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,n_pixels,variant,mean", [
    ("solid", 4096, "hist", 32.0),
    ("solid", 4096, "hist2", 8.0),
    ("uniform", 4096, "hist", None),
    ("uniform", 4096, "hist2", None),
    ("solid", 100, "hist", None),      # padded to one tile
    ("uniform", 100, "hist2", None),
])
def test_instrumented_degrees_bitwise(kind, n_pixels, variant, mean):
    img = _image(kind, n_pixels)
    hist, tr = ops.histogram_instrumented(img, variant=variant,
                                          torch_device=CPU)
    ref_hist, ref_tr = _ref_trace(img, variant)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))
    for f in ("degree", "job_class", "core", "lanes_active"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(ref_tr, f))
    assert tr.waves_per_tile == ref_tr.waves_per_tile
    if mean is not None:
        assert tr.degree.mean() == mean


@pytest.mark.parametrize("n_pixels", [100, 4096, 5000])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_committed_index_stream_matches(n_pixels, variant):
    img = _image("uniform", n_pixels, seed=4)
    got = ops.committed_index_stream(img, variant=variant)
    np.testing.assert_array_equal(
        got, ref_ops.committed_index_stream(img, variant=variant))
    # the kernel's plain stream is the same stream, built in torch
    padded = np.concatenate(
        [img, np.zeros(((-n_pixels) % hk.DEFAULT_TILE, 4), np.int32)])
    plain = hk.issue_ordered_bins_plain(torch.as_tensor(padded), 256,
                                        variant == "hist2")
    np.testing.assert_array_equal(plain.numpy(), got)


def test_instruction_classes():
    img = np.zeros((2048, 4), np.int32)
    _, popc = ops.histogram_instrumented(img, torch_device=CPU)
    _, fao = ops.histogram_instrumented(img, force_fao=True, torch_device=CPU)
    _, cas = ops.histogram_instrumented(img, weighted=True, torch_device=CPU)
    assert set(popc.job_class) == {timing.POPC}
    assert set(fao.job_class) == {timing.FAO}
    assert set(cas.job_class) == {timing.CAS}


@pytest.mark.parametrize("kind", ["solid", "uniform", "pairs"])
def test_wave_degrees_plain_matches_reference(kind):
    rng = np.random.default_rng(5)
    if kind == "solid":
        idx = np.zeros(4 * 1024, np.int32)
    elif kind == "uniform":
        idx = rng.integers(0, 1024, 4 * 1024).astype(np.int32)
    else:
        idx = rng.integers(0, 3, 4 * 1024).astype(np.int32)
    got = instr.wave_degrees_plain(torch.as_tensor(idx))
    want = ref_instr.wave_degrees(jnp.asarray(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = ref_counters._degrees_full_waves(idx.reshape(-1, 1024), 32)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), full)


@pytest.mark.parametrize("n_pixels", [100, 5000])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_three_channels_rotate_by_row_within_tile(n_pixels, variant):
    """32 % C != 0: hist2's rotation is by row within the 2048-pixel tile,
    not by lane within the warp, and the padded tail is in the degrees
    but not in the counts."""
    img = _image("solid", n_pixels, c=3)
    hist, tr = ops.histogram_instrumented(img, variant=variant,
                                          torch_device=CPU)
    ref_hist, ref_tr = _ref_trace(img, variant)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))
    np.testing.assert_array_equal(tr.degree, ref_tr.degree)
    assert tr.num_waves == 6 * -(-n_pixels // 2048)
    np.testing.assert_array_equal(
        ops.histogram(img, variant=variant, torch_device=CPU).numpy(),
        np.asarray(ref_ops.histogram(jnp.asarray(img), variant=variant)))


ADVERSARIAL = streams.adversarial_streams()


@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("channels", [3, 4])
def test_degrees_of_adversarial_images_equal_reference(name, channels):
    """Each designed stream laid out as an image (its ``hist`` commit
    groups are the stream's): K3's plain degrees for ``hist`` and
    ``hist2`` against the reference's committed stream and
    ``_degrees_full_waves``, bit for bit; at C = 3 a pixel group's steps
    straddle waves, and the int32 extremes wrap the flat index."""
    img = streams.stream_image(ADVERSARIAL[name], channels)
    for variant, reorder in (("hist", False), ("hist2", True)):
        committed = ref_ops.committed_index_stream(img, variant=variant)
        np.testing.assert_array_equal(
            ops.committed_index_stream(img, variant=variant), committed)
        _, deg = hk.histogram_instrumented_plain(torch.as_tensor(img), 256,
                                                 reorder)
        np.testing.assert_array_equal(
            deg.numpy().reshape(-1).astype(np.float64),
            ref_counters._degrees_full_waves(committed.reshape(-1, 1024),
                                             32))


@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_weighted_histogram_of_adversarial_images_equals_reference(
        name, channels, variant):
    """K4 through the port's ops (its plain version, the kernel's
    yardstick on the card) against the reference's Pallas kernel on each
    designed stream laid out as an image, with random weights of which a
    fifth are 0: flat indices that wrap or fall outside the range drop in
    both; sums within rtol/atol 1e-5."""
    img = streams.stream_image(ADVERSARIAL[name], channels)
    w = np.random.default_rng(11).random(img.shape[0]).astype(np.float32)
    w[::5] = 0.0
    got = ops.histogram_weighted(img, w, variant=variant, torch_device=CPU)
    want = ref_ops.histogram_weighted(jnp.asarray(img), jnp.asarray(w),
                                      variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_out_of_range_values_land_like_the_reference():
    """A value >= num_bins inside the flat range lands in the next
    channel's bins; a flat index outside [0, C * num_bins) drops."""
    img = _image("uniform", 2048, seed=6)
    img[:7, 0] = 300          # channel 0 -> channel 1's bin 44
    img[7:9, 3] = 260         # past the last channel: dropped
    img[9:11, 2] = -5         # channel 2 -> channel 1's bin 251
    for variant in ("hist", "hist2"):
        got = ops.histogram(img, variant=variant, torch_device=CPU)
        want = ref_ops.histogram(jnp.asarray(img), variant=variant)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_bins, fits", [(55359, True), (55360, False)])
def test_weighted_launch_counts_its_static_scratch(num_bins, fits):
    """K4's block holds its padded copy (a word after each 32) and 4 KB of
    per-warp scratch in one 227 KB budget: the largest one-channel weighted
    histogram that fits has 55,359 bins, and one bin more is refused before
    any launch."""
    img = torch.zeros((64, 1), dtype=torch.int32)
    w = torch.ones(64)
    words = num_bins + num_bins // 32
    assert (4 * words + hk.WEIGHTED_STATIC_BYTES <= hk.MAX_SHARED_BYTES) == fits
    if fits:
        hk._check_cuda(img, num_bins, hk.DEFAULT_TILE, w, False)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            hk._check_cuda(img, num_bins, hk.DEFAULT_TILE, w, False)
    # the counting kernels have no scratch: they take the same bins
    hk._check_cuda(img, num_bins, hk.DEFAULT_TILE, None, False)


def test_wrappers_take_no_device_by_themselves():
    """The CPU runs only when asked for: the wrappers default to CUDA."""
    img = _image("uniform", 256)
    for fn in (ops.histogram, ops.histogram_instrumented,
               ops.collect_counters):
        assert fn.__kwdefaults__["torch_device"] == "cuda"
    assert ops.histogram_weighted.__kwdefaults__["torch_device"] == "cuda"
    with pytest.raises(ValueError, match="no histogram kernel"):
        hk.histogram_launch(torch.as_tensor(img, device="meta"))


def test_collect_counters_matches_reference():
    img = _image("uniform", 6000, seed=7)
    got = ops.collect_counters(img, label="u", variant="hist2",
                               torch_device=CPU)
    want = ref_ops.collect_counters(img, label="u", variant="hist2")
    for f in ("O", "N_f", "N_c", "N_p"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("num_waves", "waves_per_tile", "lanes_active", "bytes_read",
              "source", "meta"):
        assert getattr(got, f) == getattr(want, f)
