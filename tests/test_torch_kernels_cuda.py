"""The port's CUDA kernels (K1-K4) against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every case here is marked ``cuda`` and
skips where there is no card.  The file imports neither ``jax`` nor the
reference package, so it runs on the machine with the card as it is:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Counts and degrees must be bit-equal; K4's f32 sums are held at rtol/atol
1e-5 to the plain version's f64 sums, because shared-memory float atomics
add in a different order on every run.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.core import counters
from repro_torch.data.images import make_image
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.histogram import ops


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
