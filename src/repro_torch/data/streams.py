"""Designed commit-group streams that stress the degree (K1) and the
instrumented kernels (K3, K6).

Each stream is a flat int32 index stream of whole 1024-id waves (32
commit groups of 32 ids).  Together they cover what the warp-level
degree must get exactly right: groups of one value and of 32 distinct
ones, two alternating values, 31 distinct values and one duplicate, a
16 + 16 split, ``-1`` strays in pairs, a partial wave padded with unique
out-of-range sentinels (as ``scatter_add.ops.committed_id_stream`` pads),
int32 extremes (where a signed and an unsigned order differ, and where a
histogram's flat index wraps), a run of every length 1 ... 32, Tool 1's
designed patterns at e = 1 ... 32, and a skewed stream (``skewed_ids``:
a few hot ids, a long tail, as a router's expert choice or a token
distribution gives).  ``stream_image`` lays a stream
out as an (N, C) image whose step-major committed stream (K3's, ``hist``)
has the same groups.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.microbench import make_pattern

LANES, GROUP = 1024, 32
SEGMENTS = 4096          # the id range the streams mostly fall in
PATTERN_E = (1, 2, 4, 8, 16, 32)
SKEW = 1.3               # the exponent of skewed_ids' 1/k law
SKEWED_WAVES = 4


def skewed_ids(n: int, segments: int = SEGMENTS, seed: int = 0) -> np.ndarray:
    """``n`` int32 ids in [0, segments) drawn from P(id = k - 1) ~ 1/k^SKEW,
    by inverse CDF from ``rng.random`` (numpy's zipf draws differ between
    installations; these do not): id 0 about a quarter of the draws at 4096
    segments, then a long tail."""
    cdf = np.cumsum(np.arange(1, segments + 1, dtype=np.float64) ** -SKEW)
    u = np.random.default_rng(seed).random(n) * cdf[-1]
    return np.minimum(np.searchsorted(cdf, u, side="right"),
                      segments - 1).astype(np.int32)


def _groups(rows) -> np.ndarray:
    return np.asarray(rows, dtype=np.int64).astype(np.int32).reshape(-1)


def adversarial_streams(seed: int = 0) -> dict[str, np.ndarray]:
    """Name -> stream, each a whole number of 1024-id waves."""
    rng = np.random.default_rng(seed)
    g = np.arange(LANES // GROUP)[:, None]           # one wave's groups
    lane = np.arange(GROUP)[None, :]
    distinct = (g * GROUP + lane) % SEGMENTS
    out = {
        "all equal": np.full(LANES, 7, np.int32),
        "all distinct": _groups(distinct + 64),
        "two alternating": _groups(np.where(lane % 2, g, g + 100)),
    }
    dup = distinct.copy()
    at = rng.integers(0, GROUP, g.shape[0])
    dup[np.arange(g.shape[0]), at] = dup[np.arange(g.shape[0]), (at + 1) % GROUP]
    out["31 distinct + one duplicate"] = _groups(dup)
    split = np.where(rng.permuted(np.repeat([[0, 1]], GROUP // 2, axis=1)
                                  .repeat(g.shape[0], axis=0), axis=1),
                     g * 2 + 1, g * 2)
    out["16 + 16 split"] = _groups(split)
    strays = distinct.copy()
    for i in range(g.shape[0]):                      # 0, 2, ..., 30 strays
        strays[i, rng.permutation(GROUP)[:2 * (i % 16)]] = -1
    out["-1 strays in pairs"] = _groups(strays)
    real = rng.integers(0, 64, 1500)
    sentinels = SEGMENTS + np.arange(2 * LANES - real.size)
    out["sentinel-padded partial wave"] = _groups(np.concatenate([real,
                                                                  sentinels]))
    extremes = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 2 ** 31 - 1],
                        np.int64)
    out["int32 extremes"] = _groups(extremes[rng.integers(0, 5, LANES)])
    runs = distinct + 64
    for i in range(g.shape[0]):                      # a run of length i + 1
        runs[i, rng.permutation(GROUP)[:i + 1]] = 3
    out["a run of every length"] = _groups(runs)
    for e in PATTERN_E:
        out[f"make_pattern e={e}"] = make_pattern(2, e, SEGMENTS,
                                                  seed=seed + e).reshape(-1)
    out[f"skewed 1/k^{SKEW}"] = skewed_ids(SKEWED_WAVES * LANES, seed=seed)
    return out


def stream_image(stream: np.ndarray, channels: int) -> np.ndarray:
    """An (N, C) int32 image whose ``hist`` committed stream holds the
    stream's commit groups, in order: pixel group p's channel s is group
    p * C + s.  The stream is cut to a whole number of C groups."""
    groups = stream.size // (GROUP * channels)
    a = stream[:groups * GROUP * channels].reshape(groups, channels, GROUP)
    return np.ascontiguousarray(a.transpose(0, 2, 1).reshape(-1, channels))
