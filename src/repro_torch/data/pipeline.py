"""Deterministic synthetic data pipeline, sharded and restart-exact: a
copy of the reference's numpy-only module, so that the tokens are bit for
bit the reference's (numpy's Philox keyed by the seed, counted by the
absolute sample index).

Every (step, shard) pair maps to tokens via a counter-based Philox stream,
so (a) each data shard generates only its slice (no host broadcast),
(b) restarting from a checkpoint at step ``s`` reproduces the *identical*
remaining stream — the property fault-tolerant training needs and the
tests assert, and (c) elastic rescaling re-partitions the same global
stream (global sample index = step * global_batch + position).

Tokens follow a Zipfian marginal (alpha ~1) so the embedding-gradient
scatter sees realistic frequency skew — the data-dependent contention the
paper's model prices (a monochrome "image" = constant stream; a uniform
stream = balanced histogram).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1     # 0 = uniform


class SyntheticLM:
    """Infinite deterministic token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.zipf_alpha > 0:
            ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
            probs = ranks ** -cfg.zipf_alpha
            self._cdf = np.cumsum(probs / probs.sum())
        else:
            self._cdf = None

    def _tokens_for(self, sample_index: np.ndarray) -> np.ndarray:
        """(n, seq_len) tokens for absolute sample indices."""
        n = sample_index.shape[0]
        out = np.empty((n, self.cfg.seq_len), np.int32)
        for row, s in enumerate(sample_index):
            rng = np.random.Generator(np.random.Philox(
                key=self.cfg.seed, counter=[0, 0, 0, int(s)]))
            u = rng.random(self.cfg.seq_len)
            if self._cdf is not None:
                out[row] = np.searchsorted(self._cdf, u).astype(np.int32)
            else:
                out[row] = (u * self.cfg.vocab_size).astype(np.int32)
        return np.clip(out, 0, self.cfg.vocab_size - 1)

    def global_batch_at(self, step: int) -> np.ndarray:
        base = step * self.cfg.global_batch
        idx = np.arange(base, base + self.cfg.global_batch)
        return self._tokens_for(idx)

    def shard_batch_at(self, step: int, shard: int, num_shards: int
                       ) -> np.ndarray:
        """This shard's rows of the step's global batch."""
        assert self.cfg.global_batch % num_shards == 0
        per = self.cfg.global_batch // num_shards
        base = step * self.cfg.global_batch + shard * per
        return self._tokens_for(np.arange(base, base + per))

    def batch_dict(self, step: int) -> dict:
        toks = self.global_batch_at(step)
        return {"tokens": toks, "labels": toks}
