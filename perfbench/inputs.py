"""Weights and traffic made on the device: the traffic from ``--seed``,
the weights from their configuration's name.

Every random stream is its own ``torch.Generator`` on the run's device,
seeded from the run's seed (or the configuration's name) and the
stream's name, so that one seed gives the same batches in every run and
a batch does not depend on how many came before it.  The weights are
one draw a configuration, the same for every seed: different draws route
the tokens differently, and so change the work of a step (a train
step's index backward grows with the rows its experts drop).
"""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed, *names) -> int:
    """A 63-bit seed for the stream ``names`` of ``seed`` (a run's seed,
    or a configuration's name)."""
    key = ":".join(str(x) for x in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *names))


# -- weights -----------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None


def fill_weights(layout, gen: torch.Generator, vocab_size: int):
    """Parameters of ``layout`` (a tree of meta tensors: the shapes and
    dtypes the program's model takes) drawn from ``gen`` on its device.

    One normal draw per dtype fills every matrix, which is then scaled
    by its fan-in, 1/sqrt(rows) (an embedding table: 1/sqrt(width)); a
    vector named ``b`` is zero and any other vector (a norm's scale) is
    one.  The table's rows past ``vocab_size`` (the padding of the
    vocabulary) and the head's columns past it are zero.
    """
    device = gen.device
    leaves = list(_leaves(layout))
    out = _copy_structure(layout)
    by_dtype: dict = {}
    for path, meta in leaves:
        if meta.dim() >= 2:
            by_dtype.setdefault(meta.dtype, []).append((path, meta))
        else:
            fill = 0.0 if path[-1] == "b" else 1.0
            _set(out, path, torch.full(meta.shape, fill, dtype=meta.dtype,
                                       device=device))
    for dtype, group in by_dtype.items():
        total = sum(m.numel() for _, m in group)
        flat = torch.empty(total, dtype=dtype, device=device)
        for part in flat.split(1 << 30):
            part.normal_(generator=gen)
        start = 0
        for path, meta in group:
            w = flat[start:start + meta.numel()].view(meta.shape)
            start += meta.numel()
            table = path[-1] == "table"
            w.mul_((meta.shape[-1] if table else meta.shape[-2]) ** -0.5)
            if table:
                w[vocab_size:] = 0
            elif path[0] == "lm_head":
                w[:, vocab_size:] = 0
            _set(out, path, w)
    return out


def leaf_paths(tree) -> list:
    """The paths of a parameter tree's leaves, in order, as dotted names."""
    return [".".join(str(k) for k in path) for path, _ in _leaves(tree)]


def leaves(tree) -> list:
    return [v for _, v in _leaves(tree)]


def unflatten(tree, values: list):
    """A tree of ``tree``'s structure holding ``values`` in leaf order."""
    out = _copy_structure(tree)
    for (path, _), v in zip(_leaves(tree), values):
        _set(out, path, v)
    return out


# -- tokens ------------------------------------------------------------------


class Zipf:
    """Token ids with P(id = r) proportional to (r + 1)^-s over the
    vocabulary, drawn by inverting the cumulative distribution."""

    def __init__(self, vocab: int, s: float, device):
        w = torch.arange(1, vocab + 1, dtype=torch.float64,
                         device=device) ** -s
        cdf = torch.cumsum(w, 0)
        self.cdf = (cdf / cdf[-1]).to(torch.float64)
        self.vocab = vocab

    def draw(self, shape, gen: torch.Generator) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=self.cdf.device)
        ids = torch.searchsorted(self.cdf, u)
        return ids.clamp_(max=self.vocab - 1).to(torch.int32)


class ShapeCycle:
    """Batch shapes that cycle through ``shapes``, each cycle in an order
    drawn from the seed, so that every seed runs the same mix:
    ``cycle[j]`` is batch j's shape."""

    def __init__(self, shapes: list, seed: int):
        self.shapes = [tuple(s) for s in shapes]
        self.gen = generator("cpu", seed, "shapes")
        self.order: list = []

    def __getitem__(self, j: int) -> tuple:
        while len(self.order) <= j:
            perm = torch.randperm(len(self.shapes), generator=self.gen)
            self.order.extend(self.shapes[i] for i in perm.tolist())
        return self.order[j]
