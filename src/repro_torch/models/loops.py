"""Loop markers: where a Python loop of the port stands for a scan of the
reference (the layer groups, the encoder and decoder blocks, the
microbatches).

Each iteration of such a loop runs inside ``iteration(name, index,
trips)``; ``current()`` is the stack of the iterations under way, the
outermost first.  A captured step (``launch/capture.py``) reads it for
each operation it records: the depth of a site is the number of loops
around it, and its trip count the product of their trips, as the
reference's scanner reads them off nested ``while`` loops.  A loop that
runs ``repeat(name, n)`` runs its first iteration only while
``first_only()`` is on, and still reports ``n`` trips: a capture takes
one microbatch of a step.  Outside a capture the markers cost a list
append and pop.
"""

from __future__ import annotations

import contextlib

_frames: list[tuple[str, int, int]] = []
_first_only = [False]


class iteration:
    """Iteration ``index`` of the loop ``name`` of ``trips`` iterations."""

    __slots__ = ("frame",)

    def __init__(self, name: str, index: int, trips: int):
        self.frame = (name, index, trips)

    def __enter__(self):
        _frames.append(self.frame)

    def __exit__(self, *exc):
        _frames.pop()


def current() -> tuple[tuple[str, int, int], ...]:
    """The loops under way, outermost first: (name, index, trips)."""
    return tuple(_frames)


def repeat(name: str, n: int):
    """``range(n)``, each index inside ``iteration(name, i, n)``; only
    index 0 while ``first_only()`` is on."""
    for i in range(min(n, 1) if _first_only[0] else n):
        with iteration(name, i, n):
            yield i


@contextlib.contextmanager
def first_only():
    """Within it, ``repeat`` loops run their first iteration only."""
    prev = _first_only[0]
    _first_only[0] = True
    try:
        yield
    finally:
        _first_only[0] = prev
