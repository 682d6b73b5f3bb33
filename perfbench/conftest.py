"""Fixtures of the benchmark's CPU tests: every cell at a reduced size
through the harness's own code, by ``harness.Hook`` (the device, the
sizes, the limits), never by a flag of ``run.py``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


from perfbench.cpu_cells import shrink  # noqa: E402

# what runs leave behind (caches, unpacked checkouts) holds no test of ours
collect_ignore = ["runs"]


@pytest.fixture
def torch_threads():
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def hook(torch_threads, monkeypatch):
    """A CPU run of a cell shrunk to ``SMALL`` in f32.  Other test files
    of the same process load ``jax`` and ``repro``; the check that a run
    loads neither is ``test_perfbench_isolation.py``'s, so these runs
    skip it."""
    from perfbench import harness
    monkeypatch.setattr(harness, "FORBIDDEN_MODULES", ())
    return harness.Hook(device="cpu", adjust=shrink)

