"""The port stands apart from the reference and from the CPU.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
``repro``: a module compared with itself proves nothing.  And the
kernel wrappers never pick the CPU by themselves: without a card, the
default device raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert bad == {}


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.analysis, "
            "repro_torch.kernels.histogram.ops, repro_torch.convert\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_a_card():
    """No fallback: on a box with no CUDA the default path fails instead
    of running the plain version on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    from repro_torch.analysis import Session, WorkloadSpec
    from repro_torch.core import microbench
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram import ops

    img = np.full((256, 4), 3, np.int32)
    before = dict(hk.LAUNCHES)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.histogram(img)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.histogram_instrumented(img)
    with pytest.raises((RuntimeError, AssertionError)):
        Session("v5e", table=microbench.build_table()).collect(
            WorkloadSpec.from_histogram(img, label="x"), provider="kernel")
    assert hk.LAUNCHES == before
