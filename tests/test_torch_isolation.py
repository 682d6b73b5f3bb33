"""The port stands apart from the reference and from the CPU.

``repro_torch``, its examples (``examples/torch_*.py``) and
``chip_smoke.py`` import neither ``jax`` nor ``repro``: a module
compared with itself proves nothing.  And the kernel wrappers never pick
the CPU by themselves: without a card, the default device raises, and
the command line refuses a command that needs the kernels.
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
    return (sorted(PORT.rglob("*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py"])


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
    assert len([f for f in files if f.parent.name == "examples"]) == 9
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert bad == {}


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.analysis, "
            "repro_torch.kernels.histogram.ops, repro_torch.convert, "
            "repro_torch.kernels.scatter_add.ops, "
            "repro_torch.analysis.sweep_cache, repro_torch.obs.telemetry, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.models.transformer, repro_torch.models.moe, "
            "repro_torch.models.whisper, repro_torch.models.registry, "
            "repro_torch.models.rwkv6, repro_torch.models.mamba2, "
            "repro_torch.serve.step, "
            "repro_torch.launch.serve, repro_torch.cli.main, "
            "repro_torch.advisor, repro_torch.obs.heatmap, "
            "repro_torch.analysis.resilience, repro_torch.service, "
            "repro_torch.analysis.providers.fault, repro_torch.core.hlo, "
            "repro_torch.analysis.providers.hlo, repro_torch.audit, "
            "repro_torch.lint.rules, repro_torch.launch.train, "
            "repro_torch.train.step, repro_torch.optim.adamw, "
            "repro_torch.checkpoint.store, repro_torch.data.pipeline, "
            "repro_torch.runtime.fault_tolerance, "
            "repro_torch.runtime.stragglers, repro_torch.launch.capture, "
            "repro_torch.launch.lowering, repro_torch.launch.dryrun, "
            "repro_torch.audit.zoo, repro_torch.core.roofline, "
            "repro_torch.models.loops, repro_torch.lint, "
            "repro_torch.lint.symbolic, repro_torch.lint.tracing, "
            "repro_torch.lint.analysis, repro_torch.lint.registry\n"
            "from repro_torch.lint import analysis, registry\n"
            "models = [analysis.analyze_target(registry.build_target(n)) "
            "for n in registry.names()]\n"
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
    from repro_torch.kernels.scatter_add import kernel as sk
    from repro_torch.kernels.scatter_add import ops as scatter_ops

    img = np.full((256, 4), 3, np.int32)
    ids = np.zeros(2048, np.int32)
    before = dict(hk.LAUNCHES), dict(sk.LAUNCHES)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.histogram(img)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.histogram_instrumented(img)
    with pytest.raises((RuntimeError, AssertionError)):
        Session("v5e", table=microbench.build_table()).collect(
            WorkloadSpec.from_histogram(img, label="x"), provider="kernel")
    with pytest.raises((RuntimeError, AssertionError)):
        scatter_ops.scatter_add(np.ones((2048, 2), np.float32), ids,
                                num_segments=16)
    with pytest.raises((RuntimeError, AssertionError)):
        scatter_ops.bincount(ids, num_segments=16)
    with pytest.raises((RuntimeError, AssertionError)):
        microbench.build_table(mode="kernel", kernel_validation_points=1)
    with pytest.raises((RuntimeError, AssertionError)):
        Session("v5e", table=microbench.build_table()).collect(
            WorkloadSpec.from_indices(ids, 16, label="i"), provider="kernel")
    assert (hk.LAUNCHES, sk.LAUNCHES) == before


def test_serving_path_default_device_raises_without_a_card():
    """The LM path too: K8's wrapper, the serving CLI without ``--device
    cpu`` and a model built on the default device all refuse to run on
    the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model, make_batch

    cfg = get_config("qwen2-72b").reduced()
    q = np.zeros((2, 128, 32), np.float32)
    before = dict(fk.LAUNCHES)
    with pytest.raises((RuntimeError, AssertionError)):
        flash_ops.flash_attention(q, q, q)
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main(["--arch", "qwen2-72b", "--reduced", "--gen", "2"])
    model = build_model(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        model.init(torch.Generator(device=model.device))
    with pytest.raises((RuntimeError, AssertionError)):
        make_batch(cfg, 2, 8)
    assert fk.LAUNCHES == before


# the commands that launch the instrumented kernels, each without
# --torch-device cpu
KERNEL_COMMANDS = [
    ["validate", "--workload", "histogram", "--pixels", "2^12"],
    ["validate", "--size", "2^12", "--torch-device", "cuda:0",
     "--providers", "trace", "kernel"],
    ["profile", "--workload", "histogram", "--pixels", "2^12",
     "--provider", "kernel"],
    ["sweep", "--size", "2^12", "--waves-per-tile", "4", "8",
     "--provider", "kernel", "--no-artifact", "--no-cache"],
    ["compare", "--pixels", "2^10", "--provider", "kernel",
     "--no-artifact", "--no-cache"],
    ["advise", "--workload", "histogram", "--pixels", "2^12",
     "--validate-top", "1", "--no-artifact", "--no-cache"],
]


@pytest.mark.parametrize("argv", KERNEL_COMMANDS,
                         ids=[a[0] + str(i) for i, a in
                              enumerate(KERNEL_COMMANDS)])
def test_cli_without_a_card_refuses_kernel_commands(argv, monkeypatch,
                                                    capsys):
    """No fallback: without a card and without ``--torch-device cpu`` a
    command that needs the kernels exits 2 before any work, and neither
    a kernel nor its plain version nor the trace synthesis runs."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    from repro_torch.analysis.providers import kernel as kernel_prov
    from repro_torch.analysis.providers import trace as trace_prov
    from repro_torch.cli.main import main
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.scatter_add import kernel as sk

    calls = []
    for cls in (kernel_prov.InstrumentedKernelProvider,
                trace_prov.TraceProvider):
        for name in ("collect", "collect_batch"):
            monkeypatch.setattr(cls, name,
                                lambda *a, **kw: calls.append(a))
    for mod in (hk, sk):
        for name in dir(mod):
            if name.startswith("_plain") or name.endswith("_plain"):
                monkeypatch.setattr(mod, name,
                                    lambda *a, **kw: calls.append(a))
    before = dict(hk.LAUNCHES), dict(sk.LAUNCHES)
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--torch-device cpu" in err
    assert calls == []
    assert (hk.LAUNCHES, sk.LAUNCHES) == before


def test_advise_validation_defaults_to_the_card(tmp_path):
    """``Session.advise``'s default kernel provider is the registered
    ``"kernel"``, which launches on the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    from repro_torch.analysis import Session, WorkloadSpec
    from repro_torch.core import microbench
    from repro_torch.kernels.histogram import kernel as hk

    img = np.full((4096, 4), 3, np.int32)
    spec = WorkloadSpec.from_histogram(img, label="x", waves_per_tile=8)
    sess = Session("v5e", table=microbench.build_table())
    before = dict(hk.LAUNCHES)
    with pytest.raises((RuntimeError, AssertionError)):
        sess.advise(spec, depth=1, validate_top=1)
    assert hk.LAUNCHES == before
