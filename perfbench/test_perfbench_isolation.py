"""The benchmark stands apart: no module under ``perfbench/`` imports
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (compared by
whole top-level name, so ``repro_torch`` passes); the reference under
``perfbench/reference/`` imports nothing of the program either.  A run
that finds one of them loaded when its window closes prints no result,
and so does a run without a card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.cpu_cells import args

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NO_JAX = {"jax", "jaxlib", "flax", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _modules(sub=""):
    """The benchmark's modules, not what its runs leave in ``runs/``."""
    return sorted(p for p in (HERE / sub).rglob("*.py")
                  if "runs" not in p.relative_to(HERE).parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                              & NO_JAX)
             for p in _modules()}
    assert not {k: v for k, v in found.items() if v}
    # the check is by whole top-level name
    assert "repro_torch" not in NO_JAX


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        roots = set(_imported_roots(path))
        assert not roots & (NO_JAX | {"repro_torch"}), path
        assert roots <= {"__future__", "contextlib", "dataclasses", "math",
                         "torch"}, (path, roots)


def test_a_loaded_jax_module_stops_the_run(hook, monkeypatch, capsys):
    monkeypatch.setattr(harness, "FORBIDDEN_MODULES", tuple(NO_JAX))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        harness.main(args("qwen3moe-prefill-zipf-8k"), hook=hook)
    assert capsys.readouterr().out == ""


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "perfbench/run.py", *args("qwen3moe-prefill-zipf-8k")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    done = _run_py(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "no CUDA device" in done.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's paths: the
    run fails where it imports the program, and prints no result."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("runs", "__pycache__"))
    code = ("import sys; sys.path[:0] = ['.']; "
            "from perfbench import harness, cpu_cells; "
            "harness.main(cpu_cells.args('qwen3moe-prefill-zipf-8k'), "
            "hook=harness.Hook(adjust=cpu_cells.shrink))")
    env = dict(os.environ, PYTHONPATH="")
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == ""
    assert "repro_torch" in done.stderr
