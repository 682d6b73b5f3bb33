"""The harness takes data: a configuration, a traffic mix and a
per-layer metric, each written as a new file into a copy of the
benchmark, with their entries added to its ``BENCHMARK.json``, are found
by name and run, and no file that was there is edited
(``README.md`` says how)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench.cpu_cells import SMALL

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_run_from_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    before = _digests(tmp_path)
    pb = tmp_path / "perfbench"
    port = dict(SMALL, name="tiny-moe", family="moe", dtype="float32",
                tie_embeddings=False, moe_capacity_factor=2.0)
    (pb / "configs" / "tiny-moe.json").write_text(json.dumps({
        "source": "https://example.org/tiny-moe", "reduced": [],
        "port": port}))
    (pb / "traffic" / "tiny-train.json").write_text(json.dumps({
        "kind": "train", "batch": 2, "seq": 24, "zipf_s": 1.2,
        "check_steps": 3, "optimizer": {
            "lr": 0.001, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
            "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 2,
            "total_steps": 100, "min_lr_frac": 0.1},
        "decay_skip": ["final_norm"], "tiny_leaf": 0.001,
        "trace_units": 2}))
    train = json.loads((HERE / "limits" / "granite-train-zipf-8x2048.json")
                       .read_text())["numbers"]
    (pb / "limits" / "tiny-moe-train.json").write_text(json.dumps({
        "numbers": {name: {"limit": 1e-3} for name in train}}))
    (pb / "metrics" / "units_traced.train.py").write_text(
        "def read(run):\n"
        "    return len(run.units) if run.kind == 'train' else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe",
                             "source": "https://example.org/tiny-moe",
                             "file": "perfbench/configs/tiny-moe.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-moe-train", "config": "tiny-moe",
                               "traffic": "tiny-train", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("tiny-moe-train")
    bench["per_layer"].append({
        "name": "units_traced.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step",
        "moves": "train_tokens_per_s", "workloads": ["tiny-moe-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    lines = []
    for trace in (0, 1):
        code = ("import sys, torch; torch.set_num_threads(2); "
                f"sys.path[:0] = ['.', {str(ROOT / 'src')!r}]; "
                "from perfbench import harness, cpu_cells; "
                "harness.main(cpu_cells.args('tiny-moe-train', "
                f"trace={trace}), hook=harness.Hook())")
        done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                              env=dict(os.environ, PYTHONPATH=""),
                              capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr[-3000:]
        lines.append(json.loads(done.stdout.strip().splitlines()[-1]))
    assert lines[0]["correct"] and lines[1]["correct"]
    assert set(lines[0]["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert lines[1]["metrics"]["units_traced.train"]["value"] >= 1
    assert "device_idle.train" not in lines[1]["metrics"]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
