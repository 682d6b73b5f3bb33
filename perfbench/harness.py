"""One run of one cell: set-up, the measured window, the traced slice,
the per-layer readers, the check against the plain reference, and the
result line.

Everything that belongs to one cell is found by name:
``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
``configs/<config>.json`` holds the model as it is run (its ``port``
section: the program's ``ModelConfig`` fields), ``traffic/<traffic>.json``
the mix (its ``kind`` picks the loop in ``kinds/<kind>.py``),
``limits/<cell>.json`` the limit of each number the check compares, and
``metrics/<metric>.py`` each per-layer metric's reader.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from perfbench import counts, profiling

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that may not be loaded when the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Hook:
    """What a test changes in a run, where run.py's arguments cannot:
    the device (no look for a card) and the cell's sizes (``adjust(arch,
    traffic)`` edits the configuration's ``port`` section and the traffic
    in place)."""
    device: str = "cpu"
    adjust: Optional[Callable[[dict, dict], None]] = None


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file
    arch: dict              # its ``port`` section, as run
    traffic: dict
    limits: dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name=name, config=config, arch=dict(config["port"]),
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, chips=w["chips"])


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the loops and the readers share: the cell, the device, the
    seed, the window's units and their time, and the traced slice."""

    def __init__(self, cell: Cell, device: torch.device, seed: int,
                 seconds: float, trace: bool):
        self.cell, self.device, self.seed = cell, device, seed
        self.seconds, self.trace = seconds, trace
        self.arch, self.traffic = cell.arch, cell.traffic
        self.kind = cell.traffic["kind"]
        self.units: list = []
        self.elapsed = 0.0
        self.profile: dict = {}
        self.driver: Any = None
        self.peak = None
        self.power_limit = "not read"

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peaks(self) -> Optional[dict]:
        """The device's published peaks, or None off the card."""
        if self.device.type != "cuda":
            return None
        try:
            return counts.peaks(torch.cuda.get_device_name(self.device))
        except KeyError:
            return None

    def time_call(self, fn, budget_s: float = 1.0) -> float:
        """Seconds per call of ``fn``: one warm call, then as many as fit
        ``budget_s`` (at least 3), timed by CUDA events on the card and
        by the host clock elsewhere."""
        t0 = time.perf_counter()
        fn()
        self.sync()
        reps = max(3, int(budget_s / max(time.perf_counter() - t0, 1e-6)))
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps


def _device(hook: Optional[Hook], chips: int) -> torch.device:
    if hook is not None:
        return torch.device(hook.device)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def _power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def _loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def start(workload: str, seed: int, seconds: float, trace: bool,
          hook: Optional[Hook] = None) -> Run:
    """The cell's run with its driver set up and warm."""
    cell = load_cell(workload)
    dev = _device(hook, cell.chips)
    if hook is not None and hook.adjust is not None:
        hook.adjust(cell.arch, cell.traffic)
    run = Run(cell, dev, seed, seconds, trace)
    kind = importlib.import_module(f"perfbench.kinds.{run.kind}")
    run.driver = kind.Driver(run)
    run.driver.setup()
    run.sync()
    return run


def window(run: Run) -> None:
    """The measured window: whole units, from a boundary to the first
    boundary after ``run.seconds``; then what the check needs."""
    start = time.perf_counter()
    while True:
        run.units.append(run.driver.unit())
        if time.perf_counter() - start >= run.seconds:
            break
    run.elapsed = time.perf_counter() - start
    run.driver.after_window()


def main(argv=None, *, t0: Optional[float] = None,
         hook: Optional[Hook] = None) -> dict:
    """Run the cell; print and return the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    run = start(args.workload, args.seed, args.seconds, bool(args.trace),
                hook)
    cell, dev, driver = run.cell, run.device, run.driver
    setup_s = time.perf_counter() - t0
    window(run)
    if dev.type == "cuda":
        run.power_limit = _power_limit()

    if run.trace:
        with profiling.traced(dev) as prof:
            for _ in range(cell.traffic["trace_units"]):
                driver.unit()
        run.profile = prof
        if not prof.get("busy_s"):
            raise SystemExit("the traced slice shows no device operation")
    if dev.type == "cuda":
        run.peak = torch.cuda.max_memory_allocated(dev)

    metrics: dict = {}
    if run.trace:
        for entry in cell.per_layer:
            value = load_reader(entry["name"])(run)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value),
                                          "unit": entry["unit"]}
    else:
        values = dict(driver.end_to_end(), setup_s=setup_s)
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": float(values[entry["name"]]),
                                      "unit": entry["unit"]}

    found = _loaded_forbidden()
    if found:
        raise SystemExit(f"loaded in this process: {', '.join(found)}")

    numbers = driver.check()       # the limits file names those compared
    checks = {name: {"value": float(numbers.get(name, math.nan)),
                     "limit": lim["limit"]}
              for name, lim in cell.limits["numbers"].items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    device: dict = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                    "kind": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                    "count": cell.chips,
                    "memory_peak_bytes": int(run.peak or 0),
                    "power_limit": run.power_limit}
    if run.trace:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
    result = {"correct": correct, "attempted": len(run.units), "failed": 0,
              "metrics": metrics, "device": device}
    if run.trace:
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return result
