"""The stages of a hybrid prefill (Mamba-2 and attention mixers, each
followed by an MoE with a shared expert) in a traced slice of the run's
own: each stage's device time, the device's idle time while the host is
in it, the MoE's routed and kept rows and the SSD's chunks.

The program names its stages with ``telemetry.span``: ``ssm`` (the
Mamba-2 mixer) with ``ssm.scan`` (its SSD) inside it, ``attention``, the
MoE's ``moe.*`` and ``moe.shared`` (``STAGES``); its counters
``repro_moe_rows_total`` and ``repro_ssm_chunks_total`` count meanwhile.
A program without them (an older commit) gives every reader here
nothing to read, and the harness leaves those metrics out of the line.

The slice is ``traffic["trace_units"]`` units, profiled once a run, the
first time a reader asks, and kept on the run.  A prefill has no
backward, so the first rule of ``stages.py`` is the only one: a device
operation belongs to the runtime call that launched it, and that call to
the nearest of its enclosing host ranges that is a stage (the innermost:
the SSD's operations to ``ssm.scan``, not ``ssm``), or else to "other".
Each stage's device time is the union of its operations' intervals;
each idle gap of the device goes to the stage of the innermost host
event open at its midpoint.  Off the card the host's aten operations
stand in for the device's; such numbers are never a device's.
"""

from __future__ import annotations

from typing import Optional

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.harness import log
from perfbench.profiling import NAME, _merge
from perfbench.stages import _open_at

STAGES = ("ssm", "ssm.scan", "attention", "moe.route", "moe.dispatch",
          "moe.experts", "moe.combine", "moe.shared")
SSM = ("ssm", "ssm.scan")
MOE = tuple(s for s in STAGES if s.startswith("moe."))
OTHER = "other"
WINDOW = "perfbench.stages_hybrid"
ROWS = "repro_moe_rows_total"
TOP = 4             # a stage's operations logged, by device time


def split(run) -> dict:
    """The run's per-stage split (``attribute``'s, plus ``units``,
    ``rows`` and ``chunks``), measured the first time it is asked for."""
    cached = getattr(run, "hybrid_split", None)
    if cached is None:
        cached = run.hybrid_split = measure(run)
    return cached


def _counts() -> dict:
    """The counters' totals so far, each None where the program has no
    such counter (the SSD's is ``mamba2.CHUNKS``, in a registry of its
    own)."""
    from repro_torch.models import mamba2
    from repro_torch.obs import telemetry
    rows = telemetry.REGISTRY._metrics.get(ROWS)
    chunks = getattr(mamba2, "CHUNKS", None)
    return {"rows": None if rows is None else
            (rows.value(outcome="routed"), rows.value(outcome="kept")),
            "chunks": None if chunks is None else chunks.value()}


def measure(run) -> dict:
    """Profile the run's own slice and split it by stage (stderr says
    how)."""
    on_device = run.device.type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
    units = run.traffic["trace_units"]
    run.sync()
    before = _counts()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(units):
                run.driver.unit()
            run.sync()
    after = _counts()
    out = attribute(prof.events(), on_device)
    out["units"] = units
    b, a = before["rows"], after["rows"]
    out["rows"] = None if b is None or a is None else {
        "routed": a[0] - b[0], "kept": a[1] - b[1]}
    b, a = before["chunks"], after["chunks"]
    out["chunks"] = None if b is None or a is None else a - b
    _log(out)
    return out


def _log(out: dict) -> None:
    n = out["units"]
    for name in (*STAGES, OTHER):
        if name in out["seen"] or name == OTHER:
            log(f"stage {name}: device {out['device_us'][name] / 1e3 / n:.4f}"
                f" ms a unit, idle {out['idle_us'][name] / 1e3 / n:.4f} ms "
                f"a unit")
            top = sorted(out["kernels"][name].items(), key=lambda kv: -kv[1])
            for kernel, us in top[:TOP]:
                log(f"  {us / 1e3 / n:.4f} ms a unit: {kernel[:NAME]}")
    log(f"stages: busy {out['busy_us'] / 1e3 / n:.4f} ms, slice "
        f"{out['window_us'] / 1e3 / n:.4f} ms a unit over {n}; rows "
        f"{out['rows']}, chunks {out['chunks']}")


def _stage(event, memo: dict) -> str:
    """The nearest enclosing stage range of a host event, or "other"."""
    got = memo.get(id(event))
    if got is None:
        walk = event
        while walk is not None and walk.name not in STAGES:
            walk = walk.cpu_parent
        got = memo[id(event)] = OTHER if walk is None else walk.name
    return got


def attribute(events, on_device: bool = True) -> dict:
    """``device_us``, ``idle_us``, ``kernels`` (device us by operation
    name) and ``by_stage`` (the operations' intervals) by stage and
    "other", the stages ``seen`` as host ranges, and the slice's
    ``busy_us`` and ``window_us``, of a profile's events."""
    zero = {name: 0.0 for name in (*STAGES, OTHER)}
    windows = [e for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU]
    out = {"seen": set(), "device_us": zero, "idle_us": dict(zero),
           "kernels": {name: {} for name in zero},
           "by_stage": {name: [] for name in zero}, "busy_us": 0.0,
           "window_us": 0.0}
    if not windows:
        return out
    w0 = min(e.time_range.start for e in windows)
    w1 = max(e.time_range.end for e in windows)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.is_async and e.name != WINDOW]
    out["seen"] = {e.name for e in host if e.name in STAGES}
    memo: dict = {}
    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    annotations.add(WINDOW)
    if on_device:
        launches = {e.id: e for e in host if e.name.startswith("cu")}
        ops = [(e, launches.get(e.id)) for e in events
               if e.device_type == DeviceType.CUDA
               and e.name not in annotations]
    else:
        ops = [(e, e) for e in host if e.name.startswith("aten::")]

    by_stage = out["by_stage"]
    every = []
    for op, cpu in ops:
        s, t = max(op.time_range.start, w0), min(op.time_range.end, w1)
        if t > s:
            name = OTHER if cpu is None else _stage(cpu, memo)
            by_stage[name].append((s, t))
            kernels = out["kernels"][name]
            kernels[op.name] = kernels.get(op.name, 0.0) + t - s
            every.append((s, t))
    out["device_us"] = {name: float(sum(t - s for s, t in _merge(iv)))
                        for name, iv in by_stage.items()}
    busy = _merge(every)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    for s, t in gaps:
        owner = _open_at(host, starts, (s + t) / 2)
        out["idle_us"][OTHER if owner is None else _stage(owner, memo)] += \
            t - s
    out["busy_us"] = float(sum(t - s for s, t in busy))
    out["window_us"] = w1 - w0
    return out


# -- what the readers call ----------------------------------------------

KIND = "hybrid_prefill"


def _split(run) -> Optional[dict]:
    return split(run) if run.kind == KIND else None


def union_ms(run, names) -> Optional[float]:
    """Device ms a unit of the union of the stages ``names``, or None
    where the program has none of them."""
    got = _split(run)
    if got is None or not set(names) & got["seen"]:
        return None
    iv = [x for name in names for x in got["by_stage"][name]]
    return sum(t - s for s, t in _merge(iv)) / 1e3 / got["units"]


def idle_ms(run, names) -> Optional[float]:
    """The device's idle ms a unit while the host is in one of the
    stages ``names``."""
    got = _split(run)
    if got is None or not set(names) & got["seen"]:
        return None
    return sum(got["idle_us"][s] for s in names) / 1e3 / got["units"]


def scan_us_per_chunk(run) -> Optional[float]:
    """``ssm.scan``'s device us over the chunks the SSD processed in the
    same slice."""
    got = _split(run)
    if got is None or "ssm.scan" not in got["seen"] or not got["chunks"]:
        return None
    return got["device_us"]["ssm.scan"] / got["chunks"]


def drop_percent(run) -> Optional[float]:
    """100 x (1 - kept / routed) of the MoE's rows over the slice."""
    got = _split(run)
    rows = None if got is None else got["rows"]
    if rows is None or rows["routed"] <= 0:
        return None
    return 100.0 * (1.0 - rows["kept"] / rows["routed"])
