"""The stages of a latent-attention prefill (DeepSeek-V3: MLA in every
layer, a dense FFN in the leading layers, the MoE with a shared expert in
the rest) in a traced slice of the run's own: each stage's device time,
the device's idle time while the host is in it, and the MoE's rows.

The program names its stages with ``telemetry.span``: ``mla`` (the
mixer: its projections, norms and rotations) with ``mla.attend`` (the
attention core, K8) inside it, the MoE's ``moe.*`` and ``moe.shared``
(``STAGES``); the dense FFN of the leading layers, the embedding, the
norms and the head fall in "other".  Its counter ``repro_moe_rows_total``
counts meanwhile: "routed", the rows bound for the experts this card
holds, and "kept", those within capacity.  A program without them (an
older commit) gives every reader here nothing to read, and the harness
leaves those metrics out of the line.

The slice is ``traffic["trace_units"]`` units, profiled once a run, the
first time a reader asks, and kept on the run.  As in
``stages_hybrid.py``, a device operation belongs to the runtime call that
launched it, and that call to the nearest of its enclosing host ranges
that is a stage (K8 to ``mla.attend``, not ``mla``), or else to "other";
each stage's device time is the union of its operations' intervals, and
each idle gap of the device goes to the stage of the innermost host event
open at its midpoint.  Off the card the host's aten operations stand in
for the device's; such numbers are never a device's.
"""

from __future__ import annotations

from typing import Optional

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.harness import log
from perfbench.profiling import NAME, _merge
from perfbench.stages import _open_at

STAGES = ("mla", "mla.attend", "moe.route", "moe.dispatch", "moe.experts",
          "moe.combine", "moe.shared")
MLA = ("mla", "mla.attend")
MOE = tuple(s for s in STAGES if s.startswith("moe."))
OTHER = "other"
WINDOW = "perfbench.stages_mla"
ROWS = "repro_moe_rows_total"
KIND = "mla_prefill"
TOP = 4             # a stage's operations logged, by device time


def split(run) -> dict:
    """The run's per-stage split (``attribute``'s, plus ``units``,
    ``tokens`` and ``rows``), measured the first time it is asked for."""
    cached = getattr(run, "mla_split", None)
    if cached is None:
        cached = run.mla_split = measure(run)
    return cached


def _rows():
    """The rows counter's totals so far, or None where the program has
    no such counter."""
    from repro_torch.obs import telemetry
    rows = telemetry.REGISTRY._metrics.get(ROWS)
    return None if rows is None else (rows.value(outcome="routed"),
                                      rows.value(outcome="kept"))


def measure(run) -> dict:
    """Profile the run's own slice and split it by stage (stderr says
    how)."""
    on_device = run.device.type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
    units = run.traffic["trace_units"]
    run.sync()
    before = _rows()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            done = [run.driver.unit() for _ in range(units)]
            run.sync()
    after = _rows()
    out = attribute(prof.events(), on_device)
    out["units"] = units
    out["tokens"] = sum(u["tokens"] for u in done)
    out["rows"] = None if before is None or after is None else {
        "routed": after[0] - before[0], "kept": after[1] - before[1]}
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
        f"{out['window_us'] / 1e3 / n:.4f} ms a unit over {n}; "
        f"{out['tokens']} tokens, rows {out['rows']}")


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


def drop_percent(run) -> Optional[float]:
    """100 x (1 - kept / routed) of the held experts' rows over the
    slice."""
    got = _split(run)
    rows = None if got is None else got["rows"]
    if rows is None or rows["routed"] <= 0:
        return None
    return 100.0 * (1.0 - rows["kept"] / rows["routed"])


def held_percent(run) -> Optional[float]:
    """100 x the rows bound for the held experts over the slice's routed
    rows of every MoE layer, tokens x top_k x (layers - first_k_dense):
    8 / 256 = 3.125% where the router spreads its rows evenly."""
    got = _split(run)
    rows = None if got is None else got["rows"]
    if rows is None or not got["tokens"] or "moe.dispatch" not in got["seen"]:
        return None
    arch = run.arch
    total = got["tokens"] * arch["top_k"] * (arch["num_layers"]
                                             - arch["first_k_dense"])
    return 100.0 * rows["routed"] / total
