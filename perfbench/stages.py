"""The program's stages in a traced slice of the run's own: each stage's
device time, the device's idle time while the host is in it, and the
rows the MoE routed and kept.

The program names its stages with ``telemetry.span``, which opens a
profiler range of the stage's name while the profiler records
(``STAGES``); its MoE counts rows in ``repro_moe_rows_total`` meanwhile.
A program without them (an older commit) gives every reader here
nothing to read, and the harness leaves those metrics out of the line.

The slice is ``traffic["trace_units"]`` units, profiled once a run, the
first time a reader asks, and kept on the run: the harness's own slice
keeps only its summary.

A device operation belongs to the runtime call that launched it (the
host event of the same correlation id), and that call to a stage by the
nearest of its ancestors that is a stage range or an autograd backward
node (``autograd::engine::evaluate_function: ...``):

1. a stage range decides (the forward, and the recompute of a remat
   layer, whose operations run under a backward node but inside their
   own stage ranges);
2. a backward node decides by the forward operation that made it, found
   by its forward thread and sequence number: that operation's stage by
   rule 1 (the backward).  An operation with a sequence number of its
   own on the way up ran with grad on, so it is the recompute outside
   any stage, and is "other";
3. anything else is "other".

Each stage's device time is the union of its operations' intervals
inside the slice.  Each idle gap of the device (between the union of
all operations) goes to the innermost host event open at its midpoint,
on any thread, and so to that event's stage.  Off the card the host's
aten operations stand in for the device's, as in ``profiling.py``; such
numbers are never a device's.
"""

from __future__ import annotations

import bisect
from typing import Optional

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.harness import log
from perfbench.profiling import NAME, _merge

STAGES = ("attention", "moe.route", "moe.dispatch", "moe.experts",
          "moe.combine", "train.optimizer")
MOE = tuple(s for s in STAGES if s.startswith("moe."))
OTHER = "other"
WINDOW = "perfbench.stages"
EVALUATE = "autograd::engine::evaluate_function: "
ROWS = "repro_moe_rows_total"
SCAN = 512          # host events looked back over for an idle gap's owner
TOP = 4             # a stage's operations logged, by device time


def split(run) -> dict:
    """The run's per-stage split (``attribute``'s, plus ``units`` and
    ``rows``), measured the first time it is asked for."""
    cached = getattr(run, "stage_split", None)
    if cached is None:
        cached = run.stage_split = measure(run)
    return cached


def _rows() -> Optional[tuple]:
    """(routed, kept) so far, or None where the program has no counter."""
    from repro_torch.obs import telemetry
    counter = telemetry.REGISTRY._metrics.get(ROWS)
    if counter is None:
        return None
    return counter.value(outcome="routed"), counter.value(outcome="kept")


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
            for _ in range(units):
                run.driver.unit()
            run.sync()
    after = _rows()
    out = attribute(prof.events(), on_device)
    out["units"] = units
    out["rows"] = (None if before is None or after is None else
                   {"routed": after[0] - before[0],
                    "kept": after[1] - before[1]})
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
        f"{out['window_us'] / 1e3 / n:.4f} ms a unit over {n} (of it "
        f"{out['unlinked_us'] / 1e3 / n:.4f} ms with no host launch); rows "
        f"{out['rows']}")


def attribute(events, on_device: bool = True) -> dict:
    """``device_us``, ``idle_us`` and ``kernels`` (device us by
    operation name) by stage and "other", the stages ``seen`` as host
    ranges, and the slice's ``busy_us``, ``window_us`` and
    ``unlinked_us`` (device operations with no host launch, "other"),
    of a profile's events."""
    zero = {name: 0.0 for name in (*STAGES, OTHER)}
    windows = [e for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU]
    if not windows:
        return {"seen": set(), "device_us": zero, "idle_us": dict(zero),
                "kernels": {name: {} for name in zero}, "unlinked_us": 0.0,
                "busy_us": 0.0, "window_us": 0.0}
    w0 = min(e.time_range.start for e in windows)
    w1 = max(e.time_range.end for e in windows)
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.is_async and e.name != WINDOW]
    seen = {e.name for e in host if e.name in STAGES}
    stage = _Stages(host)

    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    annotations.add(WINDOW)
    if on_device:
        # the runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...) that
        # shares the operation's correlation id; it lies inside the host
        # operation that made it
        launches = {e.id: e for e in host if e.name.startswith("cu")}
        ops = [(e, launches.get(e.id)) for e in events
               if e.device_type == DeviceType.CUDA
               and e.name not in annotations]
    else:
        ops = [(e, e) for e in host if e.name.startswith("aten::")]

    by_stage: dict = {name: [] for name in zero}
    kernels: dict = {name: {} for name in zero}
    every = []
    unlinked = 0.0      # device time of operations with no host launch
    for op, cpu in ops:
        s, t = max(op.time_range.start, w0), min(op.time_range.end, w1)
        if t > s:
            name = OTHER if cpu is None else stage(cpu)
            by_stage[name].append((s, t))
            kernels[name][op.name] = kernels[name].get(op.name, 0.0) + t - s
            every.append((s, t))
            if cpu is None:
                unlinked += t - s
    device_us = {name: float(sum(t - s for s, t in _merge(iv)))
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
    idle_us = dict(zero)
    for s, t in gaps:
        owner = _open_at(host, starts, (s + t) / 2)
        idle_us[OTHER if owner is None else stage(owner)] += t - s
    return {"seen": seen, "device_us": device_us, "idle_us": idle_us,
            "kernels": kernels, "unlinked_us": unlinked,
            "busy_us": float(sum(t - s for s, t in busy)),
            "window_us": w1 - w0}


class _Stages:
    """The stage of a host event by the module's rules, memoised."""

    def __init__(self, host):
        self.memo: dict = {}
        # the forward operation that made each autograd node: of the
        # events that carry its (thread, sequence number), the last to
        # start (the ones before it read the number and made no node);
        # a node's own range, just under its backward node, carries the
        # number too and is left out
        self.forward: dict = {}
        for e in host:
            if e.sequence_nr < 0 or e.name.startswith(EVALUATE) or (
                    e.cpu_parent is not None
                    and e.cpu_parent.name.startswith(EVALUATE)):
                continue
            key = (e.thread, e.sequence_nr)
            f = self.forward.get(key)
            if f is None or e.time_range.start > f.time_range.start:
                self.forward[key] = e

    def __call__(self, event) -> str:
        got = self.memo.get(id(event))
        if got is None:
            got = self.memo[id(event)] = self._find(event)
        return got

    def _find(self, event, backward: bool = True) -> str:
        """Rules 1 to 3; ``backward=False``: rule 1 alone."""
        # whether an event below the one looked at ran with grad on (the
        # node's own range, just under its backward node, is left out)
        grad_on = last = False
        walk = event
        while walk is not None:
            if walk.name in STAGES:
                return walk.name
            if walk.name.startswith(EVALUATE):
                if grad_on or not backward:
                    return OTHER
                made = self.forward.get((walk.fwd_thread, walk.sequence_nr))
                return OTHER if made is None else self._find(made, False)
            grad_on, last = grad_on or last, walk.sequence_nr >= 0
            walk = walk.cpu_parent
        return OTHER


def _open_at(host, starts, t):
    """The innermost host event open at ``t``: of those that started by
    ``t`` and had not ended, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - SCAN), -1):
        if host[j].time_range.end >= t:
            return host[j]
    return None


# -- what the readers call ----------------------------------------------


def stage_ms(run, kind: str, name: str):
    """Device ms a unit of the stage ``name`` (forward, recompute and
    backward), or None where the program has no such stage."""
    if run.kind != kind:
        return None
    got = split(run)
    if name not in got["seen"]:
        return None
    return got["device_us"][name] / 1e3 / got["units"]


def moe_idle_ms(run, kind: str):
    """The device's idle ms a unit while the host is in a MoE stage."""
    if run.kind != kind:
        return None
    got = split(run)
    if not set(MOE) & got["seen"]:
        return None
    return sum(got["idle_us"][s] for s in MOE) / 1e3 / got["units"]


def drop_percent(run, kind: str):
    """100 x (1 - kept / routed) of the MoE's rows over the slice."""
    if run.kind != kind:
        return None
    rows = split(run)["rows"]
    if rows is None or rows["routed"] <= 0:
        return None
    return 100.0 * (1.0 - rows["kept"] / rows["routed"])
