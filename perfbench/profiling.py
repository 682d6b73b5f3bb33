"""The traced slice of a run: ``torch.profiler`` over a few units of
work, reduced to the device's busy time, its idle share, the operations
that took most device time and the longest idle gaps by what the host
was doing.

The busy time is the union of the intervals in which an operation
(kernel, copy, set) ran on the device, inside the slice's own range
(``perfbench.window``): operations on several streams that overlap count
once.
"""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "perfbench.window"
TOP = 10
NAME = 160          # a name's characters kept in the breakdown
GAPS_ATTRIBUTED = 4000


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the body; yields a dict that holds the summary on exit."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    out: dict = {}
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize()
    out.update(summarize(prof.events(), device.type == "cuda"))


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, on_device: bool = True) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` of a
    profile's events.  ``on_device=False`` (a CPU rehearsal) takes the
    host's aten operations as the device's, so that the arithmetic runs
    where there is no card; such numbers are never a device's."""
    windows = [e for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU]
    if not windows:
        return {}
    w0 = min(e.time_range.start for e in windows)
    w1 = max(e.time_range.end for e in windows)
    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    annotations.add(WINDOW)
    if on_device:
        ops = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in annotations]
    else:
        ops = [e for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::")]
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in ops]
    busy = _merge([s for s in spans if s[1] > s[0]])
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for e, (s, t) in zip(ops, spans):
        if t > s:
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    device_ops = [(n[:NAME], v) for n, v in device_ops]
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name != WINDOW), key=lambda x: x[0])
    starts = [h[0] for h in host]
    idle: dict = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:GAPS_ATTRIBUTED]:
        idle_name = _host_at(host, starts, (s + e) / 2)
        idle[idle_name] = idle.get(idle_name, 0.0) + (e - s) / 1e6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": [[n, v] for n, v in idle_gaps]}


def _host_at(host, starts, t, scan: int = 512) -> str:
    """The innermost host event running at ``t``: of those that started
    by ``t`` and had not ended, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host: between traced operations"
