"""Fault-tolerant step loop: heartbeats, failure detection, checkpoint-
restart, and elastic rescale planning.

A copy of the reference's numpy-only module (the port imports nothing of
``repro``).  Single-process simulation of the multi-host control plane
(one process drives every host): hosts are modeled objects that beat
every step; the coordinator detects missed beats / injected failures and
drives the same recovery path a real deployment would —
restore-from-latest + data-stream resume (exact, thanks to the
counter-based pipeline) + optional remesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float = 0.0
    alive: bool = True
    step_times: list = dataclasses.field(default_factory=list)


class Coordinator:
    """Heartbeat registry + failure detector + restart counter."""

    def __init__(self, num_hosts: int, timeout_s: float = 5.0):
        self.hosts = {i: HostState(i) for i in range(num_hosts)}
        self.timeout_s = timeout_s
        self.restarts = 0

    def beat(self, host_id: int, step_time_s: Optional[float] = None,
             now: Optional[float] = None) -> None:
        h = self.hosts[host_id]
        h.last_beat = now if now is not None else time.monotonic()
        if step_time_s is not None:
            h.step_times.append(step_time_s)

    def fail(self, host_id: int) -> None:
        self.hosts[host_id].alive = False

    def dead_hosts(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [h.host_id for h in self.hosts.values()
                if not h.alive or (h.last_beat and
                                   now - h.last_beat > self.timeout_s)]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple
    new_shape: tuple
    action: str                    # "shrink" | "grow" | "none"

    @property
    def changed(self) -> bool:
        return self.old_shape != self.new_shape


def plan_remesh(old_shape: tuple, axes: tuple, available_devices: int
                ) -> ElasticPlan:
    """Shrink/grow the leading (pod/data) axis to fit available devices.

    Keeps the model axis intact (TP degree is a property of the model
    sharding); scales data parallelism, which the checkpoint format and
    the counter-based data stream both tolerate exactly.
    """
    total = int(np.prod(old_shape))
    if available_devices >= total:
        return ElasticPlan(old_shape, old_shape, "none")
    lead = old_shape[0]
    rest = total // lead
    new_lead = max(1, available_devices // rest)
    new_shape = (new_lead,) + tuple(old_shape[1:])
    return ElasticPlan(old_shape, new_shape, "shrink")


class FailureInjector:
    """Deterministic failure schedule for tests/examples."""

    def __init__(self, fail_at_steps: dict[int, int]):
        # {step: host_id}
        self.fail_at_steps = dict(fail_at_steps)

    def maybe_fail(self, step: int, coordinator: Coordinator) -> Optional[int]:
        host = self.fail_at_steps.pop(step, None)
        if host is not None:
            coordinator.fail(host)
        return host


def run_with_restarts(
    *,
    num_steps: int,
    train_one_step: Callable[[int], dict],
    save_every: int,
    save_fn: Callable[[int], None],
    restore_fn: Callable[[], int],
    coordinator: Coordinator,
    injector: Optional[FailureInjector] = None,
    max_restarts: int = 8,
) -> dict:
    """Drive the step loop with checkpoint/restart semantics.

    ``train_one_step(step)`` runs the jitted step and returns metrics;
    ``restore_fn()`` reloads the latest checkpoint and returns its step.
    On detected failure: mark restart, restore, resume from the restored
    step (the data pipeline is keyed by step, so the replay is exact).
    """
    step = 0
    history = []
    while step < num_steps:
        if injector is not None:
            failed = injector.maybe_fail(step, coordinator)
            if failed is not None:
                if coordinator.restarts >= max_restarts:
                    raise RuntimeError("restart budget exhausted")
                coordinator.restarts += 1
                # recovery: replace host (simulated) + restore
                coordinator.hosts[failed].alive = True
                step = restore_fn()
                continue
        metrics = train_one_step(step)
        for h in coordinator.hosts.values():
            coordinator.beat(h.host_id,
                             step_time_s=metrics.get("step_time_s"))
        history.append({"step": step, **{k: float(v)
                                         for k, v in metrics.items()}})
        step += 1
        if step % save_every == 0:
            save_fn(step)
    return {"history": history, "restarts": coordinator.restarts}
