"""FaultInjectionProvider: deterministic chaos for the resilience layer.

Wraps any registered backend and injects the three failure modes a
long-running profiling service must survive — raised exceptions, latency
spikes (which per-call timeouts turn into ``ProviderCallTimeout``), and
corrupt ``CounterSet``s (which ``counter_set_error`` catches) — on a
*seeded schedule*: the rng draws a fixed number of variates per call in
call order, so two runs with the same seed inject exactly the same
faults regardless of which rates are enabled.  That determinism is what
makes the retry/backoff/breaker edge-case tests and the chaos acceptance
test reproducible.

The wrapper keeps the inner provider's ``name`` by default, so cache and
memo keys are unchanged — fault injection perturbs *availability*, never
identity.  Rates are adjustable at runtime (``configure``) so a test or
benchmark can trip a breaker with ``fault_rate=1.0`` and then measure
recovery after restoring it.

Around the kernel provider, a fault is raised before the launch and a
corruption replaces the counters of a launch that ran, so a chaos run
on the card still launches the kernels for every call not faulted.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.analysis.resilience import TransientProviderError
from repro_torch.core.counters import CounterSet


class InjectedFault(TransientProviderError):
    """The exception the fault schedule raises (transient by design)."""


class FaultInjectionProvider:
    """Chaos wrapper around any ``CounterProvider`` (see module docstring).

    Per ``collect`` call, three independent draws decide (in order)
    exception injection, latency injection, and result corruption; a
    corrupt result replaces ``O`` with NaNs — structurally detectable,
    never silently plausible.  ``stats`` counts calls and injections.
    """

    def __init__(self, inner, *, fault_rate: float = 0.0,
                 latency_rate: float = 0.0, latency_s: float = 0.05,
                 corrupt_rate: float = 0.0, seed: int = 0,
                 name: Optional[str] = None,
                 sleep=time.sleep) -> None:
        from repro_torch.analysis.providers.base import get_provider
        self.inner = get_provider(inner)
        self.name = self.inner.name if name is None else name
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.latency_s = latency_s
        self.configure(fault_rate=fault_rate, latency_rate=latency_rate,
                       corrupt_rate=corrupt_rate)
        self.stats = {"calls": 0, "faults": 0, "latency": 0, "corrupt": 0}

    def configure(self, *, fault_rate: Optional[float] = None,
                  latency_rate: Optional[float] = None,
                  corrupt_rate: Optional[float] = None) -> None:
        """Adjust injection rates at runtime (draw schedule unchanged)."""
        with self._lock:
            for attr, value in (("fault_rate", fault_rate),
                                ("latency_rate", latency_rate),
                                ("corrupt_rate", corrupt_rate)):
                if value is None:
                    continue
                if not 0.0 <= value <= 1.0:
                    raise ValueError(
                        f"{attr} must be in [0, 1], got {value}")
                setattr(self, attr, value)

    def stats_snapshot(self) -> dict:
        """Point-in-time copy of the injection accounting."""
        with self._lock:
            return dict(self.stats)

    def _draw(self) -> tuple[float, float, float]:
        with self._lock:
            self.stats["calls"] += 1
            # always three draws so the schedule is rate-independent
            return (self._rng.random(), self._rng.random(),
                    self._rng.random())

    def collect(self, spec, device) -> CounterSet:
        u_fault, u_latency, u_corrupt = self._draw()
        if u_fault < self.fault_rate:
            with self._lock:
                self.stats["faults"] += 1
            raise InjectedFault(
                f"injected fault on {spec.label!r} "
                f"(call {self.stats['calls']})")
        if u_latency < self.latency_rate:
            with self._lock:
                self.stats["latency"] += 1
            self._sleep(self.latency_s)
        cset = self.inner.collect(spec, device)
        if u_corrupt < self.corrupt_rate:
            with self._lock:
                self.stats["corrupt"] += 1
            return dataclasses.replace(
                cset, O=np.full_like(np.asarray(cset.O, np.float64),
                                     np.nan))
        return cset
