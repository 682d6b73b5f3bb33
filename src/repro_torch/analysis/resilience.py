"""Fault-tolerant counter acquisition: retries, timeouts, breakers.

A long-running profiling service cannot assume a provider call returns,
returns quickly, or returns *sane numbers*: a kernel launch can hang or
fail, a racing cache writer can be killed mid-flight, and an
instrumented backend can hand back garbage.  This module is the one
place those failure modes are handled, so ``Session`` and the
``repro_torch.service`` daemon never see them raw:

* ``RetryPolicy`` — bounded retries with exponential backoff + jitter,
  deterministic under a seed (``schedule()``) so tests can pin the exact
  delay sequence.
* ``Deadline`` / ``resilience_scope`` — a per-job time budget carried in
  a context variable; every provider call under the scope shrinks its
  own timeout to the remaining budget, so a job with a 2 s deadline
  never waits 30 s on a hung backend.
* ``CircuitBreaker`` — per-provider closed/open/half-open state: after
  ``failure_threshold`` consecutive failures the provider is skipped
  outright (no timeout paid per request) until ``cooldown_s`` elapses,
  then exactly one half-open probe decides re-close vs re-open.
* ``ResilientProvider`` — a ``CounterProvider`` wrapper running every
  ``collect`` through timeout + retry + breaker, then down a degraded
  fallback chain (e.g. kernel -> trace -> cached-stale).  Fallback
  results are stamped ``meta["degraded"]`` with the fallback provider's
  name, so a response built from them can honor the service's
  degraded-response contract; ``Session`` refuses to write degraded
  counters to the persistent cache (they are not the primary's numbers).

On the card, a call that times out is abandoned, not stopped: its thread
may still launch a kernel and wait on ``torch.cuda.synchronize`` after
the caller has moved on.  For a ``cuda`` kernel provider the circuit
breaker is what bounds how many such calls pile up.  A CUDA error is a
``RuntimeError``, which is not in ``TRANSIENT_ERRORS``: it goes straight
to the next provider in the chain, unretried.

Nothing here imports torch; the layer is pure stdlib + numpy and safe to
use from any thread.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import random
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.counters import CounterSet
from repro_torch.obs import telemetry as _telemetry

_CALL_SECONDS = _telemetry.histogram(
    "repro_provider_call_seconds", "Per-provider collect call latency",
    ("provider",))
_RETRIES = _telemetry.counter(
    "repro_provider_retries_total",
    "Transient provider errors that entered the retry path", ("provider",))
_BREAKER_TRANSITIONS = _telemetry.counter(
    "repro_breaker_transitions_total",
    "Circuit-breaker state transitions", ("provider", "to"))
_FALLBACKS = _telemetry.counter(
    "repro_provider_fallbacks_total",
    "Degraded collects served by a fallback source",
    ("provider", "fallback"))


# -- error taxonomy ----------------------------------------------------------


class TransientProviderError(RuntimeError):
    """A provider failure worth retrying (fault, timeout, corrupt read)."""


class ProviderCallTimeout(TransientProviderError):
    """One provider call exceeded its per-call timeout."""


class CorruptCounterError(TransientProviderError):
    """A provider returned a structurally invalid ``CounterSet``."""


class DeadlineExceeded(RuntimeError):
    """The enclosing job's time budget ran out before a result existed."""


class ResilienceExhausted(RuntimeError):
    """Every provider in the chain (and the stale cache) failed.

    ``errors`` carries the per-attempt ``(provider, exception)`` pairs so
    callers can report *why* the chain died, not just that it did.
    """

    def __init__(self, message: str, errors: Sequence[tuple] = ()) -> None:
        super().__init__(message)
        self.errors = list(errors)


# exception classes a retry may fix; anything else is treated as
# permanent for the current provider (straight to the next in the chain)
TRANSIENT_ERRORS = (TransientProviderError, TimeoutError, ConnectionError,
                    OSError)


# -- retry policy ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter.

    ``retries`` is the number of *re*-tries: a call is attempted
    ``retries + 1`` times.  Delay before retry ``k`` (0-based) is
    ``min(backoff_base_s * backoff_factor**k, max_backoff_s)`` scaled by
    ``1 + jitter * u`` with ``u ~ U[0, 1)`` from the caller's rng — a
    seeded rng therefore yields a fully deterministic schedule
    (``schedule()``), which is how the edge-case tests pin it.
    """

    retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25

    def __post_init__(self) -> None:
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.backoff_base_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    @property
    def attempts(self) -> int:
        return self.retries + 1

    def delay(self, attempt: int, rng: Optional[random.Random] = None,
              ) -> float:
        """Backoff before re-attempt ``attempt`` (0-based)."""
        base = min(self.backoff_base_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)
        if self.jitter and rng is not None:
            return base * (1.0 + self.jitter * rng.random())
        return base

    def schedule(self, seed: int = 0) -> list[float]:
        """The full deterministic delay sequence for one call under
        ``seed`` — what a failing call would sleep between attempts."""
        rng = random.Random(seed)
        return [self.delay(k, rng) for k in range(self.retries)]


# -- deadlines (per-job time budgets) ----------------------------------------


class Deadline:
    """A monotonic time budget (``None`` seconds = unbounded)."""

    def __init__(self, seconds: Optional[float], *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if seconds is not None and seconds <= 0:
            raise ValueError(f"deadline must be > 0 seconds, got {seconds}")
        self._clock = clock
        self.seconds = seconds
        self._expires = None if seconds is None else clock() + seconds

    def remaining(self) -> float:
        if self._expires is None:
            return math.inf
        return self._expires - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0


_DEADLINE: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("repro_resilience_deadline", default=None)
_EVENTS: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("repro_resilience_events", default=None)


def current_deadline() -> Optional[Deadline]:
    """The enclosing ``resilience_scope``'s deadline, if any."""
    return _DEADLINE.get()


def record_event(event: dict) -> None:
    """Append a degradation/failure event to the enclosing scope.

    A no-op outside a scope, so ``ResilientProvider`` can always call it
    unconditionally.
    """
    events = _EVENTS.get()
    if events is not None:
        events.append(event)


@contextlib.contextmanager
def resilience_scope(timeout_s: Optional[float] = None, *,
                     clock: Callable[[], float] = time.monotonic):
    """Install a per-job deadline + event recorder for the current context.

    The service worker wraps each job in one of these; every
    ``ResilientProvider`` call underneath sees the deadline and records
    its degradations into the yielded list::

        with resilience_scope(job.timeout_s) as events:
            result = session.analyze(specs)
        degraded = [e for e in events if e.get("kind") == "fallback"]
    """
    deadline = Deadline(timeout_s, clock=clock) \
        if timeout_s is not None else None
    events: list = []
    tok_d = _DEADLINE.set(deadline)
    tok_e = _EVENTS.set(events)
    try:
        yield events
    finally:
        _DEADLINE.reset(tok_d)
        _EVENTS.reset(tok_e)


# -- per-call timeouts -------------------------------------------------------


def call_with_timeout(fn: Callable, timeout_s: Optional[float]):
    """Run ``fn()`` with a wall-clock bound; raise ``ProviderCallTimeout``.

    Python cannot preempt a running thread, so on timeout the worker
    thread is *abandoned* (daemonized — it cannot block interpreter
    exit) and its eventual result discarded.  That leaks at most one
    busy thread per hung call, which is the price of never hanging the
    caller; the circuit breaker keeps a repeatedly-hanging provider from
    piling these up.
    """
    if timeout_s is None or timeout_s == math.inf:
        return fn()
    if timeout_s <= 0:
        raise ProviderCallTimeout(
            f"no time budget left for the call ({timeout_s:.3g}s)")
    outcome: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            outcome["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            outcome["error"] = exc
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name="repro-resilience-call")
    t.start()
    if not done.wait(timeout_s):
        raise ProviderCallTimeout(
            f"provider call exceeded {timeout_s:.3g}s")
    if "error" in outcome:
        raise outcome["error"]
    return outcome["value"]


# -- circuit breaker ---------------------------------------------------------


class CircuitBreaker:
    """Per-provider closed / open / half-open failure gate.

    Closed: calls flow, consecutive failures are counted.  At
    ``failure_threshold`` the breaker opens: ``allow()`` rejects without
    paying the provider's timeout.  After ``cooldown_s`` the next
    ``allow()`` transitions to half-open and admits exactly one probe;
    the probe's outcome re-closes (success) or re-opens with a fresh
    cooldown (failure).  All transitions are lock-protected; ``clock``
    is injectable so tests drive time explicitly.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 30.0,
                 *, clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._trips = 0

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = self.HALF_OPEN
                    return True          # the single half-open probe
                return False
            return False                 # half-open: probe already in flight

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if (self._state == self.HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._trips += 1

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        """The status-endpoint view of this breaker."""
        with self._lock:
            remaining = 0.0
            if self._state == self.OPEN:
                remaining = max(
                    0.0,
                    self.cooldown_s - (self._clock() - self._opened_at))
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "trips": self._trips,
                "cooldown_remaining_s": round(remaining, 3),
            }


# -- counter sanity ----------------------------------------------------------


def counter_set_error(cset) -> Optional[str]:
    """Why ``cset`` is not a sane ``CounterSet`` (``None`` when it is).

    The structural checks every downstream consumer silently assumes:
    per-core arrays of the declared core count, finite non-negative
    counters, finite roofline fields.  The resilience layer treats a
    violation as a transient failure (``CorruptCounterError``) so a
    corrupting backend is retried/failed over instead of poisoning the
    model evaluation or the persistent cache.
    """
    if not isinstance(cset, CounterSet):
        return f"expected a CounterSet, got {type(cset).__name__}"
    if cset.num_cores < 1:
        return f"num_cores must be >= 1, got {cset.num_cores}"
    for name in ("O", "N_f", "N_c", "N_p"):
        arr = getattr(cset, name)
        if not isinstance(arr, np.ndarray):
            return f"{name} is not an ndarray"
        if arr.shape != (cset.num_cores,):
            return (f"{name} has shape {arr.shape}, expected "
                    f"({cset.num_cores},)")
        if not np.all(np.isfinite(arr)):
            return f"{name} contains non-finite values"
        if np.any(arr < 0):
            return f"{name} contains negative counts"
    for name in ("lanes_active", "bytes_read", "flops", "ici_bytes",
                 "overhead_cycles"):
        v = getattr(cset, name)
        if not math.isfinite(v):
            return f"{name} is non-finite ({v!r})"
        if v < 0:
            return f"{name} is negative ({v!r})"
    if cset.num_waves < 0:
        return f"num_waves is negative ({cset.num_waves})"
    if cset.waves_per_tile < 1 or cset.pipeline_depth < 1:
        return (f"launch geometry out of range (waves_per_tile="
                f"{cset.waves_per_tile}, pipeline_depth="
                f"{cset.pipeline_depth})")
    if cset.wall_time_s is not None and not math.isfinite(cset.wall_time_s):
        return f"wall_time_s is non-finite ({cset.wall_time_s!r})"
    return None


def mark_degraded(cset: CounterSet, *, fallback: str,
                  primary: str) -> CounterSet:
    """Copy of ``cset`` stamped as a degraded (non-primary) result."""
    meta = {**cset.meta, "degraded": True, "fallback_provider": fallback,
            "primary_provider": primary}
    return dataclasses.replace(cset, meta=meta)


def is_degraded(cset: CounterSet) -> bool:
    return bool(cset.meta.get("degraded"))


# -- the resilient provider wrapper ------------------------------------------


class ResilientProvider:
    """A ``CounterProvider`` that survives its backends.

    ``collect`` runs the primary through per-call timeout + retry +
    breaker; on exhaustion it walks the ``fallbacks`` chain the same
    way, and as a last resort serves the primary's last known counters
    from ``stale_cache`` (the persistent ``SweepCache``).  Every
    non-primary result is stamped ``meta["degraded"]`` with the fallback
    provider's name (``"cached-stale"`` for the cache), and a matching
    event is recorded into the enclosing ``resilience_scope``.

    ``name`` mirrors the primary's so memo and cache keys are shared
    with a plain session — a spec warmed by a direct CLI sweep is a
    zero-collection hit for the service, and vice versa.  Degraded
    results never reach the disk cache (``Session`` checks
    ``is_degraded`` before write-back), so that transparency cannot
    cache another provider's numbers under the primary's key.

    ``collect_batch`` is deliberately *not* implemented: the service
    values per-point failure isolation over vectorization, so
    ``Session`` loops the resilient scalar path via its fallback.
    """

    def __init__(self, primary, *, fallbacks: Sequence = (),
                 stale_cache=None,
                 retry: RetryPolicy = RetryPolicy(),
                 call_timeout_s: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 30.0,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        # lazy: the providers package imports this module (fault.py)
        from repro_torch.analysis.providers.base import get_provider
        self.primary = get_provider(primary)
        # identity (not name) dedup: a fault-wrapped primary shares its
        # inner provider's name, and that inner provider is still a
        # legitimate fallback
        chain = []
        for f in fallbacks:
            prov = get_provider(f)
            if prov is not self.primary and prov not in chain:
                chain.append(prov)
        self.fallbacks = chain
        self.stale_cache = stale_cache
        self.retry = retry
        self.call_timeout_s = call_timeout_s
        self.name = self.primary.name
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        # one breaker per provider *instance*, not per name: a
        # fault-wrapped primary shares its inner provider's name, and the
        # primary's failures must never open the fallback's breaker
        self.breakers: dict[int, CircuitBreaker] = {}
        self._breaker_labels: dict[int, str] = {}
        for prov in [self.primary, *self.fallbacks]:
            label = prov.name
            taken = set(self._breaker_labels.values())
            k = 2
            while label in taken:
                label = f"{prov.name}#{k}"
                k += 1
            self.breakers[id(prov)] = CircuitBreaker(
                breaker_threshold, breaker_cooldown_s, clock=clock)
            self._breaker_labels[id(prov)] = label

    @staticmethod
    def _key(prov) -> str:
        return prov.name

    def breaker_states(self) -> dict:
        """Per-provider breaker snapshots (the /status payload).

        Keys are provider names, suffixed ``#2``... when two chain
        entries share one (a fault-wrapped primary and its raw inner
        provider as fallback).
        """
        return {self._breaker_labels[pid]: br.snapshot()
                for pid, br in self.breakers.items()}

    # -- the chain -------------------------------------------------------

    def collect(self, spec, device) -> CounterSet:
        deadline = current_deadline()
        errors: list[tuple[str, BaseException]] = []
        for pos, prov in enumerate([self.primary, *self.fallbacks]):
            if deadline is not None and deadline.expired:
                record_event({"kind": "deadline", "label": spec.label,
                              "provider": self._key(prov)})
                break
            cset = self._collect_one(prov, spec, device, deadline, errors)
            if cset is None:
                continue
            if pos > 0:
                cset = mark_degraded(cset, fallback=self._key(prov),
                                     primary=self.name)
                record_event({"kind": "fallback", "label": spec.label,
                              "provider": self.name,
                              "fallback": self._key(prov)})
                _FALLBACKS.inc(provider=self.name,
                               fallback=self._key(prov))
            return cset
        stale = self._collect_stale(spec, device)
        if stale is not None:
            record_event({"kind": "fallback", "label": spec.label,
                          "provider": self.name,
                          "fallback": "cached-stale"})
            _FALLBACKS.inc(provider=self.name, fallback="cached-stale")
            return stale
        detail = "; ".join(f"{name}: {type(exc).__name__}: {exc}"
                           for name, exc in errors) or "no provider admitted"
        if deadline is not None and deadline.expired:
            raise DeadlineExceeded(
                f"{spec.label!r}: job deadline exhausted before any "
                f"provider returned ({detail})")
        raise ResilienceExhausted(
            f"{spec.label!r}: every provider failed and no stale cache "
            f"entry exists ({detail})", errors)

    def _note_breaker(self, prov, before: str) -> None:
        """Count a breaker state transition (telemetry, no behaviour)."""
        after = self.breakers[id(prov)].state
        if after != before:
            _BREAKER_TRANSITIONS.inc(
                provider=self._breaker_labels[id(prov)], to=after)

    def _collect_one(self, prov, spec, device, deadline, errors):
        """Timeout + retry + breaker for one provider; None = move on."""
        br = self.breakers[id(prov)]
        for attempt in range(self.retry.attempts):
            if deadline is not None and deadline.expired:
                return None
            br_state = br.state
            admitted = br.allow()
            self._note_breaker(prov, br_state)  # open -> half-open probes
            if not admitted:
                record_event({"kind": "breaker-skip", "label": spec.label,
                              "provider": self._key(prov)})
                return None
            timeout = self.call_timeout_s
            if deadline is not None:
                remaining = deadline.remaining()
                timeout = remaining if timeout is None \
                    else min(timeout, remaining)
            t0 = time.perf_counter()
            try:
                cset = call_with_timeout(
                    lambda: prov.collect(spec, device), timeout)
                _CALL_SECONDS.observe(time.perf_counter() - t0,
                                      provider=self._key(prov))
                problem = counter_set_error(cset)
                if problem:
                    raise CorruptCounterError(
                        f"{self._key(prov)} returned corrupt counters "
                        f"for {spec.label!r}: {problem}")
                br_state = br.state
                br.record_success()
                self._note_breaker(prov, br_state)
                return cset
            except TRANSIENT_ERRORS as exc:
                br_state = br.state
                br.record_failure()
                self._note_breaker(prov, br_state)
                errors.append((self._key(prov), exc))
                _RETRIES.inc(provider=self._key(prov))
                record_event({"kind": "retry", "label": spec.label,
                              "provider": self._key(prov),
                              "attempt": attempt,
                              "error": f"{type(exc).__name__}: {exc}"})
                if attempt + 1 < self.retry.attempts:
                    delay = self._next_delay(attempt)
                    if deadline is not None:
                        delay = min(delay, max(deadline.remaining(), 0.0))
                    if delay > 0:
                        self._sleep(delay)
            except Exception as exc:  # permanent: straight to the next
                br_state = br.state
                br.record_failure()
                self._note_breaker(prov, br_state)
                errors.append((self._key(prov), exc))
                record_event({"kind": "permanent", "label": spec.label,
                              "provider": self._key(prov),
                              "error": f"{type(exc).__name__}: {exc}"})
                return None
        return None

    def _next_delay(self, attempt: int) -> float:
        with self._rng_lock:
            return self.retry.delay(attempt, self._rng)

    def _collect_stale(self, spec, device) -> Optional[CounterSet]:
        """Last-resort read of the primary's last known cached counters.

        Deliberately allowed even after the deadline: a cache read costs
        microseconds and a stale answer beats no answer — that is the
        CUTHERMO-style graceful-degradation contract.
        """
        if self.stale_cache is None:
            return None
        fp = spec.fingerprint()
        if fp is None:
            return None
        try:
            key = self.stale_cache.key(self.name, fp, device.table_key())
            hit = self.stale_cache.get(key)
        except Exception:
            return None
        if hit is None:
            return None
        hit = dataclasses.replace(hit, label=spec.label)
        return mark_degraded(hit, fallback="cached-stale",
                             primary=self.name)
