"""Process-wide metrics registry and lightweight tracing spans.

A stdlib copy of the reference's ``obs/telemetry.py``, with the same
metric names, so the port's ``Session`` and ``SweepCache`` report what the
reference's do.  Two halves:

* **Metrics** — a thread-safe registry of counters, gauges, and
  histograms with *bounded* label sets (a metric never grows more than
  ``max_series`` distinct label-value combinations; the excess collapses
  into a reserved ``__overflow__`` series so a hostile or buggy caller
  cannot blow up the registry).  ``render()`` emits the Prometheus text
  exposition format (``text/plain; version=0.0.4``) using only the
  stdlib — no client library dependency.

* **Spans** — ``trace_scope()`` opens a trace (with a propagated or
  freshly minted trace id) in a ``contextvars`` context, and ``span()``
  records named, timed sections into it.  While torch's profiler is
  recording (``tracing()``), a span also opens a profiler range of its
  name, so that it lands in the device trace beside the kernels it
  launched, on the same clock.  Outside a scope and without the
  profiler a span records nothing.

Everything here is stdlib-only and imports nothing from the rest of
``repro_torch`` — the analysis layer imports *us*, never the other way
around.  torch is looked up in ``sys.modules``, never imported.

A global enable switch (``set_enabled``) turns every write into a no-op,
so an instrumented pipeline can be measured with telemetry off.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import sys
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "REGISTRY", "counter", "gauge", "histogram", "render", "reset",
    "set_enabled", "enabled", "disabled",
    "new_trace_id", "trace_scope", "span", "tracing", "OVERFLOW",
]

# ---------------------------------------------------------------------------
# global enable switch

_ENABLED = True


def set_enabled(flag: bool) -> None:
    """Globally enable/disable all metric writes and span recording."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Context manager: telemetry off inside, previous state restored."""
    prev = _ENABLED
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


# ---------------------------------------------------------------------------
# metrics

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: reserved label value absorbing series beyond the cardinality bound
OVERFLOW = "__overflow__"

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


class _Metric:
    """Shared series bookkeeping (the label-cardinality bound lives here)."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str], max_series: int,
                 lock: threading.Lock) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.max_series = int(max_series)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        """Label values -> series key, collapsing past the bound.

        Caller must hold ``self._lock``.
        """
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        if key in self._series or len(self._series) < self.max_series:
            return key
        return (OVERFLOW,) * len(self.labelnames)

    def _zero(self) -> object:
        raise NotImplementedError

    def _slot(self, labels: Dict[str, object]) -> object:
        key = self._key(labels)
        slot = self._series.get(key)
        if slot is None:
            slot = self._series[key] = self._zero()
        return slot

    def series(self) -> Dict[Tuple[str, ...], object]:
        """Snapshot of {label-values: value} (for tests / status)."""
        with self._lock:
            return dict(self._series)

    def _render_lines(self) -> List[str]:
        raise NotImplementedError

    def _fmt(self, key: Tuple[str, ...],
             extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [f'{ln}="{_escape(v)}"'
                 for ln, v in zip(self.labelnames, key)]
        pairs += [f'{ln}="{_escape(v)}"' for ln, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Metric):
    """A count that only goes up.  ``inc`` also takes an amount that is
    not a Python number, such as a 0-d device tensor: it is kept pending,
    summed with ``+``, and turned into a float only when the counter is
    read (``value``, ``render``), so that counting never waits for the
    device."""

    kind = "counter"

    def _zero(self) -> list:
        return [0.0, None]          # the count, and the pending amount

    def inc(self, amount: object = 1.0, **labels: object) -> None:
        if not _ENABLED:
            return
        number = isinstance(amount, (int, float))
        if number and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            slot = self._slot(labels)
            if number:
                slot[0] += amount
            else:
                slot[1] = amount if slot[1] is None else slot[1] + amount

    @staticmethod
    def _settle(slot: list) -> float:
        """The slot's count with its pending amount folded in.  Caller
        must hold the lock."""
        if slot[1] is not None:
            slot[0] += float(slot[1])
            slot[1] = None
        return slot[0]

    def value(self, **labels: object) -> float:
        with self._lock:
            key = tuple(str(labels[ln]) for ln in self.labelnames)
            slot = self._series.get(key)
            return float(self._settle(slot)) if slot else 0.0

    def _render_lines(self) -> List[str]:
        return [f"{self.name}{self._fmt(k)} {_num(self._settle(v))}"
                for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    kind = "gauge"

    def _zero(self) -> List[float]:
        return [0.0]

    def set(self, value: float, **labels: object) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._slot(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._slot(labels)[0] += amount

    def dec(self, amount: float = 1.0, **labels: object) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: object) -> float:
        with self._lock:
            key = tuple(str(labels[ln]) for ln in self.labelnames)
            slot = self._series.get(key)
            return float(slot[0]) if slot else 0.0

    def _render_lines(self) -> List[str]:
        return [f"{self.name}{self._fmt(k)} {_num(v[0])}"
                for k, v in sorted(self._series.items())]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str], max_series: int,
                 lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help_text, labelnames, max_series, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _zero(self) -> Dict[str, object]:
        return {"bucket": [0] * len(self.buckets), "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels: object) -> None:
        if not _ENABLED:
            return
        with self._lock:
            slot = self._slot(labels)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    slot["bucket"][i] += 1
            slot["sum"] += float(value)
            slot["count"] += 1

    def _render_lines(self) -> List[str]:
        lines: List[str] = []
        for key, slot in sorted(self._series.items()):
            for bound, n in zip(self.buckets, slot["bucket"]):
                extra = (("le", _num(bound)),)
                lines.append(f"{self.name}_bucket"
                             f"{self._fmt(key, extra)} {n}")
            lines.append(f"{self.name}_bucket"
                         f"{self._fmt(key, (('le', '+Inf'),))} "
                         f"{slot['count']}")
            lines.append(f"{self.name}_sum{self._fmt(key)} "
                         f"{_num(slot['sum'])}")
            lines.append(f"{self.name}_count{self._fmt(key)} "
                         f"{slot['count']}")
        return lines


def _num(v: float) -> str:
    """Prometheus-friendly number formatting (ints without trailing .0)."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Named metric instruments with idempotent registration."""

    def __init__(self, max_series: int = 64) -> None:
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls, name: str, help_text: str,
                     labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set")
                return existing
            metric = cls(name, help_text, labelnames, self.max_series,
                         self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help_text, labelnames,
                                 buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    out.append(f"# HELP {name} {_escape(m.help)}")
                out.append(f"# TYPE {name} {m.kind}")
                out.extend(m._render_lines())
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Drop all recorded series (instrument definitions survive)."""
        with self._lock:
            for m in self._metrics.values():
                m._series.clear()


#: the process-wide default registry every instrumented layer writes to
REGISTRY = MetricsRegistry()


def counter(name: str, help_text: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help_text, labelnames)


def gauge(name: str, help_text: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help_text, labelnames)


def histogram(name: str, help_text: str = "",
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help_text, labelnames, buckets)


def render() -> str:
    return REGISTRY.render()


def reset() -> None:
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# tracing spans

#: spans recorded per trace are capped so a pathological job can't grow
#: the response body without bound
MAX_SPANS = 256

_TRACE: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "repro_obs_trace", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


@contextlib.contextmanager
def trace_scope(trace_id: Optional[str] = None) -> Iterator[dict]:
    """Open a trace: mint/propagate an id and collect spans inside.

    Nested scopes stack — the inner scope gets its own span list, and
    the outer one is restored on exit.
    """
    rec = {"id": str(trace_id) if trace_id else new_trace_id(),
           "spans": [], "t0": time.perf_counter()}
    token = _TRACE.set(rec)
    try:
        yield rec
    finally:
        _TRACE.reset(token)


def tracing() -> bool:
    """True only while torch's profiler is recording.  With torch not
    loaded, or the profiler off, it costs a dictionary lookup and an
    attribute read, and no call into torch."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


@contextlib.contextmanager
def span(name: str, **attrs: object) -> Iterator[None]:
    """Record a named, timed section into the enclosing trace scope, and,
    while the profiler is recording, open a profiler range of the same
    name around it (inside a scope or not).

    Cheap no-op when telemetry is disabled, or when no scope is open and
    the profiler is off.
    """
    rec = _TRACE.get() if _ENABLED else None
    profiled = _ENABLED and tracing()
    if rec is None and not profiled:
        yield
        return
    rng = (sys.modules["torch.autograd.profiler"].record_function(str(name))
           if profiled else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with rng:
            yield
    finally:
        if rec is not None and len(rec["spans"]) < MAX_SPANS:
            entry = {
                "name": str(name),
                "start_ms": round((t0 - rec["t0"]) * 1e3, 3),
                "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }
            if attrs:
                entry["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
            rec["spans"].append(entry)


def _jsonable(v: object) -> object:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
