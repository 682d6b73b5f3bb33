"""The profiling daemon: bounded workers, shared caches, never a 500.

``ProfilingService`` owns one ``ResilientProvider`` stack (optionally
fault-wrapped for chaos runs) and one lazily-built ``Session`` per
device, all sharing the session memo and the persistent ``SweepCache`` —
so a spec profiled once is a zero-collection hit for every later job,
whichever client or kind asks.  Jobs flow::

    HTTP POST /v1/jobs -> parse_job (400 on malformed payloads)
                       -> bounded queue (429 + Retry-After when full)
                       -> worker thread under resilience_scope(timeout)
                       -> 200 {ok, result, degraded, fallback_providers}

The response contract is the whole point: a request is answered with its
result, an *explicitly degraded* result naming the fallback provider
that produced it, or a typed JSON error (400 / 429 / 503 / 504) — never
a bare 500 and never a hang, because every provider call underneath runs
through deadlines, per-call timeouts, retries, and circuit breakers.

``serve(config)`` is the blocking CLI entry point (``python -m
repro_torch serve``); ``ProfilingService`` alone
(``start``/``handle``/``stop``) is the embeddable form the tests and
``chip_smoke.py`` drive in-process.

The instrumented kernels run on ``ServiceConfig.torch_device`` (default
``cuda``): every ``"kernel"`` the service names — its primary, a
fallback, a ``validate`` job's providers, an ``advise`` job's
``validate_top`` — is one ``InstrumentedKernelProvider`` on that device,
made once per service, never the registered instance.  With ``kernel``
as the primary or a fallback on a CUDA device, ``start()`` builds and
loads the kernels' libraries and starts the CUDA context before any
worker takes a job, so no job's call timeout pays for ``nvcc``; a failed
build raises out of ``start()`` and nothing falls back.  A daemon whose
chain holds no ``kernel`` has checked no card and loaded nothing, so it
refuses (400) a ``validate`` job that names ``kernel`` (its default
providers do) and an ``advise`` job with ``validate_top``.  ``device``
stays the *modeled* device (``v5e``/``v5p``).
"""

from __future__ import annotations

import dataclasses
import json
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.analysis.providers import (FaultInjectionProvider,
                                            InstrumentedKernelProvider,
                                            get_provider)
from repro_torch.analysis.resilience import (
    DeadlineExceeded,
    ResilienceExhausted,
    ResilientProvider,
    RetryPolicy,
    resilience_scope,
)
from repro_torch.analysis.session import Session
from repro_torch.analysis.sweep_cache import SweepCache
from repro_torch.obs import telemetry as _telemetry
from repro_torch.service.jobs import (JOB_KINDS, Job, JobError,
                                      describe_defaults, parse_job)

_QUEUE_DEPTH = _telemetry.gauge(
    "repro_service_queue_depth", "Jobs waiting in the bounded queue")
_JOBS_TOTAL = _telemetry.counter(
    "repro_service_jobs_total", "Service jobs by kind and outcome",
    ("kind", "outcome"))
_JOB_SECONDS = _telemetry.histogram(
    "repro_service_job_seconds", "Job wall-clock by kind and outcome",
    ("kind", "outcome"))
_BREAKER_OPEN = _telemetry.gauge(
    "repro_circuit_breaker_open",
    "1 while the named provider's circuit breaker is open", ("provider",))

_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9_-]")


class ServiceOverloaded(RuntimeError):
    """Queue full — shed the request (HTTP 429 + Retry-After)."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class ServiceConfig:
    """Everything ``python -m repro_torch serve`` exposes as flags, as
    one record."""

    host: str = "127.0.0.1"
    port: int = 0                       # 0 = ephemeral (printed on start)
    workers: int = 4
    queue_depth: int = 32
    device: str = "v5e"
    provider: str = "trace"
    fallbacks: tuple = ("trace",)
    timeout_s: float = 30.0             # default + cap basis for job deadlines
    max_timeout_s: float = 300.0
    max_points: int = 4096              # sweep-size cap per job
    call_timeout_s: Optional[float] = 10.0
    retries: int = 2
    backoff_base_s: float = 0.05
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 5.0
    persistent_cache: bool = True
    # chaos knobs (all off by default; the CI smoke test turns them on)
    fault_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.05
    corrupt_rate: float = 0.0
    fault_seed: int = 0
    # where the instrumented kernels run (``device`` is the modeled one)
    torch_device: str = "cuda"

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.timeout_s <= 0 or self.max_timeout_s < self.timeout_s:
            raise ValueError(
                f"need 0 < timeout_s <= max_timeout_s, got "
                f"{self.timeout_s} / {self.max_timeout_s}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")


class _Ticket:
    """One queued job + the event its submitter blocks on."""

    __slots__ = ("job", "done", "status", "body", "trace_id")

    def __init__(self, job: Job, trace_id: Optional[str] = None) -> None:
        self.job = job
        self.done = threading.Event()
        self.status: int = 503
        self.body: dict = {"ok": False, "error": "job was never run"}
        self.trace_id = trace_id or _telemetry.new_trace_id()


class ProfilingService:
    """The daemon behind ``python -m repro_torch serve`` (see module
    docstring)."""

    def __init__(self, config: Optional[ServiceConfig] = None) -> None:
        self.config = config or ServiceConfig()
        cfg = self.config
        # the one kernel provider every "kernel" of this service resolves to
        self.kernel = InstrumentedKernelProvider(
            torch_device=cfg.torch_device)
        self.runs_kernel = "kernel" in (cfg.provider, *cfg.fallbacks)
        base = get_provider(self._resolve(cfg.provider))
        self.fault: Optional[FaultInjectionProvider] = None
        primary = base
        if cfg.fault_rate or cfg.latency_rate or cfg.corrupt_rate:
            self.fault = FaultInjectionProvider(
                base, fault_rate=cfg.fault_rate,
                latency_rate=cfg.latency_rate, latency_s=cfg.latency_s,
                corrupt_rate=cfg.corrupt_rate, seed=cfg.fault_seed)
            primary = self.fault
        self.cache: Optional[SweepCache] = \
            SweepCache() if cfg.persistent_cache else None
        self.provider = ResilientProvider(
            primary,
            fallbacks=[self._resolve(f) for f in cfg.fallbacks],
            stale_cache=self.cache,
            retry=RetryPolicy(retries=cfg.retries,
                              backoff_base_s=cfg.backoff_base_s),
            call_timeout_s=cfg.call_timeout_s,
            breaker_threshold=cfg.breaker_threshold,
            breaker_cooldown_s=cfg.breaker_cooldown_s,
        )
        self._sessions: dict[str, Session] = {}
        self._sessions_lock = threading.Lock()
        self._advise_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
        self._threads: list[threading.Thread] = []
        self._started = False
        self._started_at = time.monotonic()
        self._counters_lock = threading.Lock()
        self.counters = {"submitted": 0, "completed": 0, "degraded": 0,
                         "failed": 0, "shed": 0, "invalid": 0}

    def _resolve(self, provider):
        """``"kernel"`` becomes this service's kernel provider (on
        ``torch_device``); other names and instances pass through."""
        return self.kernel if provider == "kernel" else provider

    def _load_kernels(self) -> None:
        """With ``kernel`` in the chain on a CUDA device: start the CUDA
        context, then build and load K3's and K6's libraries, so the
        first job pays for neither.  Raises on a missing card or a failed
        build: nothing falls back."""
        if not self.runs_kernel:
            return
        import torch   # only a chain with a kernel pays for torch

        dev = torch.device(self.kernel.torch_device)
        if dev.type != "cuda":
            return
        from repro_torch.kernels import _build

        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        for name in ("histogram", "scatter_add"):
            _build.load(name)

    def _check_kernel_reach(self, job: Job) -> None:
        """Refuse a job that would run ``kernel`` on a daemon that has not
        made it ready (see module docstring)."""
        if self.runs_kernel:
            return
        if job.kind == "validate" and "kernel" in job.options["providers"]:
            what = "a validate job through the 'kernel' provider"
        elif job.kind == "advise" and job.options.get("validate_top"):
            what = "an advise job with validate_top"
        else:
            return
        raise JobError(
            f"{what} needs a daemon with 'kernel' as its provider or a "
            f"fallback; this one runs {self.provider.name!r} with "
            f"fallbacks {[p.name for p in self.provider.fallbacks]}")

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ProfilingService":
        if self._started:
            return self
        self._load_kernels()
        self._started = True
        self._started_at = time.monotonic()
        for i in range(self.config.workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"repro-service-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Drain the pool: one sentinel per worker, then join."""
        if not self._started:
            return
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout_s)
        self._threads.clear()
        self._started = False

    def __enter__(self) -> "ProfilingService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the request path -------------------------------------------------

    @staticmethod
    def _kind_label(payload) -> str:
        """A *bounded* kind label for metrics (never raw client input)."""
        if isinstance(payload, dict) and payload.get("kind") in JOB_KINDS:
            return payload["kind"]
        return "unknown"

    def handle(self, payload,
               trace_id: Optional[str] = None) -> tuple[int, dict]:
        """(http_status, json_body) for one job payload — never raises.

        The single entry point both the HTTP handler and in-process
        callers use, so the never-500 contract is enforced in exactly
        one place.
        """
        try:
            return 200, self.submit(payload, trace_id=trace_id)
        except JobError as exc:
            self._count("invalid")
            _JOBS_TOTAL.inc(kind=self._kind_label(payload),
                            outcome="invalid")
            return 400, {"ok": False, "error": str(exc),
                         "error_kind": "invalid-job"}
        except ServiceOverloaded as exc:
            self._count("shed")
            _JOBS_TOTAL.inc(kind=self._kind_label(payload), outcome="shed")
            return 429, {"ok": False, "error": str(exc),
                         "error_kind": "overloaded",
                         "retry_after_s": exc.retry_after_s}
        except DeadlineExceeded as exc:
            self._count("failed")
            return 504, {"ok": False, "error": str(exc),
                         "error_kind": "deadline"}
        except ResilienceExhausted as exc:
            self._count("failed")
            return 503, {"ok": False, "error": str(exc),
                         "error_kind": "exhausted"}
        except Exception as exc:  # noqa: BLE001 — the never-500 contract
            self._count("failed")
            return 503, {"ok": False,
                         "error": f"{type(exc).__name__}: {exc}",
                         "error_kind": "internal"}

    def submit(self, payload, trace_id: Optional[str] = None) -> dict:
        """Parse, enqueue, and wait out one job; the success-path body.

        Raises ``JobError`` (malformed), ``ServiceOverloaded`` (queue
        full), ``DeadlineExceeded``/``ResilienceExhausted`` (the job ran
        and failed) — ``handle`` maps these to HTTP statuses.
        """
        if not self._started:
            raise RuntimeError("service not started — call start() first")
        cfg = self.config
        job = parse_job(payload, default_timeout_s=cfg.timeout_s,
                        max_timeout_s=cfg.max_timeout_s,
                        max_points=cfg.max_points)
        self._check_kernel_reach(job)
        ticket = _Ticket(job, trace_id)
        try:
            self._queue.put_nowait(ticket)
        except queue.Full:
            raise ServiceOverloaded(
                f"queue full ({cfg.queue_depth} jobs pending) — retry "
                f"shortly", retry_after_s=min(job.timeout_s, 1.0)) from None
        self._count("submitted")
        _QUEUE_DEPTH.set(self._queue.qsize())
        # the worker enforces the deadline; the extra grace only covers
        # queue wait + scheduling, so a hung worker can never hang a client
        grace = job.timeout_s + cfg.timeout_s + 5.0
        if not ticket.done.wait(grace):
            raise DeadlineExceeded(
                f"job {job.label!r} did not complete within {grace:.1f}s "
                f"(queue wait + deadline grace)")
        if ticket.status != 200:
            exc_kind = ticket.body.get("error_kind")
            message = ticket.body.get("error", "job failed")
            if exc_kind == "deadline":
                raise DeadlineExceeded(message)
            raise ResilienceExhausted(message)
        return ticket.body

    # -- workers ----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            ticket = self._queue.get()
            if ticket is None:
                return
            _QUEUE_DEPTH.set(self._queue.qsize())
            try:
                with _telemetry.trace_scope(ticket.trace_id) as trace:
                    ticket.status, ticket.body = self._run_job(ticket.job)
                    ticket.body["trace_id"] = trace["id"]
                    if ticket.status == 200:
                        ticket.body["spans"] = trace["spans"]
            except Exception as exc:  # noqa: BLE001 — belt and braces
                ticket.status = 503
                ticket.body = {"ok": False,
                               "error": f"{type(exc).__name__}: {exc}",
                               "error_kind": "internal",
                               "trace_id": ticket.trace_id}
            finally:
                ticket.done.set()

    def _observe_job(self, job: Job, outcome: str, started: float) -> None:
        _JOBS_TOTAL.inc(kind=job.kind, outcome=outcome)
        _JOB_SECONDS.observe(time.monotonic() - started,
                             kind=job.kind, outcome=outcome)

    def _run_job(self, job: Job) -> tuple[int, dict]:
        started = time.monotonic()
        sess = self.session(job.device)
        try:
            with resilience_scope(job.timeout_s) as events:
                with _telemetry.span("service.dispatch", kind=job.kind,
                                     label=job.label):
                    result = self._dispatch(sess, job)
        except DeadlineExceeded as exc:
            # failure counters are handle()'s job (one count per request)
            self._observe_job(job, "deadline", started)
            return 504, {"ok": False, "error": str(exc),
                         "error_kind": "deadline"}
        except (ResilienceExhausted, JobError, ValueError, OSError) as exc:
            self._observe_job(job, "failed", started)
            return 503, {"ok": False,
                         "error": f"{type(exc).__name__}: {exc}",
                         "error_kind": "exhausted"}
        fallbacks = sorted({e["fallback"] for e in events
                            if e.get("kind") == "fallback"})
        degraded = bool(fallbacks)
        self._count("completed")
        if degraded:
            self._count("degraded")
        self._observe_job(job, "degraded" if degraded else "ok", started)
        return 200, {
            "ok": True,
            "kind": job.kind,
            "device": job.device,
            "degraded": degraded,
            "fallback_providers": fallbacks,
            "elapsed_s": round(time.monotonic() - started, 4),
            "result": result,
        }

    def _dispatch(self, sess: Session, job: Job) -> dict:
        """Run one parsed job through the session API; JSON-ready result."""
        if job.kind in ("profile", "sweep"):
            result = sess.analyze(job.specs,
                                  parallel=job.options.get("parallel"))
            return json.loads(result.render("json"))
        if job.kind == "advise":
            # the advisor mutates search state across many collect calls;
            # one at a time keeps its frontier bookkeeping single-threaded
            # (collection itself still shares the session memo + cache)
            with self._advise_lock:
                report = sess.advise(job.specs[0],
                                     kernel_provider=self.kernel,
                                     **job.options)
            return json.loads(report.render("json"))
        if job.kind == "validate":
            report = sess.validate(
                job.specs[0],
                providers=[self._resolve(p)
                           for p in job.options["providers"]])
            return report.to_dict()
        if job.kind == "heatmap":
            kw = {k: job.options[k] for k in ("hot_degree",)
                  if k in job.options}
            hm = sess.heatmap(job.specs[0], **kw)
            return json.loads(hm.render(
                "json", top_k=job.options.get("top_k", 16)))
        raise JobError(f"unknown job kind {job.kind!r}")

    # -- shared state -----------------------------------------------------

    def session(self, device: str) -> Session:
        with self._sessions_lock:
            sess = self._sessions.get(device)
            if sess is None:
                sess = Session(
                    device, provider=self.provider,
                    persistent_cache=self.cache
                    if self.cache is not None else False)
                self._sessions[device] = sess
            return sess

    def _count(self, key: str) -> None:
        with self._counters_lock:
            self.counters[key] += 1

    def status(self) -> dict:
        with self._counters_lock:
            counters = dict(self.counters)
        body = {
            "ok": True,
            "uptime_s": round(time.monotonic() - self._started_at, 3),
            "workers": self.config.workers,
            "queue_depth": self.config.queue_depth,
            "queued": self._queue.qsize(),
            "provider": self.provider.name,
            "fallbacks": [p.name for p in self.provider.fallbacks],
            "counters": counters,
            "breakers": self.provider.breaker_states(),
            "sessions": {name: sess.stats_snapshot()
                         for name, sess in self._sessions.items()},
        }
        if self.cache is not None:
            body["cache_root"] = str(self.cache.root)
            body["cache"] = self.cache.stats()
        if self.fault is not None:
            body["fault_injection"] = self.fault.stats_snapshot()
        return body

    def refresh_metrics(self) -> None:
        """Push point-in-time gauges (queue, breakers) into the registry."""
        _QUEUE_DEPTH.set(self._queue.qsize())
        for name, snap in self.provider.breaker_states().items():
            _BREAKER_OPEN.set(1.0 if snap.get("state") == "open" else 0.0,
                              provider=name)

    def metrics_text(self) -> str:
        """The ``GET /metrics`` payload (Prometheus text exposition)."""
        self.refresh_metrics()
        return _telemetry.render()


# -- HTTP layer --------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """Thin JSON shim over ``ProfilingService.handle``/``status``."""

    service: ProfilingService      # set by make_http_server
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:   # quiet by default
        pass

    def _reply(self, status: int, body: dict,
               trace_id: Optional[str] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if trace_id:
            self.send_header("X-Repro-Trace-Id", trace_id)
        if status == 429:
            self.send_header(
                "Retry-After",
                str(max(1, round(body.get("retry_after_s", 1.0)))))
        self.end_headers()
        self.wfile.write(data)

    def _reply_text(self, status: int, text: str,
                    content_type: str) -> None:
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _request_trace_id(self) -> str:
        """Propagate the client's ``X-Repro-Trace-Id`` or mint one.

        The inbound value is sanitized and bounded so a hostile header
        can't smuggle bytes into responses or metrics.
        """
        raw = self.headers.get("X-Repro-Trace-Id", "")
        cleaned = _TRACE_ID_RE.sub("", raw)[:64]
        return cleaned or _telemetry.new_trace_id()

    def do_GET(self) -> None:               # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/status":
            self._reply(200, self.service.status())
        elif self.path == "/metrics":
            self._reply_text(200, self.service.metrics_text(),
                             "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/schema":
            self._reply(200, {"ok": True, "kinds": list(JOB_KINDS),
                              "workload_defaults": describe_defaults()})
        else:
            self._reply(404, {"ok": False,
                              "error": f"no such endpoint {self.path!r}",
                              "error_kind": "not-found"})

    def do_POST(self) -> None:              # noqa: N802 — http.server API
        trace_id = self._request_trace_id()
        if self.path != "/v1/jobs":
            self._reply(404, {"ok": False,
                              "error": f"no such endpoint {self.path!r}",
                              "error_kind": "not-found"}, trace_id)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"null")
        except (ValueError, OSError) as exc:
            self._reply(400, {"ok": False,
                              "error": f"unreadable JSON body: {exc}",
                              "error_kind": "invalid-job",
                              "trace_id": trace_id}, trace_id)
            return
        status, body = self.service.handle(payload, trace_id=trace_id)
        body.setdefault("trace_id", trace_id)
        self._reply(status, body, body.get("trace_id", trace_id))


def make_http_server(service: ProfilingService,
                     host: Optional[str] = None,
                     port: Optional[int] = None) -> ThreadingHTTPServer:
    """Bind (but don't run) the HTTP front end; ``.server_address`` has
    the resolved ephemeral port when ``port=0``."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer(
        (service.config.host if host is None else host,
         service.config.port if port is None else port), handler)
    server.daemon_threads = True
    return server


def serve(config: Optional[ServiceConfig] = None, *,
          port_file: Optional[str] = None,
          ready: Optional[threading.Event] = None) -> None:
    """Run the daemon until interrupted (the ``python -m repro_torch
    serve`` body).

    Prints one ``repro-serve: listening on http://host:port`` line (and
    optionally writes the bound port to ``port_file``) so scripts — and
    the CI smoke test — can target an ephemeral port.
    """
    service = ProfilingService(config).start()
    server = make_http_server(service)
    host, port = server.server_address[:2]
    if port_file:
        with open(port_file, "w") as fh:
            fh.write(str(port))
    print(f"repro-serve: listening on http://{host}:{port} "
          f"(workers={service.config.workers}, "
          f"queue={service.config.queue_depth}, "
          f"provider={service.provider.name}, "
          f"torch_device={service.config.torch_device})", flush=True)
    if ready is not None:
        ready.set()
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()
