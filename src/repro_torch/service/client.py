"""Minimal stdlib HTTP client for the profiling service.

``ServiceClient`` speaks the daemon's JSON contract over
``urllib.request`` (no third-party dependency): ``health``/``status``
GETs plus ``submit`` for jobs, with optional bounded retry on 429 that
honors the server's ``Retry-After``.  Every non-2xx response surfaces as
``ServiceError`` carrying the HTTP status and the decoded error body, so
callers (the ``python -m repro_torch client`` CLI, tests,
``chip_smoke.py``) branch on ``exc.status`` instead of parsing strings.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional


class ServiceError(RuntimeError):
    """A non-2xx service response (or no response at all)."""

    def __init__(self, message: str, status: Optional[int] = None,
                 body: Optional[dict] = None) -> None:
        super().__init__(message)
        self.status = status
        self.body = body or {}


class ServiceClient:
    """One service endpoint (host, port) as a Python object."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8642, *,
                 timeout_s: float = 60.0,
                 sleep=time.sleep) -> None:
        if not 1 <= port <= 65535:
            raise ValueError(f"port must be in [1, 65535], got {port}")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.base_url = f"http://{host}:{port}"
        self.timeout_s = timeout_s
        self._sleep = sleep

    # -- transport --------------------------------------------------------

    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        url = self.base_url + path
        data = None
        headers = {"Accept": "application/json"}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as exc:
            try:
                body = json.loads(exc.read() or b"{}")
            except ValueError:
                body = {}
            retry_after = exc.headers.get("Retry-After")
            if retry_after is not None:
                body.setdefault("retry_after_s", float(retry_after))
            raise ServiceError(
                body.get("error", f"HTTP {exc.code} from {url}"),
                status=exc.code, body=body) from None
        except (urllib.error.URLError, ConnectionError, OSError) as exc:
            raise ServiceError(
                f"service unreachable at {url}: {exc}") from None

    # -- endpoints --------------------------------------------------------

    def health(self) -> dict:
        return self._request("/healthz")

    def status(self) -> dict:
        return self._request("/status")

    def schema(self) -> dict:
        return self._request("/schema")

    def submit(self, payload: dict, *, retries_on_busy: int = 0) -> dict:
        """POST one job; optionally retry 429s honoring Retry-After.

        Only overload (429) is retried — a 400 payload will not become
        valid and a 503/504 already exhausted the server's own retries.
        """
        if retries_on_busy < 0:
            raise ValueError(
                f"retries_on_busy must be >= 0, got {retries_on_busy}")
        for attempt in range(retries_on_busy + 1):
            try:
                return self._request("/v1/jobs", payload)
            except ServiceError as exc:
                if exc.status != 429 or attempt == retries_on_busy:
                    raise
                self._sleep(float(exc.body.get("retry_after_s", 1.0)))
        raise AssertionError("unreachable")
