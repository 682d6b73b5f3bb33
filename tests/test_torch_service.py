"""The port's profiling service: job schema, daemon contract, chaos.

The counterparts of ``tests/test_service.py``, run on ``repro_torch``
(``BAD_JOBS`` and ``SERVE_REJECTS`` copied): (a) ``parse_job`` rejects
malformed payloads up front with the reference's messages and expands
valid ones to the specs the CLI would build, (b) the daemon answers
every request with a result, an explicitly-degraded result naming its
fallback provider, or a typed 4xx/5xx JSON error — never a bare 500 and
never a hang — shedding overload as 429 + Retry-After, (c) a warm
resubmission of an entire mixed burst performs zero provider
collections, even with a concurrently SIGKILLed ``python -m repro_torch
sweep`` sharing the cache, and (d) the ``SweepCache`` quarantines
corrupt entries and survives its root being deleted.

Then both packages side by side: one sequential job list under the same
fault schedule gives the same statuses, degraded flags, fallback names,
result payloads, counters and fault stats (integers and verdicts bit for
bit, floats within rtol 1e-9; ``elapsed_s``, ``trace_id`` and ``spans``
excluded), and each package's client reads the other's server alike.
Last, the kernel provider: every ``"kernel"`` the service names runs on
its ``torch_device`` (here ``cpu``, the kernels' plain versions), and
``start()`` builds nothing there — nor falls back without a card.
"""

import gzip
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _port_compare import assert_json_close
from repro.cli import main as ref_cli_main
from repro.service import ProfilingService as RefService
from repro.service import ServiceClient as RefClient
from repro.service import ServiceConfig as RefConfig
from repro.service.server import make_http_server as ref_make_http_server
from repro_torch.analysis import (SweepCache, WorkloadSpec, get_device,
                                  get_provider)
from repro_torch.analysis.providers import InstrumentedKernelProvider
from repro_torch.cli import main as cli_main
from repro_torch.kernels import _build
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.service import (
    JobError,
    ProfilingService,
    ServiceClient,
    ServiceConfig,
    ServiceError,
    parse_job,
)
from repro_torch.service.jobs import mixed_burst
from repro_torch.service.server import make_http_server

REPO = os.path.join(os.path.dirname(__file__), "..")
DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(autouse=True)
def _isolate_results(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "results"))
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "ref-results"))
    yield


def _payload(kind="profile", **workload):
    workload.setdefault("workload", "indices")
    workload.setdefault("size", 1024)
    return {"kind": kind, "workload": workload}


@pytest.fixture
def service():
    svc = ProfilingService(ServiceConfig(
        workers=2, queue_depth=8, timeout_s=30.0,
        retries=1, backoff_base_s=0.001)).start()
    yield svc
    svc.stop()


# -- job schema ---------------------------------------------------------------


BAD_JOBS = [
    ([1, 2], "must be a JSON object"),
    ({"kind": "profile"}, "needs a 'workload' object"),
    ({"kind": "melt", "workload": {}}, "kind must be one of"),
    ({"kind": "profile", "workload": {}, "extra": 1}, "unknown job key"),
    ({"kind": "profile", "device": "", "workload": {}},
     "device must be a non-empty string"),
    ({"kind": "profile", "workload": {}, "timeout_s": 0}, "timeout_s"),
    ({"kind": "profile", "workload": {}, "timeout_s": 1e9},
     "timeout_s must be <="),
    ({"kind": "profile", "workload": {"bogus": 1}}, "unknown workload key"),
    ({"kind": "profile", "workload": {"size": 0}}, "size must be >= 1"),
    ({"kind": "profile", "workload": {"size": "big"}},
     "size must be a finite number"),
    ({"kind": "profile", "workload": {"size": []}},
     "size must not be an empty list"),
    ({"kind": "profile", "workload": {"size": 2.5}},
     "size must be an integer"),
    ({"kind": "profile", "workload": {"dist": "zipf"}}, "unknown dist"),
    ({"kind": "profile", "workload": {"variant": "hist9"}},
     "unknown variant"),
    ({"kind": "profile", "workload": {"workload": "fft"}},
     "unknown workload family"),
    ({"kind": "profile", "workload": {"workload": "hlo"}},
     "invalid workload: --workload hlo needs --hlo-file PATH"),
    ({"kind": "profile", "workload": {"size": [1024, 2048]}},
     "exactly one workload point"),
    ({"kind": "advise", "workload": {"waves_per_tile": [2, 4]}},
     "exactly one workload point"),
    ({"kind": "profile", "workload": {}, "options": {"depth": 2}},
     "unknown option"),
    ({"kind": "advise", "workload": {}, "options": {"depth": 0}},
     "depth must be >= 1"),
    ({"kind": "sweep", "workload": {}, "options": {"parallel": 0}},
     "parallel must be >= 1"),
    ({"kind": "validate", "workload": {},
      "options": {"providers": ["trace"]}}, "list of >= 2"),
]


# an id stops at the message's first colon
@pytest.mark.parametrize("payload,match", BAD_JOBS,
                         ids=[m.split(":")[0][:28] for _, m in BAD_JOBS])
def test_parse_job_rejects(payload, match):
    with pytest.raises(JobError, match=match.replace("(", "\\(")):
        parse_job(payload)


def test_parse_job_expands_the_cli_grid():
    job = parse_job({"kind": "sweep",
                     "workload": {"workload": "indices",
                                  "size": [1024, 2048], "dist": "solid",
                                  "waves_per_tile": [2, 4, 8]}})
    assert len(job.specs) == 6
    assert job.timeout_s == 30.0          # the default rides along
    assert sorted({s.waves_per_tile for s in job.specs}) == [2, 4, 8]
    # content matches what the CLI's builder makes for the same flags
    assert job.specs[0].label.startswith("solid-")


def test_parse_job_sweep_cap_is_enforced_before_synthesis():
    with pytest.raises(JobError, match="over the\nservice cap"
                       .replace("\n", " ")):
        parse_job({"kind": "sweep",
                   "workload": {"size": [1024] * 3,
                                "waves_per_tile": list(range(2, 6)),
                                "pipeline_depth": [1, 2]}},
                  max_points=10)


def test_parse_job_fills_kind_defaults():
    job = parse_job({"kind": "advise", "workload": {"size": 512}})
    assert job.options == {"depth": 2, "beam_width": 8, "top_k": 5,
                           "validate_top": 0}
    job = parse_job({"kind": "validate", "workload": {"size": 512}})
    assert job.options["providers"] == ["trace", "kernel"]


# -- the daemon contract ------------------------------------------------------


def test_profile_sweep_validate_roundtrip(service):
    st, body = service.handle(_payload("profile", dist="solid"))
    assert st == 200 and body["ok"] and not body["degraded"]
    assert body["result"]["points"][0]["bottleneck"]

    st, body = service.handle(_payload("sweep", waves_per_tile=[2, 4, 8]))
    assert st == 200 and len(body["result"]["points"]) == 3

    st, body = service.handle(
        {"kind": "validate", "workload": {"size": 512},
         "options": {"providers": ["trace", "trace"]}})
    assert st == 200
    assert body["result"]["comparisons"][1]["rel_err"]["e"] == 0.0


def test_advise_roundtrip(service):
    st, body = service.handle(
        {"kind": "advise", "workload": {"size": 1024, "dist": "solid"},
         "options": {"depth": 1, "beam_width": 2, "top_k": 2}})
    assert st == 200 and body["ok"]
    assert body["result"]["candidates"]


def test_warm_resubmission_collects_nothing(service):
    payload = _payload("sweep", dist="solid", waves_per_tile=[2, 4])
    st, _ = service.handle(payload)
    assert st == 200
    before = service.session("v5e").stats_snapshot()
    st, _ = service.handle(payload)
    assert st == 200
    after = service.session("v5e").stats_snapshot()
    assert after["batch_calls"] == before["batch_calls"]
    assert after["collected"] == before["collected"]


def test_malformed_payloads_are_400_never_500(service):
    for payload in (None, [], {"kind": "melt", "workload": {}},
                    {"kind": "profile", "workload": {"size": -1}}):
        st, body = service.handle(payload)
        assert st == 400 and not body["ok"]
        assert body["error_kind"] == "invalid-job"
    assert service.counters["invalid"] == 4


def test_degraded_responses_name_their_fallback(tmp_path):
    svc = ProfilingService(ServiceConfig(
        workers=2, fault_rate=1.0, retries=1,
        backoff_base_s=0.001)).start()
    try:
        st, body = svc.handle(_payload("profile"))
        assert st == 200 and body["ok"]
        assert body["degraded"] and body["fallback_providers"] == ["trace"]
        # the per-point meta stamp survives into the report payload
        meta = body["result"]["meta"]
        assert all(m["degraded"] and m["fallback_provider"] == "trace"
                   for m in meta.values())
        assert svc.counters["degraded"] == 1
    finally:
        svc.stop()


class _GatedProvider:
    """Blocks every collect on an event (queue-shedding fodder)."""

    name = "trace"

    def __init__(self, gate, entered=None):
        self.gate = gate
        self.entered = entered or threading.Event()
        self.inner = get_provider("trace")

    def collect(self, spec, device):
        self.entered.set()
        assert self.gate.wait(30)
        return self.inner.collect(spec, device)


def test_queue_full_sheds_with_429_and_retry_after():
    gate = threading.Event()
    entered = threading.Event()
    svc = ProfilingService(ServiceConfig(
        workers=1, queue_depth=1, timeout_s=30.0,
        call_timeout_s=60.0, provider=_GatedProvider(gate, entered),
        fallbacks=())).start()
    results = []

    def submit(seed):
        results.append(svc.handle(_payload("profile", seed=seed)))

    try:
        t1 = threading.Thread(target=submit, args=(1,))
        t1.start()
        # the worker signals from inside collect, so job 1 is provably
        # off the queue (polling qsize here races: it reads 0 before
        # the submitter thread has even enqueued the ticket)
        assert entered.wait(10)
        t2 = threading.Thread(target=submit, args=(2,))
        t2.start()
        # job 2 now fills the single queue slot behind the blocked worker
        deadline = time.monotonic() + 10
        while svc._queue.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc._queue.qsize() == 1
        st, body = svc.handle(_payload("profile", seed=3))  # queue full
        assert st == 429
        assert body["error_kind"] == "overloaded"
        assert body["retry_after_s"] > 0
        gate.set()
        t1.join(30)
        t2.join(30)
        assert [st for st, _ in results] == [200, 200]
        assert svc.counters["shed"] == 1
    finally:
        gate.set()
        svc.stop()


def test_unstarted_service_refuses_cleanly(service):
    svc = ProfilingService(ServiceConfig(workers=1))
    st, body = svc.handle(_payload())
    assert st == 503 and "not started" in body["error"]


def test_service_config_validates():
    with pytest.raises(ValueError):
        ServiceConfig(workers=0)
    with pytest.raises(ValueError):
        ServiceConfig(queue_depth=0)
    with pytest.raises(ValueError):
        ServiceConfig(timeout_s=50.0, max_timeout_s=10.0)
    with pytest.raises(ValueError):
        ServiceConfig(retries=-1)


# -- HTTP + client ------------------------------------------------------------


@pytest.fixture
def http_service(service):
    server = make_http_server(service, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield service, server.server_address[1]
    server.shutdown()
    server.server_close()


def test_http_endpoints(http_service):
    _, port = http_service
    client = ServiceClient("127.0.0.1", port, timeout_s=30)
    assert client.health() == {"ok": True}
    assert "workload_defaults" in client.schema()
    body = client.submit(_payload("profile", dist="solid"))
    assert body["ok"] and body["result"]["points"]
    status = client.status()
    assert status["counters"]["completed"] >= 1
    assert "trace" in status["breakers"]
    assert status["sessions"]["v5e"]["collected"] >= 1


def test_http_error_statuses(http_service):
    _, port = http_service
    client = ServiceClient("127.0.0.1", port, timeout_s=30)
    with pytest.raises(ServiceError) as ei:
        client.submit({"kind": "melt", "workload": {}})
    assert ei.value.status == 400
    assert ei.value.body["error_kind"] == "invalid-job"
    with pytest.raises(ServiceError) as ei:
        client._request("/nope")
    assert ei.value.status == 404
    # a connection refusal is a typed error too, not a raw socket trace
    dead = ServiceClient("127.0.0.1", 1, timeout_s=2)
    with pytest.raises(ServiceError) as ei:
        dead.health()
    assert ei.value.status is None


def test_http_rejects_unreadable_json(http_service):
    import urllib.error
    import urllib.request
    _, port = http_service
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/jobs", data=b"{not json",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_client_validates_and_retries_on_busy(monkeypatch):
    with pytest.raises(ValueError):
        ServiceClient(port=0)
    with pytest.raises(ValueError):
        ServiceClient(timeout_s=0)
    slept = []
    client = ServiceClient(port=8642, sleep=slept.append)
    calls = []

    def fake_request(path, payload=None):
        calls.append(path)
        if len(calls) < 3:
            raise ServiceError("busy", status=429,
                               body={"retry_after_s": 0.25})
        return {"ok": True}

    monkeypatch.setattr(client, "_request", fake_request)
    assert client.submit({"kind": "profile"}, retries_on_busy=3)["ok"]
    assert slept == [0.25, 0.25]          # Retry-After honored
    calls.clear()
    with pytest.raises(ServiceError):
        client.submit({"kind": "profile"}, retries_on_busy=1)
    assert len(calls) == 2                # bounded retries
    with pytest.raises(ValueError):
        client.submit({}, retries_on_busy=-1)


# -- chaos acceptance ---------------------------------------------------------


def test_mixed_burst_is_the_reference_tests_burst():
    """The port's load generator, at its defaults, draws the reference
    chaos test's job list (so the burst below is the reference's)."""
    import test_service as ref_tests

    assert mixed_burst(200, np.random.default_rng(0)) == \
        ref_tests._mixed_burst(200, np.random.default_rng(0))


def _wait_for_first_write(proc, root, timeout_s=20.0):
    """Until ``proc`` has put a cache entry or a tmp file under ``root``,
    exited, or ``timeout_s`` passed."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and proc.poll() is None:
        if root.is_dir() and any(p.suffix in (".npz", ".tmp")
                                 for p in root.iterdir()):
            return
        time.sleep(0.02)


def test_chaos_acceptance(tmp_path):
    """The PR's acceptance bar: a 200-job mixed burst against a daemon
    with 20% injected faults, with a concurrently SIGKILLed writer
    sharing the cache — every response is 200-with-result or explicitly
    degraded (naming its fallback), the cache holds zero corrupt
    entries, and a warm resubmission of the entire burst performs zero
    provider collections."""
    # retries=0 so an injected fault degrades immediately (with retries
    # a 20% per-call rate is almost always absorbed before the fallback,
    # and the burst would assert on a near-zero degradation count)
    svc = ProfilingService(ServiceConfig(
        workers=4, queue_depth=256, timeout_s=60.0, max_timeout_s=120.0,
        retries=0, breaker_threshold=10 ** 6,
        fault_rate=0.2, corrupt_rate=0.05, fault_seed=42)).start()
    jobs = mixed_burst(200, np.random.default_rng(0))

    # the doomed writer: a sharded CLI sweep into the same cache root,
    # SIGKILLed mid-run — its half-written tmp files must never surface
    # as cache entries (atomic tmp+rename)
    env = {**os.environ,
           "REPRO_TORCH_RESULTS": os.environ["REPRO_TORCH_RESULTS"],
           "PYTHONPATH": os.path.join(REPO, "src")}
    victim = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "sweep", "--workload",
         "indices",
         "--size", "2^14", "2^15", "--dist", "uniform",
         "--waves-per-tile", "2", "3", "4", "5", "6", "7",
         "--jobs", "1", "--no-artifact"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = [pool.submit(svc.handle, j) for j in jobs]
            # the victim pays for `import torch` before it collects: kill
            # it once its first entry (or tmp file) is on disk
            _wait_for_first_write(victim, svc.cache.root)
            if victim.poll() is None:
                victim.send_signal(signal.SIGKILL)
            results = [f.result(timeout=120) for f in futures]
        victim.wait(30)

        # contract: every response is a 200 result; degraded ones name
        # their fallback; nothing is a 5xx and nothing hung
        assert [st for st, _ in results] == [200] * len(jobs)
        degraded = [b for _, b in results if b["degraded"]]
        assert degraded, "20% fault injection produced no degradations"
        assert all(b["fallback_providers"] for b in degraded)
        assert svc.counters["failed"] == 0
        assert svc.fault.stats_snapshot()["faults"] > 0

        # zero corrupt cache entries, even with the SIGKILLed writer
        entries = list(svc.cache.iter_entries())
        assert all(cset is not None for _, cset in entries)
        assert svc.cache.stats()["quarantined"] == 0

        # warm resubmission: the whole burst again, zero collections
        before = svc.session("v5e").stats_snapshot()
        with ThreadPoolExecutor(max_workers=8) as pool:
            warm = [f.result(timeout=120) for f in
                    [pool.submit(svc.handle, j) for j in jobs
                     if j["kind"] in ("profile", "sweep")]]
        assert all(st == 200 for st, _ in warm)
        after = svc.session("v5e").stats_snapshot()
        assert after["batch_calls"] == before["batch_calls"]
        assert after["collected"] == before["collected"]
    finally:
        if victim.poll() is None:
            victim.kill()
        svc.stop()


# -- SweepCache robustness (quarantine + vanished root) -----------------------


def _fill_cache(cache, n=3):
    spec = WorkloadSpec.from_indices(
        np.random.default_rng(0).integers(0, 256, 512), 256,
        label="seed", waves_per_tile=2)
    cset = get_provider("trace").collect(spec, get_device("v5e"))
    keys = [f"{i:032x}" for i in range(n)]
    for k in keys:
        cache.put(k, cset)
    return keys


def test_corrupt_entry_quarantined_then_pruned(tmp_path):
    cache = SweepCache()
    keys = _fill_cache(cache, 2)
    cache.path(keys[0]).write_bytes(b"not an npz at all")
    assert cache.get(keys[0]) is None     # miss, not a crash
    assert not cache.path(keys[0]).exists()   # moved aside
    stats = cache.stats()
    assert stats["quarantined"] == 1 and stats["entries"] == 1
    assert cache.get_many(keys) and keys[0] not in cache.get_many(keys)
    # a later write under the same key is a fresh, readable entry
    _fill_cache(cache, 1)
    assert cache.get(keys[0]) is not None
    removed, freed = cache.prune()
    assert removed == 1 and freed > 0     # the quarantined file
    assert cache.stats()["quarantined"] == 0


def test_prune_clears_orphaned_tmp_files(tmp_path):
    cache = SweepCache()
    _fill_cache(cache, 1)
    (cache.root / "deadbeef.tmp").write_bytes(b"half-written")
    removed, _ = cache.prune()
    assert removed == 1
    assert not list(cache.root.glob("*.tmp"))
    assert len(cache) == 1                # the live entry survives


def test_cache_root_deleted_out_from_under_running_session(tmp_path):
    cache = SweepCache()
    _fill_cache(cache, 3)
    assert len(cache) == 3
    shutil.rmtree(cache.root)
    # every maintenance surface reads the vanished root as empty
    assert cache.stats()["entries"] == 0
    assert cache.stats()["quarantined"] == 0
    assert cache.prune(0) == (0, 0)
    assert cache.clear() == 0
    assert len(cache) == 0
    assert cache.get("0" * 32) is None
    assert list(cache.iter_entries()) == []


def test_concurrent_clear_mid_iteration(tmp_path):
    """A clear() racing an iter_entries()/stats() scan from another
    thread: the scan may see fewer entries, never an exception."""
    cache = SweepCache()
    _fill_cache(cache, 40)
    it = cache.iter_entries()
    first = next(it)
    assert first[1] is not None
    cleared = {}

    def clear():
        cleared["n"] = cache.clear()

    t = threading.Thread(target=clear)
    t.start()
    survivors = [e for e in it]           # must not raise mid-race
    t.join()
    assert cleared["n"] <= 40
    assert len(survivors) <= 39
    assert cache.stats()["entries"] == 0


def test_cache_cli_reports_quarantined(tmp_path, capsys):
    cache = SweepCache()
    keys = _fill_cache(cache, 2)
    cache.path(keys[0]).write_bytes(b"garbage")
    assert cache.get(keys[0]) is None     # quarantines
    rc = cli_main(["cache", "stats"])
    out = capsys.readouterr().out
    assert rc == 0 and "1 quarantined corrupt file(s)" in out
    rc = cli_main(["cache", "stats", "--format", "json"])
    assert json.loads(capsys.readouterr().out)["quarantined"] == 1
    rc = cli_main(["cache", "prune", "--max-bytes", "10^9"])
    assert rc == 0 and "pruned 1" in capsys.readouterr().out
    rc = cli_main(["cache", "stats", "--format", "json"])
    assert json.loads(capsys.readouterr().out)["quarantined"] == 0


# -- serve/client argparse rejection matrix -----------------------------------


SERVE_REJECTS = [
    ["serve", "--port", "99999"],
    ["serve", "--port", "-1"],
    ["serve", "--workers", "0"],
    ["serve", "--queue-depth", "0"],
    ["serve", "--timeout", "0"],
    ["serve", "--timeout", "nan"],
    ["serve", "--timeout", "50", "--max-timeout", "10"],
    ["serve", "--call-timeout", "500", "--max-timeout", "300"],
    ["serve", "--retries", "-1"],
    ["serve", "--backoff-base", "0"],
    ["serve", "--breaker-threshold", "0"],
    ["serve", "--breaker-cooldown", "-1"],
    ["serve", "--fault-rate", "1.5"],
    ["serve", "--fault-rate", "-0.1"],
    ["serve", "--corrupt-rate", "2"],
    ["serve", "--latency-s", "0"],
    ["serve", "--fault-seed", "-1"],
    ["serve", "--max-points", "0"],
    ["client", "health", "--port", "0"],
    ["client", "health", "--port", "70000"],
    ["client", "submit"],
    ["client", "submit", "--job", "{}", "--job-file", "x.json"],
    ["client", "health", "--job", "{}"],
    ["client", "submit", "--job", "{}", "--retries-on-busy", "-1"],
    ["client", "status", "--timeout", "0"],
]


@pytest.mark.parametrize("argv", SERVE_REJECTS,
                         ids=[" ".join(a[1:])[:40] for a in SERVE_REJECTS])
def test_serve_client_flag_rejection_matrix(argv):
    with pytest.raises(SystemExit) as ei:
        cli_main(argv)
    assert ei.value.code == 2             # argparse rejection, no work done
    with pytest.raises(SystemExit) as ref:
        ref_cli_main(argv)
    assert ref.value.code == ei.value.code


# -- both packages side by side -----------------------------------------------


VOLATILE = ("elapsed_s", "trace_id", "spans")


def _stable(body):
    return {k: v for k, v in body.items() if k not in VOLATILE}


def _sequential_jobs():
    """One job list mixing every kind, each point a distinct stream."""
    jobs = mixed_burst(40, np.random.default_rng(3))
    jobs.insert(5, {"kind": "heatmap",
                    "workload": {"workload": "histogram", "pixels": 4096,
                                 "dist": "solid"},
                    "options": {"top_k": 4}})
    jobs.insert(9, {"kind": "sweep",
                    "workload": {"workload": "histogram",
                                 "pixels": [1024, 4096], "dist": "solid",
                                 "variant": "hist2",
                                 "waves_per_tile": [8, 32]},
                    "options": {"parallel": 1}})
    jobs.insert(13, {"kind": "profile",
                     "workload": {"workload": "scatter", "size": 2048,
                                  "dist": "uniform", "num_segments": 64}})
    # a malformed job and a repeat (memo hit) ride along
    jobs.insert(17, {"kind": "profile", "workload": {"size": -1}})
    jobs.append(dict(jobs[0]))
    return jobs


def test_sequential_chaos_equals_reference():
    """One worker, one job at a time, the chaos test's fault config: the
    fault schedule is drawn in the same call order in both packages, so
    every response, the counters and the fault stats must be equal."""
    kw = dict(workers=1, queue_depth=8, timeout_s=60.0, retries=0,
              breaker_threshold=10 ** 6, fault_rate=0.2, corrupt_rate=0.05,
              fault_seed=42)
    port = ProfilingService(ServiceConfig(**kw)).start()
    ref = RefService(RefConfig(**kw)).start()
    try:
        for job in _sequential_jobs():
            (st, got), (st_ref, want) = port.handle(job), ref.handle(job)
            assert st == st_ref, (job, got, want)
            assert_json_close(_stable(got), _stable(want))
        assert port.counters == ref.counters
        assert port.fault.stats_snapshot() == ref.fault.stats_snapshot()
        assert port.counters["degraded"] > 0
        assert port.counters["invalid"] == 1
        assert port.fault.stats_snapshot()["faults"] > 0
        states = port.provider.breaker_states()
        assert states == ref.provider.breaker_states()
        assert port.session("v5e").stats_snapshot() == \
            ref.session("v5e").stats_snapshot()
    finally:
        port.stop()
        ref.stop()


def test_hlo_job_with_a_file_equals_reference(tmp_path):
    """An ``hlo`` job with its file, to a daemon whose primary is the
    ``hlo`` provider: the same 200 body as the reference's; without the
    file, the same 400; to a trace-primary daemon, the same 503."""
    path = tmp_path / "granite.hlo"
    path.write_bytes(gzip.decompress(
        (DATA / "granite_moe_1b_a400m__decode.hlo.gz").read_bytes()))
    kw = dict(workers=1, queue_depth=4, timeout_s=60.0, provider="hlo",
              fallbacks=())
    port = ProfilingService(ServiceConfig(**kw)).start()
    ref = RefService(RefConfig(**kw)).start()
    try:
        for job in ({"kind": "profile",
                     "workload": {"workload": "hlo", "hlo_file": str(path)}},
                    {"kind": "sweep",
                     "workload": {"workload": "hlo", "hlo_file": str(path),
                                  "num_devices": 4}},
                    {"kind": "profile", "workload": {"workload": "hlo"}}):
            (st, got), (st_ref, want) = port.handle(job), ref.handle(job)
            assert st == st_ref, (job, got, want)
            assert_json_close(_stable(got), _stable(want))
        assert st == 400 and got["error"] == (
            "invalid workload: --workload hlo needs --hlo-file PATH")
        assert port.counters == ref.counters
        assert port.counters["invalid"] == 1
    finally:
        port.stop()
        ref.stop()
    # a trace-primary daemon cannot answer it: the same 503 from both
    kw.update(provider="trace", fallbacks=("trace",), retries=0)
    port = ProfilingService(ServiceConfig(**kw)).start()
    ref = RefService(RefConfig(**kw)).start()
    try:
        job = {"kind": "profile",
               "workload": {"workload": "hlo", "hlo_file": str(path)}}
        (st, got), (st_ref, want) = port.handle(job), ref.handle(job)
        assert st == st_ref == 503 and _stable(got) == _stable(want)
        assert "collect them with the 'hlo' provider" in got["error"]
    finally:
        port.stop()
        ref.stop()


def _serve_http(service):
    server = (make_http_server if isinstance(service, ProfilingService)
              else ref_make_http_server)(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def test_clients_and_servers_interchange():
    """The reference's client against the port's server and the port's
    client against the reference's: the same bodies either way."""
    services = (ProfilingService(ServiceConfig(workers=1)).start(),
                RefService(RefConfig(workers=1)).start())
    servers = [_serve_http(svc) for svc in services]
    try:
        port_port, ref_port = (srv.server_address[1] for srv in servers)
        pairs = ((RefClient("127.0.0.1", port_port, timeout_s=30),
                  ServiceClient("127.0.0.1", ref_port, timeout_s=30)),
                 (ServiceClient("127.0.0.1", port_port, timeout_s=30),
                  RefClient("127.0.0.1", ref_port, timeout_s=30)))
        job = _payload("profile", dist="solid", waves_per_tile=8)
        for on_port, on_ref in pairs:
            assert on_port.health() == on_ref.health() == {"ok": True}
            assert on_port.schema() == on_ref.schema()
            assert_json_close(_stable(on_port.submit(job)),
                              _stable(on_ref.submit(job)))
            bad = {"kind": "melt", "workload": {}}
            with pytest.raises(Exception) as got:
                on_port.submit(bad)
            with pytest.raises(Exception) as want:
                on_ref.submit(bad)
            assert (got.value.status, got.value.body["error"]) == \
                (want.value.status, want.value.body["error"])
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for svc in services:
            svc.stop()


# -- the kernel provider on the service's torch device ------------------------


def _kernel_service(**kw):
    return ProfilingService(ServiceConfig(
        provider="kernel", fallbacks=("trace",), torch_device="cpu",
        workers=2, **kw))


def test_every_kernel_resolves_to_the_services_provider(monkeypatch):
    """Primary, fallback, a validate job's providers and an advise job's
    validation: each is the service's one ``InstrumentedKernelProvider``
    on its ``torch_device``, never the registered instance (which runs
    on cuda whatever was asked)."""
    registered = get_provider("kernel")
    monkeypatch.setattr(type(registered), "collect",
                        lambda *a: pytest.fail("registered kernel ran"))
    svc = ProfilingService(ServiceConfig(
        provider="trace", fallbacks=("kernel",), torch_device="cpu"))
    assert svc.provider.fallbacks == [svc.kernel]
    svc = _kernel_service()
    assert isinstance(svc.kernel, InstrumentedKernelProvider)
    assert svc.kernel is not registered
    assert svc.kernel.torch_device == "cpu"
    assert svc.provider.primary is svc.kernel
    monkeypatch.undo()
    with svc:
        st, body = svc.handle(
            {"kind": "advise",
             "workload": {"workload": "histogram", "pixels": 4096,
                          "dist": "solid"},
             "options": {"depth": 1, "validate_top": 1, "top_k": 1}})
        assert st == 200 and not body["degraded"], body
        assert body["result"]["candidates"][0]["validation_e_rel_err"] == 0.0


def test_a_daemon_without_the_kernel_refuses_kernel_jobs(monkeypatch):
    """A daemon whose chain holds no ``kernel`` has checked no card and
    loaded nothing: a ``validate`` job through the kernel (its default
    providers) and an ``advise`` job with ``validate_top`` are 400s, up
    front, and the kernel provider never runs; other jobs are served."""
    svc = ProfilingService(ServiceConfig(workers=1))
    assert (svc.config.provider, svc.config.torch_device) == \
        ("trace", "cuda")
    monkeypatch.setattr(svc.kernel, "collect",
                        lambda *a: pytest.fail("the kernel ran"))
    refused = ({"kind": "validate", "workload": {"size": 512}},
               {"kind": "validate", "workload": {"size": 512},
                "options": {"providers": ["kernel", "trace"]}},
               {"kind": "advise", "workload": {"size": 512},
                "options": {"depth": 1, "validate_top": 1}})
    with svc:
        for job in refused:
            st, body = svc.handle(job)
            assert st == 400 and body["error_kind"] == "invalid-job", body
            assert body["error"].endswith(
                "needs a daemon with 'kernel' as its provider or a "
                "fallback; this one runs 'trace' with fallbacks []"), \
                body["error"]
        st, body = svc.handle(
            {"kind": "validate", "workload": {"size": 512},
             "options": {"providers": ["trace", "trace"]}})
        assert st == 200 and not body["degraded"]
        st, body = svc.handle(
            {"kind": "advise", "workload": {"size": 512},
             "options": {"depth": 1, "top_k": 1}})
        assert st == 200
    assert svc.counters["invalid"] == len(refused)
    assert svc.counters["submitted"] == 2


@pytest.mark.parametrize("variant", ["hist", "hist2"])
@pytest.mark.parametrize("dist", ["solid", "uniform"])
def test_validate_job_through_the_kernel_on_the_cpu(dist, variant):
    with _kernel_service() as svc:
        st, body = svc.handle(
            {"kind": "validate",
             "workload": {"workload": "histogram", "pixels": 4096,
                          "dist": dist, "variant": variant,
                          "waves_per_tile": 32}})
        assert st == 200, body
        assert not body["degraded"] and body["fallback_providers"] == []
        ref, measured = body["result"]["comparisons"]
        assert (ref["provider"], measured["provider"]) == ("trace", "kernel")
        assert all(v == 0.0 for v in measured["rel_err"].values())
        assert [c["batch_bitwise_equal"]
                for c in body["result"]["comparisons"]] == [True, True]
        assert all(b["state"] == "closed"
                   for b in svc.provider.breaker_states().values())


def test_profile_jobs_through_the_kernel_equal_trace():
    """K3 (histogram) and K6 (indices) jobs on the kernel primary give
    the trace provider's report, undegraded, and launch nothing on the
    CPU (only a card's launches count)."""
    jobs = [{"kind": "profile",
             "workload": {"workload": "indices", "size": 8192,
                          "dist": dist, "num_bins": 4096,
                          "waves_per_tile": 32}}
            for dist in ("solid", "uniform")]
    jobs.append({"kind": "sweep",
                 "workload": {"workload": "histogram",
                              "pixels": [1024, 4096], "dist": "solid",
                              "waves_per_tile": [8, 32]}})
    before = dict(hk.LAUNCHES), dict(sk.LAUNCHES)
    with _kernel_service() as svc, ProfilingService(ServiceConfig(
            persistent_cache=False)).start() as trace:
        for job in jobs:
            (st, got), (st_t, want) = svc.handle(job), trace.handle(job)
            assert st == st_t == 200 and not got["degraded"]
            got, want = got["result"], want["result"]
            got.pop("meta", None)
            want.pop("meta", None)
            assert_json_close(got, want)
        # warm: the sweep again collects nothing
        stats = svc.session("v5e").stats_snapshot()
        assert svc.handle(jobs[-1])[0] == 200
        assert svc.session("v5e").stats_snapshot()["collected"] == \
            stats["collected"]
    assert (hk.LAUNCHES, sk.LAUNCHES) == before


def test_start_on_the_cpu_builds_and_loads_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: calls.append(name))
    monkeypatch.setattr(_build, "build_all", lambda: calls.append("all"))
    libs = dict(_build._LIBS)
    with _kernel_service() as svc:
        assert svc.handle(_payload("profile", size=2048))[0] == 200
    assert calls == [] and _build._LIBS == libs


def test_start_loads_the_kernels_first_on_cuda(monkeypatch):
    """With the kernel on a CUDA device, ``start()`` starts the context
    and loads K3's and K6's libraries before any worker exists — and a
    failure raises out of ``start()`` instead of degrading the jobs."""
    events = []
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, **kw: events.append(("ctx", str(kw))))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: events.append(("sync", str(dev))))
    monkeypatch.setattr(_build, "load",
                        lambda name: events.append(("load", name)))
    svc = ProfilingService(ServiceConfig(
        provider="kernel", fallbacks=("trace",), workers=2,
        fault_rate=0.5))
    svc.start()
    try:
        assert events == [("ctx", "{'device': device(type='cuda')}"),
                          ("sync", "cuda"), ("load", "histogram"),
                          ("load", "scatter_add")]
    finally:
        svc.stop()

    def broken(name):
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    svc = ProfilingService(ServiceConfig(provider="kernel"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        svc.start()
    assert not svc._threads


def test_start_without_a_card_raises():
    """No fallback: the kernel primary on the default device refuses to
    start where there is no card, before a worker or a build."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    svc = ProfilingService(ServiceConfig(provider="kernel"))
    libs = dict(_build._LIBS)
    with pytest.raises((RuntimeError, AssertionError)):
        svc.start()
    assert not svc._threads and _build._LIBS == libs


# -- launch counts under a worker pool ----------------------------------------


def test_launch_counts_add_up_under_threads():
    """Service workers launch from several threads: every count through
    ``_build.count_launch`` must land (a bare ``+=`` on a dict entry is a
    read-modify-write that the interpreter does not promise to keep
    whole), under more threads than cores and a short switch interval."""
    launches = {"hist_instrumented": 0, "scatter_add_instrumented": 0}
    threads, per_thread = 32, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            name = list(launches)[i % 2]
            for _ in range(per_thread):
                _build.count_launch(launches, name)

        with ThreadPoolExecutor(max_workers=threads) as pool:
            for f in [pool.submit(work, i) for i in range(threads)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert launches == {name: threads // 2 * per_thread
                        for name in launches}
    _build.reset_counts(launches)
    assert launches == {name: 0 for name in launches}
