"""The port's resilience layer, against its own contract and the reference's.

The counterparts of ``tests/test_resilience.py``, run on
``repro_torch``: (a) the retry schedule is deterministic under a seed
and every knob is validated up front, (b) a job deadline shorter than
one provider call fails fast as ``DeadlineExceeded`` — never a hang, (c)
the circuit breaker's half-open probe admits exactly one call and
re-opens on its failure, (d) ``ResilientProvider`` walks primary ->
fallbacks -> cached-stale, stamping every non-primary result
``meta["degraded"]``, and (e) degraded counters are memoized but never
written to the persistent cache.

Then the same inputs through both packages: the seeded retry schedules,
the breaker's transitions under one fake clock, ``counter_set_error``'s
messages on the same corrupt sets and the fault schedule of
``FaultInjectionProvider`` (per call, and its ``stats``) must be equal —
floats bit for bit, since both run the same stdlib ``random`` draws.
"""

import dataclasses
import threading

import numpy as np
import pytest

from repro.analysis import FaultInjectionProvider as RefFault
from repro.analysis import WorkloadSpec as RefSpec
from repro.analysis import get_device as ref_get_device
from repro.analysis import get_provider as ref_get_provider
from repro.analysis.providers import InjectedFault as RefInjectedFault
from repro.analysis.resilience import CircuitBreaker as RefBreaker
from repro.analysis.resilience import RetryPolicy as RefRetryPolicy
from repro.analysis.resilience import counter_set_error as ref_set_error
from repro_torch.analysis import (
    FaultInjectionProvider,
    ResilientProvider,
    RetryPolicy,
    Session,
    SweepCache,
    WorkloadSpec,
    get_device,
)
from repro_torch.analysis import device as device_mod
from repro_torch.analysis.providers import InjectedFault, get_provider
from repro_torch.analysis.resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    ProviderCallTimeout,
    ResilienceExhausted,
    TransientProviderError,
    call_with_timeout,
    counter_set_error,
    current_deadline,
    is_degraded,
    mark_degraded,
    record_event,
    resilience_scope,
)


@pytest.fixture(autouse=True)
def _isolate_results(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "results"))
    yield


def _spec(n=1024, seed=0, label="pt", **kw):
    rng = np.random.default_rng(seed)
    return WorkloadSpec.from_indices(rng.integers(0, 256, n), 256,
                                     label=label, waves_per_tile=4, **kw)


DEVICE = get_device("v5e")
FAST = RetryPolicy(retries=2, backoff_base_s=0.001, jitter=0.0)


class FlakyProvider:
    """Fails the first ``fail_first`` collects, then delegates to trace."""

    def __init__(self, fail_first=0, exc=TransientProviderError,
                 name="trace"):
        self.inner = get_provider("trace")
        self.name = name
        self.fail_first = fail_first
        self.exc = exc
        self.calls = 0

    def collect(self, spec, device):
        self.calls += 1
        if self.calls <= self.fail_first:
            raise self.exc(f"flaky failure {self.calls}")
        return self.inner.collect(spec, device)


class BlockingProvider:
    """Sleeps ``delay_s`` per collect (timeout/deadline fodder)."""

    name = "trace"

    def __init__(self, delay_s):
        self.delay_s = delay_s
        self.inner = get_provider("trace")

    def collect(self, spec, device):
        import time
        time.sleep(self.delay_s)
        return self.inner.collect(spec, device)


# -- RetryPolicy --------------------------------------------------------------


def test_retry_policy_validates_up_front():
    with pytest.raises(ValueError):
        RetryPolicy(retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_base_s=-0.1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_factor=0.5)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=1.5)


def test_retry_schedule_deterministic_and_bounded():
    p = RetryPolicy(retries=5, backoff_base_s=0.1, backoff_factor=2.0,
                    max_backoff_s=0.5, jitter=0.25)
    assert p.attempts == 6
    s1, s2 = p.schedule(seed=7), p.schedule(seed=7)
    assert s1 == s2                       # same seed, same schedule
    assert p.schedule(seed=8) != s1       # a different seed moves it
    assert len(s1) == 5
    # base grows 0.1, 0.2, 0.4 then clamps at 0.5; jitter adds <= 25%
    for k, d in enumerate(s1):
        base = min(0.1 * 2.0 ** k, 0.5)
        assert base <= d <= base * 1.25


def test_retry_schedule_no_jitter_is_exact():
    p = RetryPolicy(retries=3, backoff_base_s=0.5, backoff_factor=2.0,
                    max_backoff_s=10.0, jitter=0.0)
    assert p.schedule(seed=0) == [0.5, 1.0, 2.0]


def test_zero_retry_policy_single_attempt():
    p = RetryPolicy(retries=0)
    assert p.attempts == 1
    assert p.schedule() == []
    flaky = FlakyProvider(fail_first=1)
    rp = ResilientProvider(flaky, retry=p)
    with pytest.raises(ResilienceExhausted):
        rp.collect(_spec(), DEVICE)
    assert flaky.calls == 1               # no second attempt


# -- deadlines / timeouts -----------------------------------------------------


def test_call_with_timeout_paths():
    assert call_with_timeout(lambda: 42, None) == 42
    assert call_with_timeout(lambda: 42, 5.0) == 42
    with pytest.raises(ProviderCallTimeout):
        call_with_timeout(lambda: __import__("time").sleep(5), 0.05)
    with pytest.raises(ProviderCallTimeout):
        call_with_timeout(lambda: 42, 0.0)   # no budget left

    def boom():
        raise KeyError("inner")

    with pytest.raises(KeyError):
        call_with_timeout(boom, 5.0)


def test_deadline_and_scope():
    assert current_deadline() is None
    record_event({"kind": "noop"})        # no scope: silently dropped
    t = [0.0]
    with resilience_scope(2.0, clock=lambda: t[0]) as events:
        d = current_deadline()
        assert d is not None and not d.expired
        t[0] = 1.0
        assert d.remaining() == pytest.approx(1.0)
        record_event({"kind": "x"})
        t[0] = 3.0
        assert d.expired
    assert events == [{"kind": "x"}]
    assert current_deadline() is None
    with pytest.raises(ValueError):
        Deadline(0.0)


def test_deadline_shorter_than_one_call_fails_fast():
    """A 0.05s job deadline against a 5s provider call: the call is cut
    at the remaining budget and the job dies as DeadlineExceeded in
    ~deadline time, not provider time."""
    rp = ResilientProvider(BlockingProvider(5.0), retry=FAST,
                           call_timeout_s=30.0)
    import time
    start = time.monotonic()
    with resilience_scope(0.05) as events:
        with pytest.raises(DeadlineExceeded):
            rp.collect(_spec(), DEVICE)
    assert time.monotonic() - start < 2.0
    assert any(e["kind"] == "retry" for e in events)


# -- circuit breaker ----------------------------------------------------------


def test_breaker_validates_and_trips():
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError):
        CircuitBreaker(cooldown_s=-1)
    t = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown_s=10.0,
                        clock=lambda: t[0])
    assert br.allow() and br.state == "closed"
    br.record_failure()
    assert br.allow()                     # one failure: still closed
    br.record_failure()
    assert br.state == "open" and not br.allow()
    snap = br.snapshot()
    assert snap["trips"] == 1
    assert snap["cooldown_remaining_s"] == pytest.approx(10.0)


def test_breaker_half_open_reprobe():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=1, cooldown_s=10.0,
                        clock=lambda: t[0])
    br.record_failure()
    assert br.state == "open" and not br.allow()
    t[0] = 10.0
    assert br.allow()                     # the single half-open probe
    assert br.state == "half-open"
    assert not br.allow()                 # second caller is rejected
    br.record_failure()                   # probe failed: re-open
    assert br.state == "open"
    assert br.snapshot()["trips"] == 2
    assert not br.allow()                 # fresh cooldown from t=10
    t[0] = 20.0
    assert br.allow()
    br.record_success()                   # probe succeeded: re-close
    assert br.state == "closed" and br.allow()
    assert br.snapshot()["consecutive_failures"] == 0


def test_breaker_skips_dead_provider_without_paying_timeout():
    flaky = FlakyProvider(fail_first=10 ** 9)
    rp = ResilientProvider(flaky, retry=RetryPolicy(retries=0),
                           breaker_threshold=2,
                           breaker_cooldown_s=1000.0)
    for _ in range(2):
        with pytest.raises(ResilienceExhausted):
            rp.collect(_spec(), DEVICE)
    calls = flaky.calls
    with resilience_scope(30.0) as events:
        with pytest.raises(ResilienceExhausted):
            rp.collect(_spec(), DEVICE)
    assert flaky.calls == calls           # breaker open: not even called
    assert any(e["kind"] == "breaker-skip" for e in events)


# -- counter sanity -----------------------------------------------------------


def test_counter_set_error_catches_structural_garbage():
    good = get_provider("trace").collect(_spec(), DEVICE)
    assert counter_set_error(good) is None
    assert counter_set_error("nope")      # not a CounterSet
    import dataclasses
    nan = dataclasses.replace(
        good, O=np.full_like(np.asarray(good.O, float), np.nan))
    assert "non-finite" in counter_set_error(nan)
    neg = dataclasses.replace(good, N_f=-np.asarray(good.N_f, float))
    assert neg.N_f.min() <= 0  # sanity of the fixture itself
    assert counter_set_error(neg)
    short = dataclasses.replace(good, O=np.asarray(good.O)[:-1])
    assert "shape" in counter_set_error(short)
    bad_roof = dataclasses.replace(good, bytes_read=float("inf"))
    assert "non-finite" in counter_set_error(bad_roof)


def test_degraded_stamp_roundtrip():
    cset = get_provider("trace").collect(_spec(), DEVICE)
    assert not is_degraded(cset)
    marked = mark_degraded(cset, fallback="kernel", primary="trace")
    assert is_degraded(marked)
    assert marked.meta["fallback_provider"] == "kernel"
    assert not is_degraded(cset)          # original untouched


# -- the resilient chain ------------------------------------------------------


def test_transient_failure_retried_then_primary_result():
    flaky = FlakyProvider(fail_first=2)
    rp = ResilientProvider(flaky, retry=FAST)
    with resilience_scope(30.0) as events:
        cset = rp.collect(_spec(), DEVICE)
    assert flaky.calls == 3
    assert not is_degraded(cset)          # third attempt is the primary
    assert [e["kind"] for e in events] == ["retry", "retry"]


def test_permanent_failure_skips_retries_and_falls_back():
    flaky = FlakyProvider(fail_first=10 ** 9, exc=KeyError)
    rp = ResilientProvider(flaky, fallbacks=("trace",), retry=FAST)
    with resilience_scope(30.0) as events:
        cset = rp.collect(_spec(), DEVICE)
    assert flaky.calls == 1               # permanent: no retry
    assert is_degraded(cset)
    assert cset.meta["fallback_provider"] == "trace"
    kinds = [e["kind"] for e in events]
    assert kinds == ["permanent", "fallback"]


def test_corrupt_counters_detected_and_degraded():
    fault = FaultInjectionProvider("trace", corrupt_rate=1.0, seed=3)
    rp = ResilientProvider(fault, fallbacks=("trace",), retry=FAST)
    cset = rp.collect(_spec(), DEVICE)
    assert is_degraded(cset)
    assert np.all(np.isfinite(cset.O))    # the fallback's sane numbers
    assert fault.stats_snapshot()["corrupt"] == FAST.attempts


def test_exhausted_chain_reports_every_error():
    rp = ResilientProvider(FlakyProvider(fail_first=10 ** 9),
                           retry=RetryPolicy(retries=1,
                                             backoff_base_s=0.001))
    with pytest.raises(ResilienceExhausted) as ei:
        rp.collect(_spec(), DEVICE)
    assert len(ei.value.errors) == 2      # both attempts recorded
    assert all(name == "trace" for name, _ in ei.value.errors)


def test_stale_cache_is_the_last_resort():
    cache = SweepCache()
    spec = _spec(label="warm-me")
    cset = get_provider("trace").collect(spec, DEVICE)
    cache.put(cache.key("trace", spec.fingerprint(), DEVICE.table_key()),
              cset)
    rp = ResilientProvider(FlakyProvider(fail_first=10 ** 9),
                           retry=RetryPolicy(retries=0),
                           stale_cache=cache)
    with resilience_scope(30.0) as events:
        got = rp.collect(spec, DEVICE)
    assert is_degraded(got)
    assert got.meta["fallback_provider"] == "cached-stale"
    assert events[-1]["fallback"] == "cached-stale"
    np.testing.assert_array_equal(got.O, cset.O)


def test_deterministic_backoff_under_seeded_faults():
    """The sleeps a seeded ResilientProvider actually performs equal the
    policy's published schedule — the chaos tests' reproducibility
    contract."""
    policy = RetryPolicy(retries=3, backoff_base_s=0.01, jitter=0.25)
    for seed in (0, 11):
        slept = []
        fault = FaultInjectionProvider("trace", fault_rate=1.0, seed=1)
        rp = ResilientProvider(fault, retry=policy, seed=seed,
                               sleep=slept.append)
        with pytest.raises(ResilienceExhausted):
            rp.collect(_spec(), DEVICE)
        assert slept == policy.schedule(seed=seed)


def test_fault_provider_schedule_is_rate_independent():
    """Same seed, different enabled rates: the same calls are hit,
    because every call draws exactly three variates."""
    import random
    rng = random.Random(5)
    draws = [(rng.random(), rng.random(), rng.random())
             for _ in range(20)]
    fault_calls = {i for i, d in enumerate(draws) if d[0] < 0.3}
    fault = FaultInjectionProvider("trace", fault_rate=0.3, seed=5)
    spec = _spec()
    hit = set()
    for i in range(20):
        try:
            fault.collect(spec, DEVICE)
        except InjectedFault:
            hit.add(i)
    assert hit == fault_calls


def test_fault_provider_validates_and_reconfigures():
    fault = FaultInjectionProvider("trace", fault_rate=0.5)
    with pytest.raises(ValueError):
        fault.configure(fault_rate=1.5)
    with pytest.raises(ValueError):
        FaultInjectionProvider("trace", corrupt_rate=-0.1)
    fault.configure(fault_rate=0.0)
    fault.collect(_spec(), DEVICE)        # no injection at rate 0
    assert fault.stats_snapshot()["faults"] == 0


# -- session integration ------------------------------------------------------


@pytest.fixture
def sess_factory(tmp_path):
    device_mod._TABLE_MEMO.clear()

    def make(provider, **kw):
        return Session("v5e", provider=provider, cache_dir=tmp_path, **kw)
    return make


def test_degraded_results_memoized_but_never_on_disk(sess_factory):
    cache = SweepCache()
    fault = FaultInjectionProvider("trace", fault_rate=1.0, seed=0)
    rp = ResilientProvider(fault, fallbacks=("trace",), retry=FAST,
                           stale_cache=cache)
    sess = sess_factory(rp, persistent_cache=cache)
    specs = [_spec(seed=s, label=f"pt{s}") for s in range(4)]
    result = sess.sweep(specs, parallel=1)
    assert len(result) == 4
    assert all((p.params or {}).get("meta", {}).get("degraded")
               for p in result.profiles)
    assert len(cache) == 0                # nothing written to disk
    # warm resubmission: the memo serves every point, zero collections
    before = sess.stats_snapshot()
    sess.sweep(specs, parallel=1)
    after = sess.stats_snapshot()
    assert after["batch_calls"] == before["batch_calls"]
    assert after["collected"] == before["collected"]


def test_healthy_resilient_provider_shares_cache_with_plain_session(
        sess_factory):
    """ResilientProvider keeps the primary's name, so a spec warmed by a
    plain session is a disk hit for the resilient one (and vice versa)."""
    cache = SweepCache()
    plain = sess_factory("trace", persistent_cache=cache)
    spec = _spec(label="shared")
    plain.sweep([spec])
    assert len(cache) == 1
    rp = ResilientProvider("trace", retry=FAST, stale_cache=cache)
    resilient = sess_factory(rp, persistent_cache=cache)
    resilient.sweep([spec])
    assert resilient.stats_snapshot()["disk_hits"] == 1
    assert resilient.stats_snapshot()["collected"] == 0


def test_resilient_provider_dedups_fallbacks_and_labels_breakers():
    fault = FaultInjectionProvider("trace", fault_rate=1.0)
    rp = ResilientProvider(fault, fallbacks=("trace", "trace"))
    assert len(rp.fallbacks) == 1         # same instance listed once
    states = rp.breaker_states()
    assert set(states) == {"trace", "trace#2"}   # per-instance breakers


def test_breaker_isolation_between_primary_and_fallback():
    """Primary failures must never open the fallback's breaker, even
    when both carry the same provider name."""
    fault = FaultInjectionProvider("trace", fault_rate=1.0, seed=0)
    rp = ResilientProvider(fault, fallbacks=("trace",),
                           retry=RetryPolicy(retries=0,
                                             backoff_base_s=0.001),
                           breaker_threshold=2,
                           breaker_cooldown_s=1000.0)
    for i in range(4):
        cset = rp.collect(_spec(seed=i), DEVICE)
        assert is_degraded(cset)
    states = rp.breaker_states()
    assert states["trace"]["state"] == "open"       # primary tripped
    assert states["trace#2"]["state"] == "closed"   # fallback healthy


def test_thread_safety_of_resilient_collect():
    flaky = FlakyProvider(fail_first=0)
    rp = ResilientProvider(flaky, retry=FAST)
    results, errors = [], []

    def work(seed):
        try:
            results.append(rp.collect(_spec(seed=seed), DEVICE))
        except Exception as exc:  # noqa: BLE001 — collected for assert
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 8


# -- the same inputs through both packages ------------------------------------


POLICIES = [
    dict(retries=5, backoff_base_s=0.1, backoff_factor=2.0,
         max_backoff_s=0.5, jitter=0.25),
    dict(retries=3, backoff_base_s=0.5, backoff_factor=2.0,
         max_backoff_s=10.0, jitter=0.0),
    dict(retries=8, backoff_base_s=0.01, backoff_factor=1.5,
         max_backoff_s=2.0, jitter=1.0),
    dict(retries=0),
]


@pytest.mark.parametrize("policy", POLICIES,
                         ids=[f"retries{p['retries']}" for p in POLICIES])
@pytest.mark.parametrize("seed", [0, 7, 11, 2 ** 31 - 1])
def test_retry_schedule_equals_reference(policy, seed):
    got = RetryPolicy(**policy)
    want = RefRetryPolicy(**policy)
    assert got.attempts == want.attempts
    assert got.schedule(seed=seed) == want.schedule(seed=seed)
    assert [got.delay(k) for k in range(6)] == \
        [want.delay(k) for k in range(6)]


def test_breaker_transitions_equal_reference():
    """One script of allow/success/failure calls and clock moves, driven
    into both breakers under one fake clock: every return value and
    every snapshot must be equal."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    breakers = (CircuitBreaker(3, 10.0, clock=clock),
                RefBreaker(3, 10.0, clock=clock))
    script = (["allow", "fail", "fail", "allow", "ok", "fail", "fail",
               "fail", "allow", ("t", 4.0), "allow", ("t", 10.0), "allow",
               "allow", "fail", "allow", ("t", 20.0), "allow", "ok",
               "allow", "fail", "fail", "fail", ("t", 35.0), "allow",
               "fail", ("t", 45.5), "allow", "ok"])
    trail = ([], [])
    for op in script:
        if isinstance(op, tuple):
            t[0] = op[1]
        for br, out in zip(breakers, trail):
            if op == "allow":
                out.append(br.allow())
            elif op == "ok":
                br.record_success()
            elif op == "fail":
                br.record_failure()
            out.append((br.state, br.snapshot()))
    assert trail[0] == trail[1]
    assert breakers[0].snapshot()["trips"] == 4


def _both_sets(n=2048, seed=0):
    """(port, reference) trace counters of one index stream."""
    idx = np.random.default_rng(seed).integers(0, 256, n)
    got = get_provider("trace").collect(
        WorkloadSpec.from_indices(idx, 256, label="pt", waves_per_tile=4),
        get_device("v5e"))
    want = ref_get_provider("trace").collect(
        RefSpec.from_indices(idx, 256, label="pt", waves_per_tile=4),
        ref_get_device("v5e"))
    return got, want


CORRUPTIONS = {
    "sane": lambda c: c,
    "nan O": lambda c: dataclasses.replace(
        c, O=np.full_like(np.asarray(c.O, float), np.nan)),
    "negative N_f": lambda c: dataclasses.replace(
        c, N_f=-np.asarray(c.N_f, float) - 1.0),
    "short O": lambda c: dataclasses.replace(c, O=np.asarray(c.O)[:-1]),
    "inf N_c": lambda c: dataclasses.replace(
        c, N_c=np.asarray(c.N_c, float) + np.inf),
    "inf bytes": lambda c: dataclasses.replace(c, bytes_read=float("inf")),
    "negative flops": lambda c: dataclasses.replace(c, flops=-1.0),
    "no cores": lambda c: dataclasses.replace(c, num_cores=0),
    "negative waves": lambda c: dataclasses.replace(c, num_waves=-1),
    "zero tile": lambda c: dataclasses.replace(c, waves_per_tile=0),
    "nan wall": lambda c: dataclasses.replace(c, wall_time_s=float("nan")),
}


@pytest.mark.parametrize("corrupt", list(CORRUPTIONS))
def test_counter_set_error_messages_equal_reference(corrupt):
    got, want = _both_sets()
    got, want = CORRUPTIONS[corrupt](got), CORRUPTIONS[corrupt](want)
    assert counter_set_error(got) == ref_set_error(want)
    assert (counter_set_error(got) is None) == (corrupt == "sane")
    assert counter_set_error("nope") == ref_set_error("nope")


def _fault_trail(fault, spec, device, injected, calls=40):
    """Per call: 'fault', 'corrupt' or 'ok' (latency counted in stats)."""
    trail = []
    for _ in range(calls):
        try:
            cset = fault.collect(spec, device)
        except injected:
            trail.append("fault")
            continue
        trail.append("ok" if np.all(np.isfinite(cset.O)) else "corrupt")
    return trail


@pytest.mark.parametrize("rates", [
    dict(fault_rate=0.2, corrupt_rate=0.05),
    dict(fault_rate=0.3, latency_rate=0.5, corrupt_rate=0.3),
    dict(latency_rate=1.0),
    dict(fault_rate=1.0),
], ids=["chaos", "all", "latency", "dead"])
@pytest.mark.parametrize("seed", [0, 42])
def test_fault_schedule_equals_reference(rates, seed):
    idx = np.random.default_rng(1).integers(0, 256, 1024)
    slept = ([], [])
    got = FaultInjectionProvider("trace", seed=seed, latency_s=0.25,
                                 sleep=slept[0].append, **rates)
    want = RefFault("trace", seed=seed, latency_s=0.25,
                    sleep=slept[1].append, **rates)
    trail = _fault_trail(
        got, WorkloadSpec.from_indices(idx, 256, label="f"),
        get_device("v5e"), InjectedFault)
    assert trail == _fault_trail(
        want, RefSpec.from_indices(idx, 256, label="f"),
        ref_get_device("v5e"), RefInjectedFault)
    assert got.stats_snapshot() == want.stats_snapshot()
    assert slept[0] == slept[1]
    assert got.stats_snapshot()["calls"] == 40
