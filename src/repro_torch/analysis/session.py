"""Session: one-call pipeline from workload spec to bottleneck verdict.

The paper promises a user can "immediately determine if shared-memory
atomic operations are a bottleneck".  A ``Session`` is that promise as an
API: it owns a ``Device`` (and therefore the cached service-time table)
plus a ``CounterProvider`` (how counters are acquired), and turns
``WorkloadSpec``s into profiles, sweeps, shift reports, and renderable
verdicts:

    sess = Session(device="v5e")              # counters via "trace"
    prof = sess.profile(spec)                 # one launch
    result = sess.sweep([spec_1, ..., spec_k])  # a parameter sweep
    print(sess.report())                      # text | json | csv

    Session(device="v5e", provider="kernel")  # counters from the
                                              # instrumented Hopper kernel

``validate`` is the paper's §5 as an API call: collect the same spec
through several providers (modeled vs measured) and report per-counter
relative errors and the utilization delta.

The layers above and beside the pipeline (``advise``, ``audit``,
``lint``, ``heatmap``) come with their own slices of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.analysis.device import Device, get_device
from repro_torch.analysis.providers import (CounterProvider, get_provider,
                                      provider_collect_batch)
from repro_torch.analysis.render import rows_to_csv
from repro_torch.analysis.sweep_cache import SweepCache
from repro_torch.analysis.workload import WorkloadSpec
from repro_torch.core import bottleneck, profiler, qmodel
from repro_torch.core import counters as counters_mod
from repro_torch.core.counters import CounterFrame, CounterSet
from repro_torch.obs import telemetry as _telemetry

_SESSION_CALLS = _telemetry.counter(
    "repro_session_calls_total", "Session entry-point invocations",
    ("method",))
_SESSION_SECONDS = _telemetry.histogram(
    "repro_session_seconds", "Session entry-point latency", ("method",))
_SESSION_POINTS = _telemetry.counter(
    "repro_session_points_total", "Workload points analyzed")


@contextlib.contextmanager
def _observed(method: str, **attrs):
    """Count + time + span one Session entry point (telemetry-gated)."""
    _SESSION_CALLS.inc(method=method)
    t0 = time.perf_counter()
    with _telemetry.span(f"session.{method}", **attrs):
        yield
    _SESSION_SECONDS.observe(time.perf_counter() - t0, method=method)


@dataclasses.dataclass
class SweepResult:
    """Profiles + per-point verdicts + shift/speedup analysis for a sweep."""

    device: Device
    specs: list[WorkloadSpec]
    profiles: list[profiler.WorkloadProfile]
    verdicts: list[bottleneck.BottleneckVerdict]
    shifts: list[bottleneck.ShiftEvent]
    utilization: dict[str, np.ndarray]      # unit name -> per-point U
    speedup_vs_first: np.ndarray            # modeled T(first) / T(point)

    def __len__(self) -> int:
        return len(self.profiles)

    @property
    def bottlenecks(self) -> list[str]:
        return [p.bottleneck for p in self.profiles]

    # -- renderers --------------------------------------------------------

    def to_rows(self, structured_hints: bool = False) -> list[dict]:
        """One flat record per sweep point (the csv/json payload).

        ``e`` is the job-weighted mean across cores (matching the global
        ``e = O / N`` of ``CounterSet``/``validate``) and ``n_hat`` the
        max (the profile's peak concurrency estimate) — a multi-core
        profile must not be reported from core 0 alone.  The verdict's
        machine-usable ``hint`` rides along: compact ``action:family``
        form by default (csv/text cells), the full structured dict with
        ``structured_hints=True`` (the json payload).
        """
        rows = []
        for i, (p, v) in enumerate(zip(self.profiles, self.verdicts)):
            if v.hint is None:
                hint = None if structured_hints else ""
            elif structured_hints:
                hint = dataclasses.asdict(v.hint)
            else:
                hint = v.hint.compact()
            row = {
                "label": p.label,
                "bottleneck": v.bottleneck,
                "saturated": v.saturated,
                "comment": v.comment,
                "hint": hint,
                "scatter_model_U": p.scatter_utilization,
                "speedup_vs_first": float(self.speedup_vs_first[i]),
                "e": p.e,
                "n_hat": p.n_hat,
            }
            for u in p.units:
                row[f"U_{u.name}"] = u.utilization
            rows.append(row)
        return rows

    def _point_meta(self) -> dict[str, dict]:
        """Non-empty provider meta per point label (the json payload)."""
        out: dict[str, dict] = {}
        for p in self.profiles:
            meta = (p.params or {}).get("meta") or {}
            if meta:
                out[p.label] = meta
        return out

    def render(self, fmt: str = "text") -> str:
        if fmt == "json":
            payload = {
                "device": self.device.name,
                "points": self.to_rows(structured_hints=True),
                "shifts": [dataclasses.asdict(s) for s in self.shifts],
            }
            meta = self._point_meta()
            if meta:
                payload["meta"] = meta
            return json.dumps(payload, indent=2, default=str)
        if fmt == "csv":
            # Heterogeneous sweeps produce ragged rows (a point's U_*
            # columns depend on its unit set): the shared union-header
            # helper writes missing cells empty instead of raising on
            # later-only columns.
            return rows_to_csv(self.to_rows())
        if fmt == "text":
            buf = io.StringIO()
            multi = len(self.profiles) > 1
            head = "sweep" if multi else "profile"
            buf.write(f"== {head} on {self.device.name} "
                      f"({len(self.profiles)} point"
                      f"{'s' if multi else ''}) ==\n")
            for row in self.to_rows():
                units = "  ".join(
                    f"{k[2:]}={row[k]:6.2%}" for k in row if k.startswith("U_"))
                hint = f"  [{row['hint']}]" if row["hint"] else ""
                buf.write(f"{row['label']:>28}  {units}  "
                          f"-> {row['bottleneck']}"
                          f"{' (saturated)' if row['saturated'] else ''}"
                          f"{hint}\n")
            # shift lines are sweep properties: meaningless for one point
            if multi:
                if self.shifts:
                    for s in self.shifts:
                        buf.write(f"bottleneck shift at point {s.index}: "
                                  f"{s.unit_before} -> {s.unit_after} "
                                  f"({s.label_before} -> {s.label_after})\n")
                else:
                    buf.write("no bottleneck shifts in sweep\n")
            return buf.getvalue()
        raise ValueError(f"unknown report format {fmt!r} "
                         "(expected 'text', 'json' or 'csv')")


@dataclasses.dataclass
class ProviderComparison:
    """One provider's counters + errors relative to the reference."""

    provider: str
    counters: dict               # N, O, e, n_hat, U
    rel_err: dict                # same keys, |x - ref| / |ref|
    utilization_delta: float     # U - U_ref (signed)
    wall_time_s: Optional[float] = None
    # collect_batch([spec]).row(0) exactly equals collect(spec)?  None
    # when the provider has no batch path (collect-only custom sources)
    batch_bitwise_equal: Optional[bool] = None


@dataclasses.dataclass
class ValidationReport:
    """Model-vs-measured counter comparison (paper §5 as an API call)."""

    device: str
    label: str
    reference: str                         # provider name errors are vs
    comparisons: list[ProviderComparison]

    @property
    def max_rel_err(self) -> float:
        return max((e for c in self.comparisons
                    for e in c.rel_err.values()), default=0.0)

    def rel_err(self, provider: str, counter: str) -> float:
        for c in self.comparisons:
            if c.provider == provider:
                return c.rel_err[counter]
        raise KeyError(provider)

    def to_dict(self) -> dict:
        def finite(v):
            # a zero reference with a nonzero counter yields rel_err=inf;
            # JSON has no Infinity, so emit null there
            if isinstance(v, float) and not np.isfinite(v):
                return None
            return v

        comparisons = []
        for c in self.comparisons:
            d = dataclasses.asdict(c)
            d["rel_err"] = {k: finite(v) for k, v in d["rel_err"].items()}
            comparisons.append(d)
        return {
            "device": self.device, "label": self.label,
            "reference": self.reference, "comparisons": comparisons,
        }

    def render(self, fmt: str = "text") -> str:
        if fmt == "json":
            return json.dumps(self.to_dict(), indent=2)
        if fmt != "text":
            raise ValueError(f"unknown report format {fmt!r} "
                             "(expected 'text' or 'json')")
        buf = io.StringIO()
        buf.write(f"== validation: {self.label} on {self.device} "
                  f"(reference: {self.reference}) ==\n")
        keys = list(self.comparisons[0].counters) if self.comparisons else []
        buf.write(f"{'provider':>12}  "
                  + "  ".join(f"{k:>12}" for k in keys) + "\n")
        for c in self.comparisons:
            buf.write(f"{c.provider:>12}  "
                      + "  ".join(f"{c.counters[k]:>12.4g}" for k in keys)
                      + "\n")
            if c.provider != self.reference:
                buf.write(f"{'rel err':>12}  "
                          + "  ".join(f"{c.rel_err[k]:>12.2%}" for k in keys)
                          + "\n")
        buf.write(f"max relative error: {self.max_rel_err:.2%}\n")
        checked = [c for c in self.comparisons
                   if c.batch_bitwise_equal is not None]
        if checked:
            bad = [c.provider for c in checked if not c.batch_bitwise_equal]
            if bad:
                buf.write("batch collection MISMATCH (collect_batch != "
                          "collect): " + ", ".join(bad) + "\n")
            else:
                buf.write("batch collection bit-identical: "
                          + ", ".join(c.provider for c in checked) + "\n")
        return buf.getvalue()


class Session:
    """The single public entry point for the paper's two tools.

    Tool 1 (the per-device table) runs implicitly — construction resolves
    the device's cached ``ServiceTimeTable``, building it only on first
    ever use.  Tool 2 is ``profile``/``sweep``, with counters acquired by
    ``provider`` (a registry name or a ``CounterProvider`` instance;
    default ``"trace"``, the modeled path).
    """

    def __init__(self, device: Union[str, Device] = "v5e", *,
                 table: Optional[qmodel.ServiceTimeTable] = None,
                 cache_dir=None, use_true_n: bool = False,
                 provider: Union[str, CounterProvider] = "trace",
                 shift_tol: float = bottleneck.SHIFT_TOL,
                 persistent_cache: Union[bool, str, SweepCache] = False,
                 ) -> None:
        self.device = get_device(device)
        self.provider = get_provider(provider)
        self.table = table if table is not None \
            else self.device.table(cache_dir)
        self.use_true_n = use_true_n
        self.shift_tol = shift_tol
        self._last: Optional[SweepResult] = None
        # per-point memo for sweeps: (provider, fingerprint) -> CounterSet
        self._collect_memo: dict[tuple[str, str], CounterSet] = {}
        self._memo_lock = threading.Lock()
        # cross-process counter cache (results/torch/cache/): False = off,
        # True = default root, or a path / SweepCache instance
        if isinstance(persistent_cache, SweepCache):
            self.sweep_cache: Optional[SweepCache] = persistent_cache
        elif persistent_cache:
            self.sweep_cache = SweepCache(
                None if persistent_cache is True else persistent_cache)
        else:
            self.sweep_cache = None
        # collection accounting, consistent across the scalar, batch, and
        # persistent-cache paths: points actually collected, points served
        # from the in-process memo / the on-disk sweep cache, and how many
        # provider batch calls the collected points took (O(groups), not
        # O(points))
        self.stats = {"collected": 0, "memo_hits": 0, "disk_hits": 0,
                      "batch_calls": 0}

    # -- the pipeline -----------------------------------------------------

    def collect(self, spec: WorkloadSpec,
                provider: Union[str, CounterProvider, None] = None,
                ) -> CounterSet:
        """Acquire the spec's counters (this session's provider by default)."""
        prov = self.provider if provider is None else get_provider(provider)
        return prov.collect(spec, self.device)

    def profile(self, spec: WorkloadSpec) -> profiler.WorkloadProfile:
        """Run one spec through counters -> queue model -> utilization.

        A single point is just a one-row ``CounterFrame`` through the
        same columnar batch path sweeps use.
        """
        with _observed("profile", label=spec.label):
            self._last = self.analyze([spec])
        return self._last.profiles[0]

    def classify(self, spec: WorkloadSpec) -> bottleneck.BottleneckVerdict:
        """Spec straight to verdict (the paper's 'immediately determine')."""
        self.profile(spec)
        return self._last.verdicts[0]

    def sweep(self, specs: Sequence[WorkloadSpec], *,
              parallel: Optional[int] = None,
              shards: int = 1, shard_index: int = 0) -> SweepResult:
        """Profile every spec and analyze the sweep as a whole.

        Two phases.  *Collection* runs the batch path
        (``collect_cached_batch``): points are partitioned into
        in-process memo hits, bulk on-disk ``SweepCache`` reads (when
        ``persistent_cache`` is set), and one ``provider.collect_batch``
        call per remaining miss group — a warm sweep touches zero
        providers, a cold one makes O(groups) provider calls instead of
        O(points).  ``parallel`` threads the loop fallback of providers
        with no vectorized batch.  *Model evaluation*: all points go
        through ``profiler.profile_batch`` as one columnar
        ``CounterFrame`` pass — the whole §3 queue model in whole-array
        numpy ops, point-for-point identical to the per-point path.
        Result order always matches ``specs`` — neither phase reorders.

        ``shards``/``shard_index`` turn the call into one shard of a
        distributed sweep: the grid is deterministically strided as
        ``specs[shard_index::shards]`` (every process slices the same
        full grid the same way), each shard runs independently, and
        shards merge through the persistent ``SweepCache``: a follow-up
        full-grid sweep assembles the complete result from cache hits.
        """
        specs = list(specs)
        if not specs:
            raise ValueError("sweep() needs at least one WorkloadSpec")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if not 0 <= shard_index < shards:
            raise ValueError(f"shard_index must be in [0, {shards}), "
                             f"got {shard_index}")
        if shards > 1:
            specs = specs[shard_index::shards]
            if not specs:
                raise ValueError(
                    f"shard {shard_index}/{shards} owns no points — the "
                    f"grid is smaller than the shard count")
        with _observed("sweep", points=len(specs)):
            self._last = self.analyze(specs, parallel=parallel)
        return self._last

    def analyze(self, specs: Sequence[WorkloadSpec], *,
                parallel: Optional[int] = None) -> SweepResult:
        """``sweep``'s pipeline without touching session-wide report state.

        Collection and model evaluation exactly as ``sweep`` runs them
        (memo + persistent cache + batch providers, then one columnar
        ``profile_batch`` pass per core-count group), but the result is
        only *returned* —
        ``last``/``report()`` are untouched.  This is the entry point for
        concurrent callers sharing one session: the memo and stats are
        lock-protected, and with no ``_last`` mutation two jobs can run
        through the same session without racing each other's reports.
        """
        specs = list(specs)
        if not specs:
            raise ValueError("analyze() needs at least one WorkloadSpec")
        with _observed("analyze", points=len(specs)):
            _SESSION_POINTS.inc(len(specs))
            with _telemetry.span("session.collect", points=len(specs)):
                csets = self.collect_cached_batch(specs, parallel=parallel)
            with _telemetry.span("session.model", points=len(specs)):
                return self._as_result(specs, self._profile_batch(csets))

    def speedup(self, before: WorkloadSpec, after: WorkloadSpec) -> float:
        """Predicted speedup of ``after`` over ``before``.

        Records both profiles as the session's last result, so a
        following ``report()`` shows the pair (not a stale earlier run).
        """
        result = self.sweep([before, after])
        return float(result.speedup_vs_first[1])

    def validate(self, spec: WorkloadSpec,
                 providers: Sequence[Union[str, CounterProvider]] = (
                     "trace", "kernel"),
                 *, check_batch: bool = True) -> ValidationReport:
        """Collect one spec through several providers and compare counters.

        The paper's §5 validation as a first-class call: the first
        provider is the reference (modeled), the rest are compared against
        it with per-counter relative errors (``N``, ``O``, ``e``,
        ``n_hat``) and the scatter-utilization delta.

        With ``check_batch`` (the default) every provider that implements
        ``collect_batch`` is additionally collected as a batch of one and
        compared bit-for-bit against its scalar ``collect`` — the batch
        path's acceptance invariant, reported per provider as
        ``batch_bitwise_equal`` (``None`` for collect-only providers).
        """
        provs = [get_provider(p) for p in providers]
        if len(provs) < 2:
            raise ValueError("validate() needs at least two providers")
        csets = [p.collect(spec, self.device) for p in provs]
        batch_equal: list[Optional[bool]] = []
        for p, cset in zip(provs, csets):
            if check_batch and hasattr(p, "collect_batch"):
                row = p.collect_batch([spec], self.device).row(0)
                # a provider that measures wall time (microbench) can
                # never repeat the clock bit-for-bit — the check covers
                # every modeled field, not the timing
                ignore = (("wall_time_s", "meta")
                          if cset.wall_time_s is not None else ())
                batch_equal.append(
                    counters_mod.bitwise_equal(cset, row, ignore=ignore))
            else:
                batch_equal.append(None)
        profiles = self._profile_batch(csets)

        def numbers(cset: CounterSet, prof) -> dict:
            return {
                "N": cset.total_jobs,
                "O": cset.total_O,
                "e": cset.e,
                "n_hat": prof.n_hat,
                "U": prof.scatter_utilization,
            }

        ref = numbers(csets[0], profiles[0])
        comparisons = []
        for prov, cset, prof, beq in zip(provs, csets, profiles,
                                         batch_equal):
            got = numbers(cset, prof)
            rel = {
                k: (abs(got[k] - ref[k]) / abs(ref[k]) if ref[k]
                    else (0.0 if got[k] == ref[k] else float("inf")))
                for k in ref
            }
            comparisons.append(ProviderComparison(
                provider=prov.name, counters=got, rel_err=rel,
                utilization_delta=got["U"] - ref["U"],
                wall_time_s=cset.wall_time_s,
                batch_bitwise_equal=beq))
        return ValidationReport(
            device=self.device.name, label=spec.label,
            reference=provs[0].name, comparisons=comparisons)

    # -- reporting --------------------------------------------------------

    @property
    def last(self) -> Optional[SweepResult]:
        return self._last

    def stats_snapshot(self) -> dict:
        """Point-in-time copy of the collection accounting, taken under
        the memo lock (the /status endpoint's consistent read)."""
        with self._memo_lock:
            return dict(self.stats)

    def report(self, fmt: str = "text") -> str:
        """Render the most recent profile()/sweep() result."""
        if self._last is None:
            raise RuntimeError("nothing profiled yet — call profile() or "
                               "sweep() before report()")
        return self._last.render(fmt)

    # -- building blocks for layered tools --------------------------------

    def collect_cached(self, spec: WorkloadSpec) -> CounterSet:
        """``collect`` behind this session's memo + persistent cache.

        The scalar face of ``collect_cached_batch`` (a batch of one):
        layered tools call this so their counter acquisition shares the
        same in-process memo and on-disk ``SweepCache`` a ``sweep`` would
        use.
        """
        return self.collect_cached_batch([spec])[0]

    def collect_cached_batch(self, specs: Sequence[WorkloadSpec], *,
                             parallel: Optional[int] = None,
                             ) -> list[CounterSet]:
        """Batch cache resolution: memo -> bulk disk reads -> providers.

        The sweep engine's collection phase.  Per point, in order:

        1. in-process memo by ``(provider, fingerprint)`` — including
           duplicates *within this batch* (later occurrences of a
           fingerprint count as memo hits, exactly as the sequential
           scalar path would see them);
        2. bulk ``SweepCache.get_many`` for the remaining fingerprints
           (when ``persistent_cache`` is set);
        3. one ``provider.collect_batch`` per ``num_cores`` group of the
           still-missing specs (``CounterFrame`` rows are rectangular),
           with bulk write-back to the memo and the disk cache.

        Specs whose content cannot be hashed (``fingerprint() is None``)
        bypass the caches and are collected point by point.  Hits are
        *relabeled copies* — the fingerprint excludes the label, so
        cached counters may carry another point's name.  Output order
        matches ``specs``.
        """
        specs = list(specs)
        out: list = [None] * len(specs)
        pending: list[tuple[int, str]] = []   # cache-eligible memo misses
        first_of_fp: dict[str, int] = {}
        duplicates: list[tuple[int, int]] = []
        for i, spec in enumerate(specs):
            fp = spec.fingerprint()
            if fp is None:
                out[i] = self.collect(spec)
                with self._memo_lock:
                    self.stats["collected"] += 1
                continue
            with self._memo_lock:
                hit = self._collect_memo.get((self.provider.name, fp))
            if hit is not None:
                with self._memo_lock:
                    self.stats["memo_hits"] += 1
                out[i] = dataclasses.replace(hit, label=spec.label)
                continue
            if fp in first_of_fp:
                duplicates.append((i, first_of_fp[fp]))
                with self._memo_lock:
                    self.stats["memo_hits"] += 1
                continue
            first_of_fp[fp] = i
            pending.append((i, fp))
        # bulk disk reads for the memo misses
        misses: list[tuple[int, str, Optional[str]]] = []
        if pending and self.sweep_cache is not None:
            disk_keys = {
                i: self.sweep_cache.key(self.provider.name, fp,
                                        self.device.table_key())
                for i, fp in pending}
            found = self.sweep_cache.get_many(disk_keys.values())
            for i, fp in pending:
                hit = found.get(disk_keys[i])
                if hit is not None:
                    with self._memo_lock:
                        self.stats["disk_hits"] += 1
                        self._collect_memo[(self.provider.name, fp)] = hit
                    out[i] = dataclasses.replace(hit, label=specs[i].label)
                else:
                    misses.append((i, fp, disk_keys[i]))
        else:
            misses = [(i, fp, None) for i, fp in pending]
        # one provider batch per num_cores group (frames are rectangular)
        by_cores: dict[int, list] = {}
        for item in misses:
            by_cores.setdefault(specs[item[0]].num_cores, []).append(item)
        for items in by_cores.values():
            group = [specs[i] for i, _, _ in items]
            frame = provider_collect_batch(self.provider, group,
                                           self.device, parallel)
            with self._memo_lock:
                self.stats["collected"] += len(group)
                self.stats["batch_calls"] += 1
            write_back = {}
            for row, (i, fp, disk_key) in enumerate(items):
                cset = frame.row(row)
                with self._memo_lock:
                    self._collect_memo[(self.provider.name, fp)] = cset
                if disk_key is not None:
                    write_back[disk_key] = cset
                out[i] = dataclasses.replace(cset, label=specs[i].label)
            if write_back:
                self.sweep_cache.put_many(write_back)
        # duplicates resolve off their batch-mate's now-filled slot
        for i, j in duplicates:
            out[i] = dataclasses.replace(out[j], label=specs[i].label)
        return out

    def profile_sets(self, csets: Sequence[CounterSet],
                     ) -> list[profiler.WorkloadProfile]:
        """Columnar model evaluation of pre-collected CounterSets.

        One ``CounterFrame``/``profile_batch`` pass per ``num_cores``
        group (a single pass when all rows share a core count — the
        usual case), in input order.
        """
        return self._profile_batch(list(csets))

    # -- internals --------------------------------------------------------

    def _profile_batch(self, csets: Sequence[CounterSet],
                       ) -> list[profiler.WorkloadProfile]:
        """Columnar model evaluation for many CounterSets at once.

        A ``CounterFrame`` is rectangular (points x cores), so a sweep
        mixing core counts is grouped by ``num_cores`` first — each group
        is one ``profile_batch`` pass, and results are reassembled in the
        original point order.
        """
        profiles: list = [None] * len(csets)
        by_cores: dict[int, list[int]] = {}
        for i, cs in enumerate(csets):
            by_cores.setdefault(cs.num_cores, []).append(i)
        for idxs in by_cores.values():
            frame = CounterFrame.from_sets([csets[i] for i in idxs])
            outs = profiler.profile_batch(
                frame, self.table,
                params=self.device.scatter,
                chip=self.device.chip,
                cache=self.device.cache,
                use_true_n=self.use_true_n,
            )
            for i, prof in zip(idxs, outs):
                profiles[i] = prof
        return profiles

    def _as_result(self, specs, profiles) -> SweepResult:
        verdicts = [bottleneck.classify(p) for p in profiles]
        shifts = bottleneck.detect_shifts(profiles, tol=self.shift_tol)
        utilization = profiler.utilization_sweep(profiles)
        speedups = np.array([
            bottleneck.speedup_estimate(profiles[0], p) for p in profiles])
        return SweepResult(
            device=self.device, specs=list(specs), profiles=list(profiles),
            verdicts=verdicts, shifts=shifts, utilization=utilization,
            speedup_vs_first=speedups)


def sweep_grid(base: WorkloadSpec, axes: Optional[dict] = None, *,
               devices: Sequence[Union[str, Device]] = ("v5e",),
               provider: Union[str, CounterProvider] = "trace",
               parallel: Optional[int] = None,
               shards: int = 1, shard_index: int = 0,
               **session_kw) -> dict[str, SweepResult]:
    """Expand a base spec over a parameter grid and sweep it per device.

    The grid engine's one-call form: ``axes`` are ``WorkloadSpec.grid``
    axes (spec fields -> value lists), ``devices`` is the outermost axis
    (each device is its own ``Session`` — a service-time table is a
    per-device artifact, so a device cannot be an in-spec axis).  Returns
    ``{device_name: SweepResult}`` in the given device order::

        results = sweep_grid(
            WorkloadSpec.from_indices(idx, 256, label="uniform"),
            {"waves_per_tile": [4, 8, 32], "pipeline_depth": [2, 4]},
            devices=("v5e", "v5p"), parallel=8)

    Extra keyword arguments are forwarded to each ``Session`` (e.g.
    ``cache_dir``, ``use_true_n``, ``shift_tol``).
    ``shards``/``shard_index`` stride the expanded grid the same way
    ``Session.sweep`` does — every device sweeps this shard's slice.
    """
    specs = base.grid(**axes) if axes else [base]
    out: dict[str, SweepResult] = {}
    for dev in devices:
        sess = Session(dev, provider=provider, **session_kw)
        out[sess.device.name] = sess.sweep(
            specs, parallel=parallel, shards=shards, shard_index=shard_index)
    return out
