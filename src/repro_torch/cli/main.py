"""``python -m repro_torch`` — the paper's tool as a command line.

Twelve subcommands over the ``repro_torch.analysis`` Session API:

    devices    list registered devices and their table-cache state
    profile    one workload -> utilization report + verdict
    heatmap    per-bin contention attribution for one workload point:
               hit/replay counts per destination bin, per-bin max wave
               degree, and the per-wave contention sparkline
               (repro_torch.obs.heatmap)
    sweep      cartesian grid sweep (sizes x geometry), batch-collected;
               --shards N --shard-index i slices the grid across
               processes (merging through the persistent counter cache),
               --merge assembles the full grid from the cache
    advise     search workload transforms, rank model-predicted fixes
    validate   multi-provider counter comparison (paper §5)
    compare    the §5 hist-vs-hist2 case study with a shift verdict
    audit      static contention lint of a step: a zoo config captured
               on meta tensors (--config, --all) or a dumped HLO module
               (--hlo-file); can gate CI via --fail-on and emit SARIF
    lint       static atomic-contention and race lint of the port's CUDA
               kernels (KERN rules): each launch as declared beside its
               launcher, its index stream traced from torch; the same
               gate, formats and SARIF as audit
    cache      persistent counter-cache maintenance: stats (entries,
               bytes, quarantined corrupt files, per-provider
               breakdown), clear, and prune --max-bytes
               (LRU-by-mtime eviction; always removes quarantined
               and orphaned tmp files first)
    serve      long-running localhost profiling daemon: JSON jobs over
               HTTP onto a bounded worker pool sharing one memo +
               persistent counter cache, with retries, per-call
               timeouts, circuit breakers and degraded fallbacks
               (see repro_torch.service)
    client     stdlib HTTP client for a running daemon: health,
               status, schema, and job submission (loads no torch)

``audit`` and ``lint`` gate like the reference's (``--fail-on``,
``--suppress``, ``--advise``, ``--num-cores``, ``--no-artifact``): the
report lands under ``results/torch/cli/audit/`` or ``.../lint/`` and a
non-suppressed finding at or above the gate makes exit code 1;
``--advise`` runs the advisor on every gating finding and attaches the
top-ranked transform.  Neither launches a kernel or needs a card.
``--config`` and ``--all`` capture each step of the zoo configs on meta
tensors (``repro_torch.audit.zoo``) and audit the captured graphs, which
land under ``results/torch/cli/audit/graph/`` where the reference writes
HLO.

Every command prints its report to stdout (``--format text|json|csv``;
``devices`` and ``validate`` render ``text|json`` only, ``audit`` and
``lint`` add ``sarif`` — unsupported values are rejected by argparse
``choices`` before any work happens)
and can persist it with ``--output PATH``; ``heatmap``, ``sweep``,
``advise`` and ``compare`` additionally drop an artifact under
``results/torch/cli/`` unless told not to, and ``sweep``, ``advise`` and
``compare`` cache the collected counters under ``results/torch/cache/``
(``--no-cache`` opts out) so a repeated run skips collection and goes
straight to the columnar batch model evaluation.  ``REPRO_TORCH_RESULTS``
moves ``results/torch/``.

The instrumented kernels (``--provider kernel``, ``validate``'s
``kernel`` provider, ``advise --validate-top N``, ``serve`` with
``kernel`` as its provider or a fallback) run on
``--torch-device`` (default ``cuda``); ``--torch-device cpu`` runs their
plain versions.  Without a card a command that needs them is refused up
front (exit code 2) — nothing falls back to the CPU by itself.
``--provider trace`` is host numpy wherever it runs.

The CLI builds ordinary ``WorkloadSpec``s and calls the same Session
methods the Python API exposes, so its numbers are bit-identical to a
scripted run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from repro_torch import __version__
from repro_torch.analysis import (DEVICES, InstrumentedKernelProvider,
                                  Session, WorkloadSpec)
from repro_torch.cli import workloads as wl
from repro_torch.core import bottleneck

DEFAULT_JOBS = 8   # sweep-parallelism knob (thread pool over providers)


def _positive_int(text: str) -> int:
    """argparse type: an integer >= 1 (rejects 0/-N up front, exit 2)."""
    try:
        value = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid int value: {text!r}")
    if value < 1:
        raise argparse.ArgumentTypeError(
            f"must be a positive integer, got {text!r}")
    return value


def _nonneg_int(text: str) -> int:
    """argparse type: an integer >= 0."""
    try:
        value = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid int value: {text!r}")
    if value < 0:
        raise argparse.ArgumentTypeError(
            f"must be a non-negative integer, got {text!r}")
    return value


def _positive_float(text: str) -> float:
    """argparse type: a finite float > 0."""
    try:
        value = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid float value: {text!r}")
    if not value > 0 or value != value or value == float("inf"):
        raise argparse.ArgumentTypeError(
            f"must be a positive finite number, got {text!r}")
    return value


def _rate(text: str) -> float:
    """argparse type: a probability in [0, 1]."""
    try:
        value = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid float value: {text!r}")
    if not 0.0 <= value <= 1.0:
        raise argparse.ArgumentTypeError(
            f"must be in [0, 1], got {text!r}")
    return value


def _port(text: str) -> int:
    """argparse type: a TCP port (0 = ephemeral, for serve only)."""
    try:
        value = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid int value: {text!r}")
    if not 0 <= value <= 65535:
        raise argparse.ArgumentTypeError(
            f"must be a port in [0, 65535], got {text!r}")
    return value


def _torch_device(text: str) -> str:
    """argparse type: a device string torch understands (cuda, cuda:0, cpu)."""
    import torch   # here, not at import: `--version` loads no torch

    try:
        torch.device(text)
    except RuntimeError:
        raise argparse.ArgumentTypeError(f"invalid torch device: {text!r}")
    return text


def results_dir() -> Path:
    """``results/torch/`` at the repo root (``REPRO_TORCH_RESULTS``
    overrides).

    Delegates to the one shared resolution rule in
    ``repro_torch.analysis.sweep_cache`` so CLI artifacts and the
    persistent counter cache can never disagree about where results live.
    """
    from repro_torch.analysis.sweep_cache import results_root
    return results_root()


def _emit(report: str, args, default_artifact: Optional[str] = None) -> None:
    """Print the report; persist it when asked (or by default for sweeps).

    stdout carries only the report (parseable json/csv); the artifact
    path goes to stderr so piping the output stays clean.
    """
    sys.stdout.write(report if report.endswith("\n") else report + "\n")
    path = getattr(args, "output", None)
    if path is None and default_artifact is not None \
            and not getattr(args, "no_artifact", False):
        path = results_dir() / "cli" / default_artifact
    if path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(report)
        print(f"wrote {path}", file=sys.stderr)


def _provider(args, name: str):
    """A provider name as the session takes it: ``kernel`` becomes an
    ``InstrumentedKernelProvider`` on ``--torch-device``, never the
    registered instance (which launches on ``cuda`` whatever was asked)."""
    if name == "kernel":
        return InstrumentedKernelProvider(torch_device=args.torch_device)
    return name


def _session(args) -> Session:
    return Session(args.device, provider=_provider(args, args.provider),
                   cache_dir=args.cache_dir,
                   shift_tol=getattr(args, "shift_tol", bottleneck.SHIFT_TOL))


def _sweep_cache(args):
    """Sweep commands cache collected counters under results/torch/cache/.

    A re-run of the same sweep (same provider + content fingerprints +
    device calibration) then skips counter collection entirely and goes
    straight to the batch model evaluation.  ``--no-cache`` opts out;
    the cache root follows ``results_dir()`` (so ``REPRO_TORCH_RESULTS``
    relocates it, and ``rm -rf results/torch/cache`` clears it).
    """
    if getattr(args, "no_cache", False):
        return False
    from repro_torch.analysis import SweepCache
    return SweepCache()   # default root: results_dir() / "cache"


# -- subcommands -------------------------------------------------------------


def cmd_devices(args) -> int:
    rows = [DEVICES[name].describe(args.cache_dir)
            for name in sorted(DEVICES)]
    if args.format == "json":
        _emit(json.dumps(rows, indent=2), args)
        return 0
    lines = [f"{len(rows)} registered device(s):"]
    for r in rows:
        cached = "cached" if r["table_cached"] else "not built"
        lines.append(
            f"  {r['name']:>6}  {r['cores']} cores  "
            f"{r['clock_ghz']:.2f} GHz  {r['hbm_gbps']:7.0f} GB/s  "
            f"table: {cached:>9}  {r['description']}")
    _emit("\n".join(lines), args)
    return 0


def _one_spec(args, what: str) -> WorkloadSpec:
    specs, axes = wl.build_specs(args)
    specs = wl.expand_grid(specs, axes)
    if len(specs) != 1:
        raise ValueError(
            f"{args.command} takes exactly one workload point, got "
            f"{len(specs)}{what}")
    return specs[0]


def cmd_profile(args) -> int:
    spec = _one_spec(args, " — use 'sweep' for multi-value axes")
    sess = _session(args)
    sess.profile(spec)
    _emit(sess.report(args.format), args)
    return 0


def cmd_heatmap(args) -> int:
    """Per-bin contention attribution for exactly one workload point."""
    spec = _one_spec(args, " — use 'sweep' for multi-value axes")
    sess = _session(args)
    hm = sess.heatmap(spec, hot_degree=args.hot_degree)
    ext = {"text": "txt", "json": "json", "csv": "csv"}[args.format]
    _emit(hm.render(args.format, top_k=args.top_k), args,
          default_artifact=f"heatmap-{spec.label}.{ext}")
    return 0


def cmd_sweep(args) -> int:
    """Grid sweep; also one shard of a distributed sweep, or its merge.

    ``--shards N --shard-index i`` sweeps the deterministic stride
    ``specs[i::N]`` of the full grid — run one process per shard (any
    order, even concurrently: cache writes are atomic) and they share
    the persistent counter cache as the backing store.  ``--merge``
    then sweeps the full grid normally; with every point already cached
    it collects nothing and renders bit-identically to a single-process
    sweep (missing points are simply re-collected — the cache is an
    accelerator, never a correctness input).
    """
    base_specs, axes = wl.build_specs(args)
    specs = wl.expand_grid(base_specs, axes)
    devices = args.devices or [args.device]
    jobs = args.jobs if args.jobs is not None else min(DEFAULT_JOBS,
                                                       len(specs))
    results = {}
    stats = {"collected": 0, "memo_hits": 0, "disk_hits": 0}
    for dev in devices:
        sess = Session(dev, provider=_provider(args, args.provider),
                       cache_dir=args.cache_dir, shift_tol=args.shift_tol,
                       persistent_cache=_sweep_cache(args))
        results[sess.device.name] = sess.sweep(
            specs, parallel=jobs, shards=args.shards,
            shard_index=args.shard_index)
        for k in stats:
            stats[k] += sess.stats[k]
    tag = "-".join(results)
    if args.shards > 1:
        # per-shard artifact names keep concurrent shard processes from
        # overwriting each other's reports
        tag += f"-shard{args.shard_index}of{args.shards}"
    ext = {"text": "txt", "json": "json", "csv": "csv"}[args.format]
    report = _render_sweeps(results, args.format)
    if args.format == "text":
        # collection accounting footer (text only: json/csv stay parseable
        # and bit-identical between cold and warm runs)
        report = (report if report.endswith("\n") else report + "\n") + (
            f"cache: {stats['collected']} collected, "
            f"{stats['memo_hits']} memo hits, "
            f"{stats['disk_hits']} disk hits\n")
    _emit(report, args, default_artifact=f"sweep-{tag}.{ext}")
    return 0


def _render_sweeps(results: dict, fmt: str) -> str:
    """Render one or several per-device SweepResults as a single report.

    The single-device case is exactly ``SweepResult.render`` (the Session
    API's own output); a device axis nests json under device names and
    prefixes csv rows with a ``device`` column.
    """
    if len(results) == 1:
        return next(iter(results.values())).render(fmt)
    if fmt == "json":
        payload = {name: json.loads(r.render("json"))
                   for name, r in results.items()}
        return json.dumps({"devices": payload}, indent=2)
    if fmt == "csv":
        from repro_torch.analysis.render import rows_to_csv
        rows = []
        for name, r in results.items():
            for row in r.to_rows():
                rows.append({"device": name, **row})
        return rows_to_csv(rows)
    return "\n".join(r.render("text") for r in results.values())


def cmd_advise(args) -> int:
    """Model-driven optimization advisor over one workload point.

    Enumerates transform compositions around the workload (channel
    rotation, bin replication, CAS→FAO substitution, launch geometry,
    lane interleave), scores every frontier with one columnar
    ``profile_batch`` evaluation, and prints the ranked predicted fixes.
    Counter collection is cache-aware like ``sweep``
    (``results/torch/cache/`` by default, ``--no-cache`` opts out), so
    re-advising a workload collects nothing; ``--validate-top N``
    re-checks the N top-ranked kernel-source candidates through the
    instrumented kernels on ``--torch-device`` (paper §5's
    model-vs-measured).
    """
    spec = _one_spec(args, " — the advisor searches the transform space "
                           "itself")
    sess = Session(args.device, provider=_provider(args, args.provider),
                   cache_dir=args.cache_dir,
                   persistent_cache=_sweep_cache(args))
    report = sess.advise(
        spec, depth=args.depth, beam_width=args.beam_width,
        top_k=args.top_k, validate_top=args.validate_top,
        parallel=args.jobs, kernel_provider=_provider(args, "kernel"))
    ext = {"text": "txt", "json": "json", "csv": "csv"}[args.format]
    _emit(report.render(args.format), args,
          default_artifact=f"advise-{sess.device.name}.{ext}")
    return 0


def cmd_validate(args) -> int:
    spec = _one_spec(args, "")
    sess = _session(args)
    report = sess.validate(
        spec, providers=[_provider(args, p) for p in args.providers])
    _emit(report.render(args.format), args)
    return 0


def cmd_compare(args) -> int:
    """Rerun the paper's §5 hist-vs-hist2 case study end to end.

    Mirrors ``examples/torch_histogram_casestudy.py``: the device carries
    the case study's LLC emulation (``--llc-bytes``/``--miss-latency``/
    ``--hide-concurrency``), every (kind, size) is profiled under both
    the naive ``hist`` and the conflict-reordered ``hist2`` kernel, and
    the report carries both verdicts, the modeled speedup, the per-pair
    bottleneck shift, and the size-axis shift events per variant — the
    paper's headline result as one command.  All numbers come from the
    same ``Session.sweep`` the Python API runs, so they are bit-identical
    to a scripted session.
    """
    from repro_torch.analysis import get_device
    from repro_torch.core.profiler import CacheModel
    device = get_device(args.device).with_(cache=CacheModel(
        llc_bytes=args.llc_bytes, miss_latency_cycles=args.miss_latency,
        hide_concurrency=args.hide_concurrency))
    sess = Session(device, provider=_provider(args, args.provider),
                   cache_dir=args.cache_dir, shift_tol=args.shift_tol,
                   persistent_cache=_sweep_cache(args))

    def spec(kind, px, variant):
        img = wl.make_image(kind, px, seed=args.seed)
        return WorkloadSpec.from_histogram(
            img, label=f"{kind}/{px}px/{variant}", variant=variant,
            num_bins=args.num_bins, num_cores=args.num_cores,
            waves_per_tile=args.waves_per_tile,
            overhead_cycles=args.overhead_cycles)

    rows, size_shifts = [], []
    for kind in args.kind:
        # size-axis sweeps per variant (the casestudy's shift detection);
        # their counters populate the memo, so the per-size pair sweeps
        # below re-profile without re-collecting
        for variant in ("hist", "hist2"):
            res = sess.sweep([spec(kind, px, variant) for px in args.pixels],
                             parallel=args.jobs)
            size_shifts.extend(
                f"{kind}/{variant}: {s.unit_before}->{s.unit_after} "
                f"({s.label_before} -> {s.label_after})"
                for s in res.shifts)
        for px in args.pixels:
            result = sess.sweep(
                [spec(kind, px, "hist"), spec(kind, px, "hist2")])
            h, h2 = result.profiles
            shift = result.shifts[0] if result.shifts else None
            rows.append({
                "kind": kind,
                "pixels": px,
                "hist_U": h.scatter_utilization,
                "hist_bottleneck": h.bottleneck,
                "hist2_U": h2.scatter_utilization,
                "hist2_bottleneck": h2.bottleneck,
                "speedup": float(result.speedup_vs_first[1]),
                "shift": (f"{shift.unit_before}->{shift.unit_after}"
                          if shift else ""),
            })
    relieved = sum(1 for r in rows if r["hist_bottleneck"] == "scatter"
                   and r["hist2_bottleneck"] != "scatter")
    if relieved:
        verdict = (f"hist2 reordering moves the bottleneck off the "
                   f"shared-memory atomic unit at {relieved}/{len(rows)} "
                   f"points")
    elif size_shifts:
        verdict = (f"hist2 lowers scatter utilization but the leading unit "
                   f"is unchanged at every size; the bottleneck shifts "
                   f"along the size axis instead ({len(size_shifts)} "
                   f"event(s), see size-axis lines)")
    else:
        verdict = ("no bottleneck shift: hist2 reordering does not relieve "
                   "the shared-memory atomic unit at any swept point")

    if args.format == "json":
        payload = {"device": sess.device.name, "points": rows,
                   "size_shifts": size_shifts, "verdict": verdict}
        report = json.dumps(payload, indent=2)
    elif args.format == "csv":
        import csv as csv_mod
        import io
        buf = io.StringIO()
        w = csv_mod.DictWriter(buf, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
        report = buf.getvalue()
    else:
        lines = [f"== compare: hist vs hist2 on {sess.device.name} =="]
        for r in rows:
            shift = f"  shift: {r['shift']}" if r["shift"] else ""
            lines.append(
                f"{r['kind']:>8} {r['pixels']:>9}px  "
                f"hist U={r['hist_U']:6.2%} ({r['hist_bottleneck']})  "
                f"hist2 U={r['hist2_U']:6.2%} ({r['hist2_bottleneck']})  "
                f"speedup x{r['speedup']:.2f}{shift}")
        for line in size_shifts:
            lines.append(f"size-axis bottleneck shift: {line}")
        lines.append(f"verdict: {verdict}")
        report = "\n".join(lines)
    ext = {"text": "txt", "json": "json", "csv": "csv"}[args.format]
    _emit(report, args,
          default_artifact=f"compare-{sess.device.name}.{ext}")
    return 0


def cmd_audit(args) -> int:
    """Static contention lint of a step — zero kernel executions.

    Targets: ``--config NAME`` captures each applicable step of one zoo
    config on meta tensors (``launch.lowering.build_captured``), ``--all``
    audits the whole zoo, ``--hlo-file PATH`` audits an already-dumped
    HLO module.  The scanned graphs are written under
    ``results/torch/cli/audit/graph/`` so SARIF result locations point at
    real, openable artifacts; ``--fail-on SEVERITY`` turns findings at or
    above that severity into exit code 1 (the CI gate).
    """
    from repro_torch import audit as audit_mod

    sess = Session(args.device, cache_dir=args.cache_dir)
    audit_dir = results_dir() / "cli" / "audit"
    dump = not args.no_artifact

    def sink_for(config: str):
        def sink(step: str, text: str) -> str:
            rel = f"graph/{config.replace('-', '_')}__{step}.graph"
            if dump:
                path = audit_dir / rel
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(text)
            # SARIF artifact URIs are relative to the report's directory
            return rel
        return sink

    if args.hlo_file:
        text = Path(args.hlo_file).read_text()
        label = Path(args.hlo_file).stem
        report = audit_mod.audit_hlo(
            text, session=sess, label=label,
            suppress=args.suppress or (), hlo_uri=args.hlo_file,
            num_cores=args.num_cores)
    else:
        from repro_torch.audit import zoo
        if args.all:
            configs = sorted(zoo.ARCHS)
        elif args.config:
            configs = [zoo.normalize_arch(c) for c in args.config]
        else:
            raise ValueError(
                "audit needs a target: --config NAME, --all, or "
                "--hlo-file PATH")
        reports = []
        for config in configs:
            reports.append(audit_mod.audit_config(
                config, session=sess, steps=args.steps,
                reduced=args.reduced, variant=args.variant,
                extra_suppress=args.suppress or (),
                hlo_sink=sink_for(config), num_cores=args.num_cores))
        report = (reports[0] if len(reports) == 1
                  else audit_mod.merge(reports))
    return _finish_findings(report, args, sess, tool="audit")


def cmd_lint(args) -> int:
    """Static lint of the port's CUDA kernels — zero kernel launches.

    Models each registered kernel (``--kernel`` selects a subset; default
    all) from the launch its launcher declares and the index stream
    traced from torch on meta tensors, and rates its atomic sites.
    Affine index streams get exact static degree counters (bit-for-bit
    the trace provider's); data-dependent ones emit KERN005 findings
    carrying a ``WorkloadSpec`` for dynamic audit.  Shares the audit's
    gate/artifact/SARIF tail, so ``lint --format sarif`` merges cleanly
    with audit logs.
    """
    from repro_torch import lint as lint_mod

    if getattr(args, "list", False):
        _emit("\n".join(lint_mod.kernel_names()), args)
        return 0
    sess = Session(args.device, cache_dir=args.cache_dir)
    names = args.kernel or None
    if names and len(names) == 1:
        report = lint_mod.lint_kernel(
            names[0], session=sess, suppress=args.suppress or (),
            num_cores=args.num_cores)
    else:
        report = lint_mod.lint_registry(
            names, session=sess, suppress=args.suppress or (),
            num_cores=args.num_cores)
    return _finish_findings(report, args, sess, tool="lint")


def _finish_findings(report, args, sess, *, tool: str) -> int:
    """The ``audit``/``lint`` report tail (one implementation).

    Optionally attaches advisor picks (``--advise``), renders and
    persists the report under ``results/torch/cli/<tool>/``, then
    converts ``--fail-on`` gating into the process exit code.
    """
    from repro_torch import audit as audit_mod

    if getattr(args, "advise", False):
        audit_mod.attach_advice(report, sess)
    ext = {"text": "txt", "json": "json", "csv": "csv",
           "sarif": "sarif"}[args.format]
    _emit(report.render(args.format), args,
          default_artifact=f"{tool}/{tool}-{report.label}.{ext}")
    rc = audit_mod.exit_code(report, args.fail_on)
    if rc:
        gated = report.gated(args.fail_on)
        print(f"{tool}: {len(gated)} finding(s) at or above "
              f"--fail-on {args.fail_on}", file=sys.stderr)
    return rc


def cmd_cache(args) -> int:
    """Persistent counter-cache maintenance (``results/torch/cache/``).

    ``stats`` reports entry count, bytes on disk, and a per-provider
    breakdown (recovered from each entry's stored ``source`` field);
    ``clear`` removes everything; ``prune --max-bytes N`` evicts
    least-recently-written entries (LRU by mtime — every cache write
    refreshes it) until at most N bytes remain — the size bound a
    long-running shared cache needs.
    """
    from repro_torch.analysis import SweepCache

    def fmt_bytes(n: int) -> str:
        return f"{n / 1e6:.2f} MB" if n >= 1e5 else f"{n} B"

    cache = SweepCache()
    if args.action == "stats":
        stats = cache.stats()
        if args.format == "json":
            _emit(json.dumps(stats, indent=2), args)
            return 0
        lines = [f"cache root: {stats['root']}",
                 f"{stats['entries']} entries, {fmt_bytes(stats['bytes'])}"]
        if stats["quarantined"]:
            lines.append(f"{stats['quarantined']} quarantined corrupt "
                         f"file(s) — 'cache prune' deletes them")
        for source, b in stats["by_provider"].items():
            lines.append(f"  {source:>12}  {b['entries']:>6} entries  "
                         f"{fmt_bytes(b['bytes']):>12}")
        _emit("\n".join(lines), args)
        return 0
    if args.action == "clear":
        removed = cache.clear()
        _emit(f"removed {removed} cache entries", args)
        return 0
    # prune (quarantined/tmp litter always goes; --max-bytes adds LRU)
    removed, freed = cache.prune(args.max_bytes)
    stats = cache.stats()
    _emit(f"pruned {removed} entries ({fmt_bytes(freed)}); "
          f"{stats['entries']} left ({fmt_bytes(stats['bytes'])})", args)
    return 0


def cmd_serve(args) -> int:
    """Run the localhost profiling daemon until interrupted.

    All resilience knobs (workers, queue depth, deadlines, retries,
    breaker thresholds, fault-injection rates for chaos testing) come in
    as flags, are range-checked up front by the argparse types, and land
    in one ``ServiceConfig``; the daemon itself lives in
    ``repro_torch.service``.  With ``kernel`` in its chain it builds and
    loads the kernels on ``--torch-device`` before it binds the port.
    """
    from repro_torch.service import ServiceConfig
    from repro_torch.service.server import serve

    config = ServiceConfig(
        host=args.host, port=args.port, workers=args.workers,
        queue_depth=args.queue_depth, device=args.device,
        provider=args.provider, fallbacks=tuple(args.fallbacks),
        timeout_s=args.timeout, max_timeout_s=args.max_timeout,
        max_points=args.max_points, call_timeout_s=args.call_timeout,
        retries=args.retries, backoff_base_s=args.backoff_base,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown,
        persistent_cache=not args.no_cache,
        fault_rate=args.fault_rate, latency_rate=args.latency_rate,
        latency_s=args.latency_s, corrupt_rate=args.corrupt_rate,
        fault_seed=args.fault_seed, torch_device=args.torch_device)
    serve(config, port_file=args.port_file)
    return 0


def cmd_client(args) -> int:
    """Talk to a running daemon (health / status / schema / submit)."""
    from repro_torch.service import ServiceClient, ServiceError

    client = ServiceClient(args.host, args.port, timeout_s=args.timeout)
    try:
        if args.action == "submit":
            if args.job_file:
                payload = json.loads(Path(args.job_file).read_text())
            else:
                payload = json.loads(args.job)
            body = client.submit(payload,
                                 retries_on_busy=args.retries_on_busy)
        else:
            body = getattr(client, args.action)()
    except ServiceError as exc:
        print(f"error: {exc}" + (f" (HTTP {exc.status})"
                                 if exc.status else ""), file=sys.stderr)
        return 1
    except json.JSONDecodeError as exc:
        print(f"error: job payload is not valid JSON: {exc}",
              file=sys.stderr)
        return 2
    _emit(json.dumps(body, indent=2), args)
    return 0


# -- parser ------------------------------------------------------------------


def _add_common(p: argparse.ArgumentParser, *, formats=("text", "json",
                                                        "csv")) -> None:
    p.add_argument("--device", default="v5e",
                   help="modeled device registry name (see 'devices'; "
                        "default v5e)")
    p.add_argument("--provider", default="trace",
                   help="counter provider: trace|kernel|hlo|microbench "
                        "(default trace; hlo workloads auto-route to hlo)")
    p.add_argument("--torch-device", type=_torch_device, default="cuda",
                   help="where the instrumented kernels run (default "
                        "cuda; cpu runs their plain versions)")
    p.add_argument("--format", choices=formats, default="text",
                   help="report format (default text)")
    p.add_argument("--output", metavar="PATH", default=None,
                   help="also write the report to PATH")
    p.add_argument("--cache-dir", default=None,
                   help="service-time table cache dir "
                        "(default results/torch/tables/)")


def _add_gate(p: argparse.ArgumentParser, *, tool: str) -> None:
    """The gating + artifact surface of ``audit`` and ``lint``."""
    p.add_argument("--fail-on", default="error",
                   choices=("never", "note", "warning", "error"),
                   help="exit 1 when any non-suppressed finding is at or "
                        "above this severity (default error)")
    p.add_argument("--suppress", nargs="+", default=None, metavar="RULE",
                   help="suppress rule ids (adds to in-source "
                        "# repro: noqa comments)")
    p.add_argument("--advise", action="store_true",
                   help="run the advisor on every gating finding and "
                        "attach the top-ranked transform (predicted "
                        "speedup + post-transform bottleneck)")
    p.add_argument("--num-cores", type=int, default=8,
                   help="cores the synthesized streams are scored on "
                        "(default 8)")
    p.add_argument("--no-artifact", action="store_true",
                   help=f"do not write the report artifacts under "
                        f"results/torch/cli/{tool}/")


def _add_workload(p: argparse.ArgumentParser, *, multi: bool) -> None:
    n = {"nargs": "+"} if multi else {}
    g = p.add_argument_group("workload")
    g.add_argument("--workload", choices=wl.WORKLOADS, default="indices",
                   help="workload family (default indices)")
    g.add_argument("--size", type=wl.parse_int, default=None, **n,
                   help="index-stream length, e.g. 65536 or 2^16 "
                        "(indices/scatter)")
    g.add_argument("--pixels", type=wl.parse_int, default=None, **n,
                   help="image pixels, e.g. 2^20 (histogram)")
    g.add_argument("--dist", choices=("solid", "uniform"), default="uniform",
                   help="stream/image contents: solid=max contention, "
                        "uniform=low (default uniform)")
    g.add_argument("--variant", choices=("hist", "hist2"), default="hist",
                   help="histogram kernel variant (hist2 = conflict "
                        "reordering; default hist)")
    g.add_argument("--num-bins", type=int, default=256)
    g.add_argument("--num-segments", type=int, default=256,
                   help="scatter-add destination segments (default 256)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--label", default=None,
                   help="base label (default derived from the arguments)")
    g.add_argument("--hlo-file", default=None,
                   help="post-optimization HLO module text (hlo workload)")
    g.add_argument("--num-devices", type=int, default=1,
                   help="chips for HLO collective accounting (default 1)")
    geo = p.add_argument_group("launch geometry / roofline")
    geo.add_argument("--waves-per-tile", type=int, default=None, **n)
    geo.add_argument("--pipeline-depth", type=int, default=None, **n)
    geo.add_argument("--num-cores", type=int, default=8)
    geo.add_argument("--bytes-read", type=float, default=None)
    geo.add_argument("--flops", type=float, default=None)
    geo.add_argument("--overhead-cycles", type=float, default=500.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch",
        description="Shared-memory atomic bottleneck profiler "
                    "(the paper's two tools as a command line, with the "
                    "instrumented kernels on an NVIDIA GPU)")
    # handled by argparse before subcommand dispatch: `repro_torch
    # --version` exits 0 without requiring (or running) any subcommand
    ap.add_argument("--version", action="version",
                    version=f"%(prog)s {__version__}")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("devices", help="list registered devices")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--output", metavar="PATH", default=None)
    p.add_argument("--cache-dir", default=None)
    p.set_defaults(func=cmd_devices)

    p = sub.add_parser("profile", help="profile one workload point")
    _add_common(p)
    _add_workload(p, multi=False)
    p.set_defaults(func=cmd_profile)

    p = sub.add_parser(
        "heatmap", help="per-bin contention attribution for one point")
    _add_common(p)
    _add_workload(p, multi=False)
    p.add_argument("--top-k", type=_positive_int, default=16,
                   help="bins shown in the text/json grid (default 16)")
    p.add_argument("--hot-degree", type=_positive_float, default=2.0,
                   help="wave degree at or above which a bin counts as "
                        "hot (default 2.0)")
    p.add_argument("--no-artifact", action="store_true",
                   help="do not write the report under results/torch/cli/")
    p.set_defaults(func=cmd_heatmap)

    p = sub.add_parser(
        "sweep", help="grid sweep: sizes x geometry, concurrent points")
    _add_common(p)
    _add_workload(p, multi=True)
    p.add_argument("--devices", nargs="+", default=None, metavar="DEV",
                   help="sweep the grid on several devices "
                        "(outermost axis; overrides --device)")
    p.add_argument("--jobs", type=_positive_int, default=None,
                   help=f"concurrent collection threads (default "
                        f"min({DEFAULT_JOBS}, points); 1 = serial)")
    p.add_argument("--shards", type=_positive_int, default=1,
                   help="split the grid into this many deterministic "
                        "stride slices; this process sweeps only "
                        "--shard-index's slice (shards merge through the "
                        "persistent counter cache; default 1)")
    p.add_argument("--shard-index", type=_nonneg_int, default=0,
                   help="which slice of a --shards split this process "
                        "owns (0-based; default 0)")
    p.add_argument("--merge", action="store_true",
                   help="assemble the full grid from the persistent "
                        "counter cache (a warm full sweep: collects "
                        "nothing when every shard has run; incompatible "
                        "with --shards/--no-cache)")
    p.add_argument("--shift-tol", type=float, default=bottleneck.SHIFT_TOL,
                   help="relative lead a new unit needs to count as a "
                        "bottleneck shift (default %(default)s)")
    p.add_argument("--no-artifact", action="store_true",
                   help="do not write the default results/torch/cli/ "
                        "artifact")
    p.add_argument("--no-cache", action="store_true",
                   help="do not read/write the results/torch/cache/ "
                        "counter cache (re-collect every point)")
    p.set_defaults(func=cmd_sweep)

    p = sub.add_parser(
        "advise",
        help="search workload transforms, rank predicted fixes")
    _add_common(p)
    _add_workload(p, multi=False)
    p.add_argument("--top-k", type=int, default=5,
                   help="how many ranked candidates to report "
                        "(default %(default)s)")
    p.add_argument("--validate-top", type=int, default=0,
                   help="re-validate the N top-ranked kernel-source "
                        "candidates via the kernel provider on "
                        "--torch-device (default 0)")
    p.add_argument("--depth", type=int, default=2,
                   help="max transforms composed per candidate "
                        "(default %(default)s)")
    p.add_argument("--beam-width", type=int, default=8,
                   help="compositions each search level extends "
                        "(default %(default)s)")
    p.add_argument("--jobs", type=_positive_int, default=None,
                   help="concurrent collection threads per frontier")
    p.add_argument("--no-artifact", action="store_true",
                   help="do not write the default results/torch/cli/ "
                        "artifact")
    p.add_argument("--no-cache", action="store_true",
                   help="do not read/write the results/torch/cache/ "
                        "counter cache (re-collect every candidate)")
    p.set_defaults(func=cmd_advise)

    p = sub.add_parser(
        "validate",
        help="multi-provider counter comparison (paper §5)")
    _add_common(p, formats=("text", "json"))
    _add_workload(p, multi=False)
    p.add_argument("--providers", nargs="+", default=["trace", "kernel"],
                   help="first provider is the reference "
                        "(default: trace kernel)")
    p.set_defaults(func=cmd_validate)

    p = sub.add_parser(
        "compare",
        help="§5 case study: hist vs hist2 bottleneck-shift verdict")
    _add_common(p)
    p.add_argument("--kind", nargs="+", choices=("solid", "uniform"),
                   default=["solid", "uniform"])
    p.add_argument("--pixels", type=wl.parse_int, nargs="+",
                   default=[2 ** 14, 2 ** 17, 2 ** 20])
    p.add_argument("--waves-per-tile", type=int, default=8,
                   help="launch occupancy (default 8, the casestudy's "
                        "shift-study setting)")
    p.add_argument("--num-bins", type=int, default=256)
    p.add_argument("--num-cores", type=int, default=8)
    p.add_argument("--overhead-cycles", type=float, default=500.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shift-tol", type=float, default=bottleneck.SHIFT_TOL)
    # the casestudy's LLC emulation (examples/torch_histogram_casestudy.py)
    p.add_argument("--llc-bytes", type=wl.parse_int, default=1 << 21)
    p.add_argument("--miss-latency", type=float, default=800.0)
    p.add_argument("--hide-concurrency", type=float, default=48.0)
    p.add_argument("--jobs", type=_positive_int, default=None,
                   help="concurrent collection threads per sweep")
    p.add_argument("--no-artifact", action="store_true")
    p.add_argument("--no-cache", action="store_true",
                   help="do not read/write the results/torch/cache/ "
                        "counter cache (re-collect every point)")
    p.set_defaults(func=cmd_compare)

    p = sub.add_parser(
        "audit",
        help="static contention lint over the model zoo (SARIF, "
             "CI gate)")
    _add_common(p, formats=("text", "json", "csv", "sarif"))
    p.add_argument("--config", nargs="+", default=None, metavar="NAME",
                   help="zoo config(s) to capture and audit (underscore "
                        "or dash spelling)")
    p.add_argument("--all", action="store_true",
                   help="audit every zoo config")
    p.add_argument("--hlo-file", default=None, metavar="PATH",
                   help="audit an already-dumped HLO module text instead "
                        "of capturing a config")
    p.add_argument("--steps", nargs="+", default=None,
                   choices=("train", "prefill", "decode"),
                   help="steps to capture per config (default: all "
                        "applicable)")
    p.add_argument("--reduced", action="store_true",
                   help="capture reduced configs on smoke shapes (fast; "
                        "same scatter idioms)")
    p.add_argument("--variant", default="base",
                   help="optimization variant for shape tuning "
                        "(default base)")
    _add_gate(p, tool="audit")
    p.set_defaults(func=cmd_audit)

    p = sub.add_parser(
        "lint",
        help="static lint of the port's CUDA kernels (KERN rules, "
             "SARIF, CI gate)")
    _add_common(p, formats=("text", "json", "csv", "sarif"))
    p.add_argument("--kernel", nargs="+", default=None, metavar="NAME",
                   help="registered kernel(s) to lint (default: all; "
                        "see --list)")
    p.add_argument("--list", action="store_true",
                   help="print the registered kernel names and exit")
    _add_gate(p, tool="lint")
    p.set_defaults(func=cmd_lint)

    p = sub.add_parser(
        "cache",
        help="persistent counter-cache maintenance (stats/clear/prune)")
    p.add_argument("action", choices=("stats", "clear", "prune"),
                   help="stats: entry count, bytes, per-provider "
                        "breakdown; clear: remove everything; prune: "
                        "LRU-by-mtime eviction down to --max-bytes")
    p.add_argument("--max-bytes", type=wl.parse_int, default=None,
                   metavar="N",
                   help="prune target: evict least-recently-written "
                        "entries until at most N bytes remain "
                        "(accepts 2^20 notation; required for prune)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--output", metavar="PATH", default=None)
    p.set_defaults(func=cmd_cache)

    p = sub.add_parser(
        "serve",
        help="run the localhost profiling daemon (see repro_torch.service)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1 — localhost "
                        "only)")
    p.add_argument("--port", type=_port, default=8642,
                   help="TCP port; 0 binds an ephemeral port, printed "
                        "on start (default %(default)s)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the bound port to PATH (for scripts "
                        "using --port 0)")
    p.add_argument("--workers", type=_positive_int, default=4,
                   help="worker threads (default %(default)s)")
    p.add_argument("--queue-depth", type=_positive_int, default=32,
                   help="pending jobs before 429 load-shedding "
                        "(default %(default)s)")
    p.add_argument("--device", default="v5e",
                   help="default modeled device for sessions (default "
                        "v5e)")
    p.add_argument("--provider", default="trace",
                   help="primary counter provider (default trace)")
    p.add_argument("--fallbacks", nargs="+", default=["trace"],
                   metavar="PROVIDER",
                   help="degraded fallback chain after the primary "
                        "(default: trace)")
    # checked by _validate_args, and only with a kernel in the chain: a
    # trace daemon loads no torch
    p.add_argument("--torch-device", default="cuda",
                   help="where the instrumented kernels run (default "
                        "cuda; cpu runs their plain versions)")
    p.add_argument("--timeout", type=_positive_float, default=30.0,
                   help="default per-job deadline seconds "
                        "(default %(default)s)")
    p.add_argument("--max-timeout", type=_positive_float, default=300.0,
                   help="largest timeout_s a job may request "
                        "(default %(default)s)")
    p.add_argument("--max-points", type=_positive_int, default=4096,
                   help="largest sweep grid a single job may expand to "
                        "(default %(default)s)")
    p.add_argument("--call-timeout", type=_positive_float, default=10.0,
                   help="per-provider-call timeout seconds "
                        "(default %(default)s)")
    p.add_argument("--retries", type=_nonneg_int, default=2,
                   help="transient-failure retries per provider "
                        "(default %(default)s; 0 disables)")
    p.add_argument("--backoff-base", type=_positive_float, default=0.05,
                   help="first retry backoff seconds, doubling per "
                        "attempt (default %(default)s)")
    p.add_argument("--breaker-threshold", type=_positive_int, default=5,
                   help="consecutive failures that open a provider's "
                        "circuit breaker (default %(default)s)")
    p.add_argument("--breaker-cooldown", type=_positive_float, default=5.0,
                   help="seconds an open breaker waits before its "
                        "half-open probe (default %(default)s)")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the persistent counter cache (and with "
                        "it the cached-stale fallback)")
    chaos = p.add_argument_group(
        "fault injection (chaos testing; all off by default)")
    chaos.add_argument("--fault-rate", type=_rate, default=0.0,
                       help="probability a provider call raises an "
                            "injected transient fault")
    chaos.add_argument("--latency-rate", type=_rate, default=0.0,
                       help="probability a provider call sleeps "
                            "--latency-s first")
    chaos.add_argument("--latency-s", type=_positive_float, default=0.05,
                       help="injected latency seconds "
                            "(default %(default)s)")
    chaos.add_argument("--corrupt-rate", type=_rate, default=0.0,
                       help="probability a provider call returns "
                            "structurally corrupt counters")
    chaos.add_argument("--fault-seed", type=_nonneg_int, default=0,
                       help="seed for the deterministic injection "
                            "schedule (default %(default)s)")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser(
        "client",
        help="query or submit jobs to a running daemon")
    p.add_argument("action", choices=("health", "status", "schema",
                                      "submit"),
                   help="health/status/schema: GET endpoints; submit: "
                        "POST one job payload")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=_port, default=8642,
                   help="daemon port (default %(default)s)")
    p.add_argument("--timeout", type=_positive_float, default=60.0,
                   help="HTTP timeout seconds (default %(default)s)")
    p.add_argument("--job", default=None, metavar="JSON",
                   help="inline job payload for submit")
    p.add_argument("--job-file", default=None, metavar="PATH",
                   help="file with the job payload for submit")
    p.add_argument("--retries-on-busy", type=_nonneg_int, default=0,
                   help="retry 429 responses this many times, honoring "
                        "Retry-After (default 0)")
    p.add_argument("--output", metavar="PATH", default=None,
                   help="also write the response to PATH")
    p.set_defaults(func=cmd_client)

    return ap


def _needs_kernel(args) -> bool:
    """Whether the command will launch the instrumented kernels
    (``heatmap`` reads the trace provider's stream whatever the provider,
    and ``audit`` scores synthesized streams with the model;
    ``serve`` does when ``kernel`` is its provider or a fallback)."""
    if args.command == "serve":
        return "kernel" in (args.provider, *args.fallbacks)
    if args.command == "validate":
        return "kernel" in args.providers
    if args.command == "advise" and args.validate_top > 0:
        return True
    return args.command not in ("heatmap", "audit", "lint") \
        and getattr(args, "provider", None) == "kernel"


def _validate_args(ap: argparse.ArgumentParser, args) -> None:
    """Cross-field argument validation, up front (argparse exit code 2).

    Per-field range checks live in the argparse types
    (``_positive_int``/``_nonneg_int``); anything relating two flags, or
    a flag to the machine, is checked here, before any session or device
    work starts.
    """
    shards = getattr(args, "shards", 1)
    shard_index = getattr(args, "shard_index", 0)
    if shard_index >= shards:
        ap.error(f"--shard-index {shard_index} is out of range for "
                 f"--shards {shards} (valid: 0..{shards - 1})")
    if getattr(args, "merge", False):
        if shards > 1 or shard_index:
            ap.error("--merge assembles the full grid from the cache; "
                     "drop --shards/--shard-index")
        if getattr(args, "no_cache", False):
            ap.error("--merge reads the persistent counter cache; it "
                     "cannot be combined with --no-cache")
    if args.command == "cache":
        if args.action == "prune" and args.max_bytes is None:
            ap.error("cache prune requires --max-bytes")
        if args.max_bytes is not None and args.max_bytes < 0:
            ap.error(f"--max-bytes must be >= 0, got {args.max_bytes}")
    if args.command == "serve":
        if args.max_timeout < args.timeout:
            ap.error(f"--max-timeout {args.max_timeout} must be >= "
                     f"--timeout {args.timeout}")
        if args.call_timeout > args.max_timeout:
            ap.error(f"--call-timeout {args.call_timeout} must be <= "
                     f"--max-timeout {args.max_timeout} (a single call "
                     f"may not outlive any job deadline)")
    if args.command == "client":
        if args.port == 0:
            ap.error("--port 0 is only meaningful for serve (ephemeral "
                     "bind); the client needs the daemon's actual port")
        if args.action == "submit":
            if bool(args.job) == bool(args.job_file):
                ap.error("submit needs exactly one of --job JSON or "
                         "--job-file PATH")
        elif args.job or args.job_file:
            ap.error(f"--job/--job-file only apply to submit, not "
                     f"{args.action!r}")
    if not _needs_kernel(args):
        return
    import torch

    if args.command == "serve":
        try:
            _torch_device(args.torch_device)
        except argparse.ArgumentTypeError as exc:
            ap.error(f"argument --torch-device: {exc}")

    if torch.device(args.torch_device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error(f"{args.command} runs the instrumented kernels on "
                 f"--torch-device {args.torch_device}, and no CUDA device "
                 f"is available; pass --torch-device cpu to run their "
                 f"plain versions on the CPU")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    _validate_args(ap, args)
    # hlo specs carry no wave trace: route them to the hlo provider unless
    # the user explicitly picked another backend
    if getattr(args, "workload", None) == "hlo" \
            and getattr(args, "provider", None) == "trace":
        args.provider = "hlo"
    try:
        return args.func(args)
    except (ValueError, KeyError, FileNotFoundError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
