"""The port's command line against the reference's, subcommand by subcommand.

Each case gives the same argv to ``repro.cli.main.main`` and to
``repro_torch.cli.main.main`` (plus ``--torch-device cpu``, so the
port's instrumented kernels run their plain versions; the reference's
run in Pallas interpret mode) and compares the reports: strings,
verdicts, rankings and integer counters bit for bit, floats within rtol
1e-9 (``tests/_port_compare.py``).  The reference's own cases
(``tests/test_cli.py``) are mirrored on the port: the one-point
rejections, the warm cache, bit-identity with a Session run, the
artifacts and the ``python -m repro_torch`` entry point.
"""

import csv as csv_mod
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from _port_compare import (assert_csv_close, assert_json_close,
                           load_example)
from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefSpec
from repro.analysis import get_device as ref_get_device
from repro.cli.main import main as ref_main
from repro.core.profiler import CacheModel as RefCacheModel
from repro.data.images import make_image
from repro_torch.analysis import Session, WorkloadSpec, get_device
from repro_torch.cli.main import build_parser, main
from repro_torch.core.profiler import CacheModel

REPO = os.path.join(os.path.dirname(__file__), "..")
CPU = ["--torch-device", "cpu"]
ANALYSIS = ("devices", "profile", "heatmap", "sweep", "advise", "validate",
            "compare", "audit", "lint")
SERVICE = ("cache", "serve", "client")
PORTED = ANALYSIS + SERVICE


@pytest.fixture(scope="module", autouse=True)
def _tables(tmp_path_factory):
    """One table cache per package for the module (a table takes seconds
    to build; the in-process memo then serves every case)."""
    root = tmp_path_factory.mktemp("tables")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TABLE_CACHE", str(root / "ref"))
        mp.setenv("REPRO_TORCH_TABLE_CACHE", str(root / "port"))
        yield


@pytest.fixture(autouse=True)
def _isolate_artifacts(tmp_path, monkeypatch):
    """Artifacts and counter caches land in a tmpdir, not the repo."""
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "port"))
    yield


def run_cli(argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def both(argv, capsys):
    """(reference stdout, port stdout) for one argv; both must exit 0."""
    rc = ref_main(list(argv))
    ref = capsys.readouterr()
    assert rc == 0, ref.err
    port_argv = list(argv) + ([] if argv[0] == "devices" else CPU)
    rc = main(port_argv)
    port = capsys.readouterr()
    assert rc == 0, port.err
    return ref.out, port.out


def assert_same_report(argv, capsys, fmt):
    want, got = both(argv + ["--format", fmt], capsys)
    if fmt == "json":
        assert_json_close(json.loads(got), json.loads(want))
    elif fmt == "csv":
        assert_csv_close(got, want)
    else:
        assert got == want
    return got


# -- devices ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_devices_equal_reference(capsys, fmt):
    out = assert_same_report(["devices"], capsys, fmt)
    assert "v5e" in out and "v5p" in out


@pytest.mark.parametrize("module", ["repro_torch", "repro_torch.cli"])
def test_python_m_repro_torch_subprocess(module):
    """The real entry points: ``python -m repro_torch`` (and ``.cli``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", module, "devices"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "v5e" in proc.stdout


def test_version_loads_no_torch():
    """As the reference's ``--version`` pays no jax import, the port's
    pays no torch import: the entry point answers before any kernel
    module loads."""
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch', '--version']\n"
            "try:\n"
            "    runpy.run_module('repro_torch', run_name='__main__')\n"
            "except SystemExit as exc:\n"
            "    assert exc.code == 0\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    version, loaded = proc.stdout.strip().splitlines()
    assert version.startswith("repro_torch ")
    assert loaded == "[]"


def test_version_is_the_ports(capsys):
    import repro_torch
    with pytest.raises(SystemExit) as ei:
        main(["--version"])
    assert ei.value.code == 0
    assert capsys.readouterr().out.strip() == \
        f"repro_torch {repro_torch.__version__}"


# -- profile ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["text", "json", "csv"])
def test_profile_indices_formats(capsys, fmt):
    out = assert_same_report([
        "profile", "--workload", "indices", "--size", "2^14",
        "--dist", "solid", "--waves-per-tile", "32"], capsys, fmt)
    assert "scatter" in out


@pytest.mark.parametrize("provider", ["trace", "kernel", "microbench"])
@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_profile_histogram_variant(capsys, provider, variant):
    out = assert_same_report([
        "profile", "--workload", "histogram", "--pixels", "2^12",
        "--dist", "solid", "--variant", variant, "--provider", provider],
        capsys, "json")
    assert variant in json.loads(out)["points"][0]["label"]


@pytest.mark.parametrize("provider", ["trace", "kernel"])
def test_profile_scatter(capsys, provider):
    out = assert_same_report([
        "profile", "--workload", "scatter", "--size", "2^13",
        "--num-segments", "64", "--provider", provider], capsys, "json")
    assert json.loads(out)["points"][0]["e"] > 1.0


def test_profile_output_file(capsys, tmp_path):
    out_file = tmp_path / "report.json"
    rc, out = run_cli([
        "profile", "--size", "2^12", "--format", "json",
        "--output", str(out_file)], capsys)
    assert rc == 0
    assert json.loads(out_file.read_text()) == json.loads(out)


def test_profile_rejects_multi_values(capsys):
    assert main(["profile", "--size", "4096"]) == 0
    # nargs is single-valued on profile: a second value is an argparse error
    with pytest.raises(SystemExit):
        build_parser().parse_args(["profile", "--size", "4096", "8192"])
    capsys.readouterr()


@pytest.mark.parametrize("cmd", ["profile", "heatmap", "advise",
                                 "validate"])
def test_one_point_commands_reject_a_geometry_axis(capsys, cmd):
    """A multi-value geometry axis is refused by every one-point command
    (``main`` turns the ValueError into exit code 2)."""
    argv = [cmd, "--size", "2^12", "--waves-per-tile", "4"]
    args = build_parser().parse_args(argv)
    args.waves_per_tile = [4, 8]       # what only a sweep parser allows
    with pytest.raises(ValueError, match="exactly one workload point"):
        args.func(args)
    capsys.readouterr()


def test_unknown_device_is_a_clean_error(capsys):
    rc = main(["profile", "--size", "2^12", "--device", "h100"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "h100" in err and "v5e" in err


def test_unknown_provider_is_a_clean_error(capsys):
    """``--provider hlo`` on an ``indices`` spec reaches the hlo
    provider, which refuses a spec with no HLO text as the reference's
    does; a provider no registry knows is refused with the known ones."""
    argv = ["profile", "--size", "2^12", "--provider", "hlo"]
    assert ref_main(list(argv)) == 2
    want = capsys.readouterr().err
    rc = main(argv)
    err = capsys.readouterr().err
    assert rc == 2 and err == want
    assert "has no compiled/HLO source" in err
    rc = main(["profile", "--size", "2^12", "--provider", "nope"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "nope" in err and "trace" in err and "hlo" in err


# -- sweep --------------------------------------------------------------------


SWEEP_ARGV = ["sweep", "--workload", "indices", "--size", "2^13", "2^14",
              "--dist", "uniform", "--waves-per-tile", "4", "8", "16", "32",
              "--jobs", "4", "--no-artifact"]


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_sweep_grid_concurrent_roundtrip(capsys, fmt):
    """>=8-point grid, concurrent, equal to the reference in csv and json."""
    out = assert_same_report(SWEEP_ARGV, capsys, fmt)
    if fmt == "csv":
        rows = list(csv_mod.DictReader(io.StringIO(out)))
        assert len(rows) == 8                    # 2 sizes x 4 occupancies
        assert {"label", "bottleneck", "U_scatter", "e"} <= set(rows[0])
    else:
        assert len(json.loads(out)["points"]) == 8


def test_sweep_kernel_provider_equals_trace(capsys):
    """The same grid through the instrumented kernels (plain versions on
    the CPU) renders the trace provider's report."""
    argv = ["sweep", "--workload", "histogram", "--pixels", "2^12", "2^13",
            "--dist", "solid", "--waves-per-tile", "8", "32",
            "--no-artifact", "--format", "json"]
    rc, trace = run_cli(argv + CPU, capsys)
    assert rc == 0
    rc, kernel = run_cli(argv + CPU + ["--provider", "kernel"], capsys)
    assert rc == 0
    trace, kernel = json.loads(trace), json.loads(kernel)
    # the kernel provider's counters carry their op as meta
    meta = kernel.pop("meta")
    assert list(meta.values()) == [{"op": "histogram"}] * 4
    assert kernel == trace


def test_sweep_matches_session_api(capsys):
    """CLI sweep numbers are bit-identical to the port's Session API and
    equal to the reference's CLI."""
    argv = ["sweep", "--size", "2^14", "--dist", "uniform", "--seed", "3",
            "--waves-per-tile", "4", "8", "--no-artifact"]
    out = assert_same_report(argv, capsys, "json")
    cli_points = json.loads(out)["points"]

    rng = np.random.default_rng(3)
    idx = rng.integers(0, 256, 1 << 14)
    specs = WorkloadSpec.from_indices(
        idx, 256, label="uniform-16384").grid(waves_per_tile=[4, 8])
    api = Session("v5e").sweep(specs)
    for got, prof in zip(cli_points, api.profiles):
        assert got["label"] == prof.label
        assert got["scatter_model_U"] == prof.scatter_utilization  # bit-equal
        assert got["e"] == prof.e


def test_sweep_text_format_and_artifact(capsys, tmp_path):
    out_file = tmp_path / "sweep.txt"
    argv = ["sweep", "--size", "2^13", "--waves-per-tile", "4", "8"]
    out = assert_same_report(argv + ["--no-cache"], capsys, "text")
    assert "sweep on v5e (2 points)" in out
    rc, out = run_cli(argv + ["--output", str(out_file)], capsys)
    assert rc == 0
    assert out_file.read_text() == out


def test_sweep_multi_device_csv(capsys):
    out = assert_same_report([
        "sweep", "--size", "2^13", "--waves-per-tile", "4", "8",
        "--devices", "v5e", "v5p", "--no-artifact"], capsys, "csv")
    rows = list(csv_mod.DictReader(io.StringIO(out)))
    assert [r["device"] for r in rows] == ["v5e", "v5e", "v5p", "v5p"]


def test_sweep_multi_device_json(capsys):
    out = assert_same_report([
        "sweep", "--size", "2^13", "--waves-per-tile", "4", "8",
        "--devices", "v5e", "v5p", "--no-artifact"], capsys, "json")
    assert set(json.loads(out)["devices"]) == {"v5e", "v5p"}


def test_sweep_user_label_stays_unique_per_size(capsys):
    """--label + multi-value sizes must not collapse rows to one name."""
    out = assert_same_report([
        "sweep", "--size", "2^13", "2^14", "--label", "foo",
        "--no-artifact"], capsys, "csv")
    labels = [r["label"] for r in csv_mod.DictReader(io.StringIO(out))]
    assert labels == ["foo-8192", "foo-16384"]
    # single point: the label is used verbatim
    rc, out = run_cli([
        "profile", "--size", "2^13", "--label", "foo", "--format", "json"],
        capsys)
    assert json.loads(out)["points"][0]["label"] == "foo"


def test_sweep_shards_merge_to_the_full_grid(capsys):
    """Two shards fill the cache; --merge collects nothing and renders the
    single-process sweep (and the reference's)."""
    argv = ["sweep", "--size", "2^12", "--waves-per-tile", "4", "8", "16",
            "--no-artifact"]
    for i in range(2):
        rc, _ = run_cli(argv + ["--shards", "2", "--shard-index", str(i)],
                        capsys)
        assert rc == 0
    rc, merged = run_cli(argv + ["--merge"], capsys)
    assert rc == 0
    assert "cache: 0 collected, 0 memo hits, 3 disk hits" in merged
    want, got = both(argv + ["--format", "json", "--no-cache"], capsys)
    rc, merged_json = run_cli(argv + ["--merge", "--format", "json"], capsys)
    assert merged_json == got
    assert_json_close(json.loads(got), json.loads(want))


def test_sweep_shard_flags_are_checked_up_front(capsys):
    for bad in (["--shards", "2", "--shard-index", "2"],
                ["--merge", "--shards", "2"],
                ["--merge", "--no-cache"]):
        with pytest.raises(SystemExit) as exc:
            main(["sweep", "--size", "2^12"] + bad)
        assert exc.value.code == 2
    capsys.readouterr()


@pytest.mark.parametrize("provider", ["trace", "kernel"])
def test_sweep_warm_cache_skips_collection(capsys, tmp_path, monkeypatch,
                                           provider):
    """A repeated CLI sweep does zero counter collection.

    Each ``main()`` call builds a fresh Session (empty in-process memo),
    so the second run exercises the persistent results/torch/cache/ path
    the way a new process would.
    """
    from repro_torch.analysis.providers.base import provider_collect_batch
    from repro_torch.analysis import session as session_mod

    calls = []

    def counting(prov, specs, device, parallel=None):
        calls.extend(s.label for s in specs)
        return provider_collect_batch(prov, specs, device, parallel)

    monkeypatch.setattr(session_mod, "provider_collect_batch", counting)
    argv = ["sweep", "--size", "2^13", "--waves-per-tile", "4", "8",
            "--format", "csv", "--no-artifact", "--provider", provider] + CPU
    rc, out1 = run_cli(argv, capsys)
    assert rc == 0
    assert len(calls) == 2
    assert (tmp_path / "port" / "cache").exists()  # REPRO_TORCH_RESULTS root
    rc, out2 = run_cli(argv, capsys)
    assert rc == 0
    assert len(calls) == 2                  # warm re-sweep: zero collection
    assert out2 == out1                     # and a bit-identical report
    # --no-cache opts out: the same sweep collects again
    rc, out3 = run_cli(argv + ["--no-cache"], capsys)
    assert rc == 0
    assert len(calls) == 4
    assert out3 == out1


def test_sweep_default_artifact_under_results(capsys, tmp_path):
    rc, out = run_cli(["sweep", "--size", "2^12", "--format", "csv"], capsys)
    assert rc == 0
    artifact = tmp_path / "port" / "cli" / "sweep-v5e.csv"
    assert artifact.exists()
    assert list(csv_mod.DictReader(io.StringIO(artifact.read_text())))
    assert not (tmp_path / "ref").exists()


def test_sweep_text_cache_footer(capsys):
    argv = ["sweep", "--size", "2^12", "--waves-per-tile", "4", "8",
            "--no-artifact"]
    rc, out = run_cli(argv, capsys)
    assert rc == 0
    assert "cache: 2 collected, 0 memo hits, 0 disk hits" in out
    # warm run: both points served from the persistent cache
    rc, out = run_cli(argv, capsys)
    assert rc == 0
    assert "cache: 0 collected, 0 memo hits, 2 disk hits" in out
    # json/csv reports stay parseable: no footer
    rc, out = run_cli(argv + ["--format", "json"], capsys)
    assert rc == 0
    json.loads(out)
    rc, out = run_cli(argv + ["--format", "csv"], capsys)
    assert rc == 0
    assert "cache:" not in out


# -- validate -----------------------------------------------------------------


@pytest.mark.parametrize("dist", ["solid", "uniform"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_validate_trace_vs_kernel(capsys, fmt, dist):
    """Paper §5: the kernel provider's counters equal the trace's, exactly,
    through the port's kernel provider on --torch-device cpu."""
    out = assert_same_report([
        "validate", "--workload", "histogram", "--pixels", "2^12",
        "--dist", dist], capsys, fmt)
    if fmt == "json":
        payload = json.loads(out)
        assert payload["reference"] == "trace"
        kernel = [c for c in payload["comparisons"]
                  if c["provider"] == "kernel"][0]
        assert kernel["rel_err"]["e"] == 0.0     # exact match
        assert max(kernel["rel_err"].values()) == 0.0
        assert [c["batch_bitwise_equal"] for c in payload["comparisons"]] \
            == [True, True]
    else:
        assert "max relative error: 0.00%" in out


@pytest.mark.parametrize("argv", [
    ["--workload", "indices", "--size", "2^12", "--dist", "solid"],
    ["--workload", "scatter", "--size", "5000", "--num-segments", "64"],
    ["--workload", "histogram", "--pixels", "5000", "--variant", "hist2",
     "--providers", "trace", "kernel", "microbench"],
])
def test_validate_other_workloads(capsys, argv):
    out = assert_same_report(["validate"] + argv, capsys, "json")
    comparisons = json.loads(out)["comparisons"]
    kernel = [c for c in comparisons if c["provider"] == "kernel"][0]
    assert max(kernel["rel_err"].values()) == 0.0


# -- compare ------------------------------------------------------------------


def _compare_argv():
    return ["compare", "--device", "v5e", "--kind", "solid",
            "--pixels", "2^12", "2^14", "--no-artifact"]


@pytest.mark.parametrize("fmt", ["text", "json", "csv"])
def test_compare_formats(capsys, fmt):
    out = assert_same_report(_compare_argv(), capsys, fmt)
    if fmt == "json":
        payload = json.loads(out)
        assert {"device", "points", "size_shifts", "verdict"} == set(payload)
        assert len(payload["points"]) == 2
    elif fmt == "csv":
        rows = list(csv_mod.DictReader(io.StringIO(out)))
        assert len(rows) == 2
        assert {"kind", "pixels", "hist_U", "hist2_U", "speedup",
                "shift"} <= set(rows[0])
    else:
        assert "verdict:" in out and "hist2" in out


def test_compare_kernel_provider_equals_reference(capsys):
    """The case study through the instrumented kernels: the reference's
    report, and the trace provider's rows."""
    argv = ["compare", "--pixels", "2^5", "2^8", "2^11", "2^14",
            "--no-artifact", "--provider", "kernel"]
    out = assert_same_report(argv, capsys, "json")
    rc, trace = run_cli(argv[:-2] + CPU + ["--format", "json"], capsys)
    assert rc == 0
    assert out == trace


def test_compare_bit_identical_to_session_api(capsys):
    """compare == the port's Session API run of the same specs."""
    rc, out = run_cli(_compare_argv() + ["--format", "json"], capsys)
    assert rc == 0
    points = json.loads(out)["points"]

    device = get_device("v5e").with_(cache=CacheModel(
        llc_bytes=1 << 21, miss_latency_cycles=800, hide_concurrency=48))
    sess = Session(device)
    for point in points:
        px = int(point["pixels"])
        img = make_image("solid", px, seed=0)
        pair = [WorkloadSpec.from_histogram(
                    img, label=f"solid/{px}px/{v}", variant=v,
                    waves_per_tile=8)
                for v in ("hist", "hist2")]
        result = sess.sweep(pair)
        h, h2 = result.profiles
        assert point["hist_U"] == h.scatter_utilization          # bit-equal
        assert point["hist2_U"] == h2.scatter_utilization
        assert point["speedup"] == float(result.speedup_vs_first[1])
        assert point["hist_bottleneck"] == h.bottleneck


def test_compare_solid_speedup_exceeds_uniform(capsys):
    out = assert_same_report([
        "compare", "--kind", "solid", "uniform", "--pixels", "2^14",
        "--no-artifact"], capsys, "json")
    by_kind = {p["kind"]: p for p in json.loads(out)["points"]}
    # reordering pays where contention is: solid >> uniform
    assert by_kind["solid"]["speedup"] > by_kind["uniform"]["speedup"]


def test_compare_default_artifact(capsys, tmp_path):
    rc, out = run_cli(["compare", "--kind", "solid", "--pixels", "2^10",
                       "--format", "json"], capsys)
    assert rc == 0
    artifact = tmp_path / "port" / "cli" / "compare-v5e.json"
    assert json.loads(artifact.read_text()) == json.loads(out)


# -- help text ----------------------------------------------------------------


def test_help_lists_exactly_the_ported_subcommands(capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    out = capsys.readouterr().out
    assert "{" + ",".join(PORTED) + "}" in out
    sub = next(a for a in build_parser()._actions
               if a.dest == "command")
    assert tuple(sub.choices) == PORTED


@pytest.mark.parametrize("cmd", ANALYSIS)
def test_subcommand_help(capsys, cmd):
    with pytest.raises(SystemExit):
        main([cmd, "--help"])
    out = capsys.readouterr().out
    assert "--format" in out
    assert ("--torch-device" in out) == (cmd != "devices")


# -- advise -------------------------------------------------------------------


ADVISE_ARGV = ["advise", "--workload", "indices", "--size", "2^12",
               "--dist", "solid", "--waves-per-tile", "8", "--top-k", "3"]


@pytest.mark.parametrize("fmt", ["text", "json", "csv"])
def test_advise_equals_reference(capsys, fmt):
    out = assert_same_report(ADVISE_ARGV + ["--no-artifact", "--no-cache"],
                             capsys, fmt)
    if fmt == "text":
        assert "== advisor:" in out
        assert "rank  1" in out
        assert "baseline: bottleneck=" in out


def test_advise_json_matches_session(capsys):
    rc, out = run_cli(ADVISE_ARGV + [
        "--format", "json", "--no-artifact", "--no-cache"], capsys)
    assert rc == 0
    payload = json.loads(out)
    idx = np.zeros(1 << 12, np.int64)
    spec = WorkloadSpec.from_indices(idx, 256, label="solid-4096",
                                     waves_per_tile=8)
    api = Session("v5e").advise(spec, top_k=3)
    got = payload["candidates"]
    want = api.to_rows()
    assert [r["label"] for r in got] == [r["label"] for r in want]
    assert [r["predicted_speedup"] for r in got] \
        == [r["predicted_speedup"] for r in want]       # bit-equal


def test_advise_validate_top_through_the_kernel(capsys):
    """The reference test's solid image: rotation ranks first, and its
    validation through the port's kernel provider (on the CPU, as asked)
    gives e rel err 0.0 — the reference's report, bit for bit."""
    out = assert_same_report([
        "advise", "--workload", "histogram", "--pixels", "2^14",
        "--dist", "solid", "--waves-per-tile", "8",
        "--overhead-cycles", "2500", "--validate-top", "1",
        "--no-artifact", "--no-cache"], capsys, "json")
    top = json.loads(out)["candidates"][0]
    assert "rotation" in top["families"].split("+")
    assert top["validation_e_rel_err"] == 0.0
    assert top["validation_max_rel_err"] == 0.0


def test_advise_csv_and_artifact(capsys, tmp_path):
    rc, out = run_cli(ADVISE_ARGV + ["--format", "csv"], capsys)
    assert rc == 0
    rows = list(csv_mod.DictReader(io.StringIO(out)))
    assert len(rows) == 3
    assert rows[0]["rank"] == "1"
    artifact = tmp_path / "port" / "cli" / "advise-v5e.csv"
    assert artifact.exists()
    # capsys normalizes the csv writer's \r\n: compare parsed rows
    assert list(csv_mod.DictReader(io.StringIO(artifact.read_text()))) \
        == rows


def test_advise_warm_cache_skips_collection(capsys, monkeypatch):
    from repro_torch.analysis.providers.trace import TraceProvider

    calls = []
    orig = TraceProvider.collect
    orig_batch = TraceProvider.collect_batch

    def counting(self, spec, device):
        calls.append(spec.label)
        return orig(self, spec, device)

    def counting_batch(self, specs, device, **kw):
        calls.extend(s.label for s in specs)
        return orig_batch(self, specs, device, **kw)

    monkeypatch.setattr(TraceProvider, "collect", counting)
    monkeypatch.setattr(TraceProvider, "collect_batch", counting_batch)
    argv = ADVISE_ARGV + ["--format", "json", "--no-artifact"]
    rc, out1 = run_cli(argv, capsys)
    assert rc == 0
    assert calls
    n_cold = len(calls)
    rc, out2 = run_cli(argv, capsys)
    assert rc == 0
    assert len(calls) == n_cold     # warm re-advise: zero collection
    cold, warm = json.loads(out1), json.loads(out2)
    # collection stats legitimately differ (that is the point);
    # the ranking and every prediction must be bit-identical
    assert warm["candidates"] == cold["candidates"]
    assert warm["baseline"] == cold["baseline"]
    assert warm["stats"]["collected"] == 0
    assert warm["stats"]["disk_hits"] > 0


def test_advise_rejects_multi_point(capsys):
    # advise is single-point: --size is not multi-valued, argparse rejects
    with pytest.raises(SystemExit) as exc:
        main(["advise", "--size", "2^12", "2^13", "--no-artifact"])
    assert exc.value.code == 2


# -- format hardening ---------------------------------------------------------


@pytest.mark.parametrize("cmd,argv", [
    ("devices", ["devices"]),
    ("validate", ["validate", "--workload", "histogram",
                  "--pixels", "2^10"] + CPU),
])
def test_text_json_only_commands_reject_csv_up_front(capsys, cmd, argv):
    """argparse ``choices`` rejects csv before any work happens."""
    with pytest.raises(SystemExit) as exc:
        main(argv + ["--format", "csv"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--format" in err and "csv" in err


def test_torch_device_is_checked_up_front(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["profile", "--size", "2^12", "--torch-device", "gpu0"])
    assert exc.value.code == 2
    assert "gpu0" in capsys.readouterr().err


# -- the port's examples ------------------------------------------------------


def test_casestudy_example_rows_equal_reference():
    """``torch_histogram_casestudy.py``'s rows equal those the reference's
    example computes (the same code through ``repro``), at the
    ``--fast`` grid's smaller sizes."""
    from repro.kernels.histogram import ops as ref_ops

    example = load_example("torch_histogram_casestudy")
    sizes, waves = [2 ** p for p in range(5, 15, 3)], [8, 32]
    got, got_shift = example.casestudy_rows(
        example.case_study_session(), sizes, waves, "cpu")

    ref = RefSession(ref_get_device("v5e").with_(cache=RefCacheModel(
        llc_bytes=1 << 21, miss_latency_cycles=800, hide_concurrency=48)))
    want = []
    for kind in ("solid", "uniform"):
        for variant in ("hist", "hist2"):
            for n in sizes:
                _, tr = ref_ops.histogram_instrumented(
                    make_image(kind, n), variant=variant, force_fao=True)
                for wpt in waves:
                    prof = ref.profile(RefSpec.from_trace(
                        tr, label=f"{kind}/{variant}/{n}/{wpt}",
                        waves_per_tile=wpt, bytes_read=float(n * 4)))
                    want.append(
                        f"{kind},{variant},{n},{wpt},{prof.e:.2f},"
                        f"{prof.scatter_utilization:.4f},{prof.bottleneck}")
    assert got == want
    assert len(got_shift) == len(sizes)


def test_casestudy_example_writes_under_results(tmp_path, monkeypatch,
                                                capsys):
    example = load_example("torch_histogram_casestudy")
    monkeypatch.setattr(example, "casestudy_rows",
                        lambda sess, sizes, waves, dev: (
                            [f"solid,hist,{n},{w},32.00,0.5000,scatter"
                             for n in sizes for w in waves]
                            + [f"uniform,hist,{n},{w},2.00,0.1000,hbm"
                               for n in sizes for w in waves]
                            + [f"solid,hist2,{n},{w},8.00,0.4000,scatter"
                               for n in sizes for w in waves], []))
    example.main(["--fast", "--torch-device", "cpu"])
    out = tmp_path / "port" / "casestudy.csv"
    lines = out.read_text().splitlines()
    assert lines[0] == example.HEADER
    assert len(lines) == 1 + 3 * 6 * 2
    assert "wrote 36 rows" in capsys.readouterr().out


def test_quickstart_example_runs_on_the_cpu(capsys):
    load_example("torch_quickstart").main(CPU)
    out = capsys.readouterr().out
    assert "channel reorder on solid: e 32 -> 8" in out
    assert "max relative error: 0.00%" in out
    assert "batch collection bit-identical: trace, kernel" in out


# -- cache, serve, client -----------------------------------------------------


@pytest.mark.parametrize("cmd", SERVICE)
def test_service_subcommand_help(capsys, cmd):
    with pytest.raises(SystemExit):
        main([cmd, "--help"])
    out = capsys.readouterr().out
    assert ("--torch-device" in out) == (cmd == "serve")
    assert ("--format" in out) == (cmd == "cache")


def _fill_caches(capsys):
    """The same cold sweep through both packages' persistent caches."""
    argv = ["sweep", "--size", "2^12", "--dist", "solid",
            "--waves-per-tile", "4", "8", "--no-artifact"]
    both(argv, capsys)


def test_cache_stats_json_has_the_reference_keys(capsys, tmp_path):
    _fill_caches(capsys)
    argv = ["cache", "stats", "--format", "json"]
    assert ref_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["root"] == str(tmp_path / "port" / "cache")
    assert {k: got[k] for k in ("entries", "quarantined")} == \
        {k: want[k] for k in ("entries", "quarantined")} == \
        {"entries": 2, "quarantined": 0}
    assert {k: v["entries"] for k, v in got["by_provider"].items()} == \
        {k: v["entries"] for k, v in want["by_provider"].items()}


def test_cache_text_clear_and_prune(capsys, tmp_path):
    _fill_caches(capsys)
    rc, out = run_cli(["cache", "stats"], capsys)
    assert rc == 0
    assert out.splitlines()[:2][0] == \
        f"cache root: {tmp_path / 'port' / 'cache'}"
    assert out.splitlines()[1].startswith("2 entries, ")
    (tmp_path / "port" / "cache" / "deadbeef.tmp").write_bytes(b"half")
    rc, out = run_cli(["cache", "prune", "--max-bytes", "2^30"], capsys)
    assert rc == 0 and out.startswith("pruned 1 entries") \
        and "; 2 left" in out
    rc, out = run_cli(["cache", "clear"], capsys)
    assert rc == 0 and out.strip() == "removed 2 cache entries"
    assert ref_main(["cache", "clear"]) == 0
    assert capsys.readouterr().out.strip() == "removed 2 cache entries"
    with pytest.raises(SystemExit) as exc:
        main(["cache", "prune"])
    assert exc.value.code == 2


SERVE_FLAGS = ["serve", "--port", "0", "--workers", "3", "--queue-depth",
               "5", "--device", "v5p", "--fallbacks", "trace", "microbench",
               "--timeout", "20", "--max-timeout", "40", "--max-points",
               "99", "--call-timeout", "3", "--retries", "1",
               "--backoff-base", "0.5", "--breaker-threshold", "4",
               "--breaker-cooldown", "2", "--no-cache", "--fault-rate",
               "0.25", "--latency-rate", "0.5", "--latency-s", "0.1",
               "--corrupt-rate", "0.125", "--fault-seed", "9"]


def test_serve_flags_build_the_references_config(monkeypatch):
    """``serve``'s flags land in a ``ServiceConfig`` equal to the
    reference's field for field, plus the port's ``torch_device``."""
    from repro.service import server as ref_server
    from repro_torch.service import server

    seen = {}
    monkeypatch.setattr(ref_server, "serve", lambda cfg, port_file=None:
                        seen.setdefault("ref", (cfg, port_file)))
    monkeypatch.setattr(server, "serve", lambda cfg, port_file=None:
                        seen.setdefault("port", (cfg, port_file)))
    argv = SERVE_FLAGS + ["--port-file", "p.txt"]
    assert ref_main(argv) == 0
    assert main(argv + ["--torch-device", "cpu"]) == 0
    (got, got_file), (want, want_file) = seen["port"], seen["ref"]
    assert got_file == want_file == "p.txt"
    got = dataclasses.asdict(got)
    assert got.pop("torch_device") == "cpu"
    assert got == dataclasses.asdict(want)


@pytest.mark.parametrize("chain", [["--provider", "kernel"],
                                   ["--fallbacks", "trace", "kernel"]],
                         ids=["primary", "fallback"])
def test_serve_kernel_without_a_card_exits_2_before_binding(
        chain, monkeypatch, capsys):
    """No fallback: ``serve`` with ``kernel`` in its chain, without a
    card and without ``--torch-device cpu``, exits 2 before a service or
    a socket exists."""
    import torch

    from repro_torch.service import server

    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device works here")
    monkeypatch.setattr(server, "serve", lambda *a, **kw: pytest.fail(
        "serve ran"))
    monkeypatch.setattr(server, "make_http_server", lambda *a, **kw:
                        pytest.fail("bound a port"))
    with pytest.raises(SystemExit) as exc:
        main(["serve", "--port", "0"] + chain)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--torch-device cpu" in err


def test_serve_rejects_a_bad_torch_device_with_a_kernel(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["serve", "--provider", "kernel", "--torch-device", "gpu0"])
    assert exc.value.code == 2
    assert "gpu0" in capsys.readouterr().err


def _modules_after(argv):
    """(exit code, stdout, the torch/jax/repro modules loaded) of one
    ``python -m repro_torch`` run in a process of its own."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['repro_torch'] + {list(argv)!r}\n"
            "try:\n"
            "    runpy.run_module('repro_torch', run_name='__main__')\n"
            "except SystemExit as exc:\n"
            "    rc = exc.code\n"
            "print(rc)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    *out, rc, loaded = proc.stdout.strip().splitlines()
    return int(rc), "\n".join(out), loaded, proc.stderr


def test_client_loads_no_torch():
    """``client`` is stdlib: it answers (here: service unreachable, exit
    1) without loading torch, as ``--version`` does."""
    rc, _, loaded, err = _modules_after(
        ["client", "--port", "1", "--timeout", "5", "health"])
    assert rc == 1 and "service unreachable" in err
    assert loaded == "[]"


def test_serve_and_client_processes_on_the_cpu(tmp_path):
    """The real entry points: a ``serve`` daemon with the kernel primary
    on the CPU, ``client`` health and a ``validate`` job through it (e
    rel err 0.0, not degraded), then SIGINT: the daemon exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    port_file = tmp_path / "port"
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "serve", "--provider",
         "kernel", "--fallbacks", "trace", "--torch-device", "cpu",
         "--port", "0", "--port-file", str(port_file), "--workers", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists() and daemon.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        port = port_file.read_text()
        job = {"kind": "validate",
               "workload": {"workload": "histogram", "pixels": 4096,
                            "dist": "solid", "waves_per_tile": 32}}
        outs = []
        for argv in (["health"], ["submit", "--job", json.dumps(job)]):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch", "client", "--port",
                 port] + argv, cwd=REPO, env=env, capture_output=True,
                text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr
            outs.append(json.loads(proc.stdout))
        assert outs[0] == {"ok": True}
        body = outs[1]
        assert body["ok"] and not body["degraded"]
        assert body["fallback_providers"] == []
        ref, measured = body["result"]["comparisons"]
        assert measured["provider"] == "kernel"
        assert measured["rel_err"]["e"] == 0.0
    finally:
        daemon.send_signal(signal.SIGINT)
        try:
            rc = daemon.wait(10)
        finally:
            if daemon.poll() is None:
                daemon.kill()
        line = daemon.stdout.read()
    assert rc == 0
    assert line.startswith(f"repro-serve: listening on http://127.0.0.1:"
                           f"{port} (workers=2, queue=32, provider=kernel, "
                           f"torch_device=cpu)")


def test_grid_sweep_example_csv_equals_reference(tmp_path, monkeypatch,
                                                 capsys):
    """``torch_grid_sweep.py``'s csv equals the reference example's row
    for row, and its base point validates exactly through the kernel
    provider on the CPU."""
    ref = load_example("grid_sweep")
    monkeypatch.setattr(ref, "OUT", str(tmp_path / "ref.csv"))
    ref.main()
    report = load_example("torch_grid_sweep").main(CPU)
    want = (tmp_path / "ref.csv").read_text()
    got = (tmp_path / "port" / "grid_sweep.csv").read_text()
    assert got.splitlines()[0] == want.splitlines()[0]
    assert len(got.splitlines()) == len(want.splitlines()) == 2 * 9
    assert_csv_close("".join(got.splitlines(True)[:9]),
                     "".join(want.splitlines(True)[:9]))
    assert_csv_close("".join(got.splitlines(True)[9:]),
                     "".join(want.splitlines(True)[9:]))
    assert report.max_rel_err == 0.0
    out = capsys.readouterr().out
    assert "max relative error 0.00%" in out
