"""The port's static audit of HLO text against the reference's.

``repro_torch.audit`` (scanner, rules, report, ``audit_hlo``,
``attach_advice``), ``Session.audit`` and ``python -m repro_torch audit
--hlo-file``.  First the reference's own cases (``tests/test_audit.py``)
on the port; where one lowers a zoo config, the port audits the
committed full-width texts instead.  Then both packages on the same text:
the two reduced goldens the reference's tests pin, the two full-width
qwen3-moe-235b-a22b goldens (``tests/data/regen_torch_hlo_goldens.py``),
a fresh full-width lowering of qwen3-moe decode, and the crafted texts.
Sites, rule ids, severities, labels, fixits, suppressions, advice and
spec fingerprints are equal exactly, utilization and ratios within rtol
1e-9, and every report renders to the same string in text, json, csv and
SARIF.

The audit launches nothing: ``Session.stats`` stays at zero and no
kernel wrapper is called.  Each finding's candidate stream goes through
K6's plain version here (``torch_device="cpu"``) with an e relative error
of exactly 0.0; the card's run is ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``.
"""

import collections
import gzip
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _audit_specs import PINNED, distinct_specs, kernel_ready
from _port_compare import assert_json_close
from repro.analysis import Session as RefSession
from repro.audit import audit_hlo as ref_audit_hlo
from repro.audit import attach_advice as ref_attach_advice
from repro.audit import merge as ref_merge
from repro.audit import merge_sarif as ref_merge_sarif
from repro.audit import zoo
from repro.cli.main import main as ref_main
from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.analysis.providers import InstrumentedKernelProvider
from repro_torch.audit import (attach_advice, audit_config, audit_hlo,
                               config_noqa, exit_code, merge, merge_sarif,
                               parse_noqa, scan_hlo)
from repro_torch.audit import rules as rules_mod
from repro_torch.audit.report import SARIF_VERSION, AuditReport
from repro_torch.cli.main import build_parser, main
from repro_torch.core import counters
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.lint import rules as lint_rules
from test_audit import CAS_HLO, HOT_HLO, PLAIN_DUS_HLO, UNRESOLVED_HLO

DATA = pathlib.Path(__file__).parent / "data"
REPO = pathlib.Path(__file__).parents[1]
GOLDENS = ("granite_moe_1b_a400m__decode", "whisper_small__train",
           "qwen3_moe_235b_a22b__decode", "qwen3_moe_235b_a22b__prefill")
CRAFTED = {"hot": HOT_HLO, "cas": CAS_HLO, "unresolved": UNRESOLVED_HLO,
           "plain_dus": PLAIN_DUS_HLO}
TEXT_NAMES = GOLDENS + ("qwen3_moe_235b_a22b__decode_fresh",) \
    + tuple(CRAFTED)
ZERO_STATS = {"collected": 0, "memo_hits": 0, "disk_hits": 0,
              "batch_calls": 0}

FLOAT_FIELDS = ("utilization", "baseline_utilization", "contention")


def golden(name: str) -> str:
    return gzip.decompress((DATA / f"{name}.hlo.gz").read_bytes()).decode()


@pytest.fixture(scope="module")
def texts():
    out = {name: golden(name) for name in GOLDENS}
    # qwen3-moe decode lowered now, at every published width (the
    # reference's lowering; about 3 s)
    out["qwen3_moe_235b_a22b__decode_fresh"] = zoo.lower_config_steps(
        "qwen3_moe_235b_a22b", steps=["decode"])["decode"]
    out.update(CRAFTED)
    return out


@pytest.fixture(scope="module")
def granite_decode(texts):
    return texts["granite_moe_1b_a400m__decode"]


@pytest.fixture(scope="module")
def whisper_train(texts):
    return texts["whisper_small__train"]


@pytest.fixture(scope="module", autouse=True)
def _tables(tmp_path_factory):
    root = tmp_path_factory.mktemp("tables")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TABLE_CACHE", str(root / "ref"))
        mp.setenv("REPRO_TORCH_TABLE_CACHE", str(root / "port"))
        yield


@pytest.fixture(autouse=True)
def _isolate_artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "port"))
    yield


def _both_reports(text, label, **kw):
    return (audit_hlo(text, session=Session("v5e"), label=label, **kw),
            ref_audit_hlo(text, session=RefSession("v5e"), label=label,
                          **kw))


def assert_findings_equal(got, want):
    """Field by field: exact but for the model's floats (rtol 1e-9)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("rule_id", "rule_slug", "severity", "message", "label",
                      "bottleneck", "hint", "fixit", "suppressed",
                      "hlo_uri", "hlo_line"):
            assert getattr(g, field) == getattr(w, field), field
        assert (g.site is None) == (w.site is None)
        if w.site is not None:
            assert g.site.__dict__ == w.site.__dict__
        for field in FLOAT_FIELDS:
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if b is not None:
                assert math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0), field
        assert (g.spec is None) == (w.spec is None)
        if w.spec is not None:
            assert g.spec.fingerprint() == w.spec.fingerprint()
            assert g.spec.label == w.spec.label
        if w.advice is None:
            assert g.advice is None
        else:
            assert_json_close(g.advice, w.advice)


def assert_reports_equal(got, want):
    assert_findings_equal(got.findings, want.findings)
    assert (got.label, got.device, got.steps, got.sites_scanned,
            got.instructions_scanned) == (want.label, want.device,
                                          want.steps, want.sites_scanned,
                                          want.instructions_scanned)
    for fmt in ("text", "json", "csv", "sarif"):
        assert got.render(fmt) == want.render(fmt), fmt
    for gate in ("never", "note", "warning", "error"):
        assert exit_code(got, gate) == exit_code(want, gate)
        assert [f.label for f in got.gated(gate)] == \
            [f.label for f in want.gated(gate)]
    assert got.counts() == want.counts()


# -- the reference's own cases (tests/test_audit.py) ---------------------------


def test_scan_granite_decode_sites(granite_decode):
    scan = scan_hlo(granite_decode)
    kinds = scan.by_kind()
    assert set(kinds) >= {"histogram_scatter", "dispatch_scatter",
                          "kv_cache_write", "sort_segment"}
    assert scan.unresolved_loops == 0
    assert scan.num_instructions > 500
    looped = [s for s in scan.sites if s.loop_depth >= 1]
    assert looped and all(s.trip_count == 4 for s in looped)
    (hist,) = [s for s in scan.sites if s.kind == "histogram_scatter"]
    assert hist.combiner == "add" and hist.num_bins == 8
    assert hist.index_dtype == "s32"


def test_scan_whisper_train_golden(whisper_train):
    scan = scan_hlo(whisper_train)
    assert "kv_cache_write" in scan.by_kind()
    assert scan.num_instructions > 2000


def test_scan_crafted_histogram():
    scan = scan_hlo(HOT_HLO)
    assert len(scan.sites) == 1
    site = scan.sites[0]
    assert site.kind == "histogram_scatter"
    assert site.combiner == "add"
    assert site.num_bins == 2 and site.num_updates == 4096
    assert site.row_elems == 1 and site.loop_depth == 0


def test_scan_cas_combiner():
    (site,) = scan_hlo(CAS_HLO).sites
    assert site.combiner == "cas"
    assert rules_mod.CasRetryLoop().matches(site)


def test_scan_plain_dus_not_kv_cache():
    assert list(scan_hlo(PLAIN_DUS_HLO).sites) == []


def test_scan_unresolved_while():
    assert scan_hlo(UNRESOLVED_HLO).unresolved_loops >= 1


def test_hot_bin_rates_error():
    sess = Session("v5e")
    rep = audit_hlo(HOT_HLO, session=sess, label="hot")
    (f,) = [f for f in rep.findings if f.rule_id == "ATOM001"]
    assert f.severity == "error"
    assert f.contention is not None \
        and f.contention >= rules_mod.ERROR_RATIO
    assert f.utilization is not None and f.fixit
    assert isinstance(f.spec, WorkloadSpec)
    assert f.spec.label.endswith("scatter.1")
    assert sess.stats == ZERO_STATS


def test_severity_caps():
    sev = rules_mod._finding_severity
    assert sev(rules_mod.SameAddressHotBin(), 2.0) == "error"
    assert sev(rules_mod.SameAddressHotBin(), 1.2) == "warning"
    assert sev(rules_mod.SameAddressHotBin(), 1.0) == "note"
    assert sev(rules_mod.StrideConflict(), 2.0) == "warning"
    assert sev(rules_mod.WavesExceedPipeline(), 2.0) == "note"


def test_bank001_capped_at_warning(granite_decode):
    rep = audit_hlo(granite_decode, session=Session("v5e"), label="g")
    bank = [f for f in rep.findings if f.rule_id == "BANK001"]
    assert bank
    assert all(f.severity == "warning" for f in bank)
    assert any(f.contention >= rules_mod.ERROR_RATIO for f in bank)


def test_audit000_on_unresolved_loops():
    rep = audit_hlo(UNRESOLVED_HLO, session=Session("v5e"), label="u")
    (f,) = [f for f in rep.findings if f.rule_id == "AUDIT000"]
    assert f.severity == "note"
    assert "lower bound" in f.message


def test_render_formats(granite_decode):
    rep = audit_hlo(granite_decode, session=Session("v5e"), label="g")
    text = rep.render("text")
    assert "== audit g" in text and "warning(s)" in text
    payload = json.loads(rep.render("json"))
    assert payload["tool"] == "repro-audit"
    assert payload["counts"]["warning"] >= 1
    assert all("contention" in row for row in payload["findings"])
    assert rep.render("csv").splitlines()[0].startswith("rule,")
    with pytest.raises(ValueError, match="unknown report format"):
        rep.render("yaml")


def test_sarif_schema_shape():
    rep = audit_hlo(HOT_HLO, session=Session("v5e"), label="hot",
                    hlo_uri="hlo/hot.hlo", suppress=["ATOM001"])
    doc = rep.to_sarif()
    assert doc["$schema"].endswith("sarif-2.1.0.json")
    assert doc["version"] == SARIF_VERSION
    (run,) = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] == "repro-audit"
    ids = [r["id"] for r in driver["rules"]]
    assert len(ids) == len(set(ids))
    # the rule index: the audit's rules, AUDIT000, then the KERN catalog
    assert ids == [r.id for r in rules_mod.CATALOG] + ["AUDIT000"] + \
        [r.id for r in lint_rules.KERN_CATALOG]
    for r in driver["rules"]:
        assert r["shortDescription"]["text"]
        assert r["defaultConfiguration"]["level"] in ("note", "warning",
                                                      "error")
    for res in run["results"]:
        assert ids[res["ruleIndex"]] == res["ruleId"]
        assert res["level"] in ("note", "warning", "error")
        assert res["message"]["text"]
    (hot,) = [r for r in run["results"] if r["ruleId"] == "ATOM001"]
    assert hot["suppressions"] == [{"kind": "inSource"}]
    loc = hot["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "hlo/hot.hlo"
    assert loc["region"]["startLine"] >= 1
    assert hot["properties"]["predictedScatterUtilization"] > 0
    assert hot["properties"]["contentionRatio"] > 1


def test_noqa_parsing():
    src = ("x = 1  # repro: noqa ATOM001, BANK001\n"
           "# repro: noqa: GEOM001\n"
           "# repro:noqa ATOM002\n")
    assert parse_noqa(src) == {"ATOM001", "BANK001", "GEOM001", "ATOM002"}
    assert parse_noqa("# nothing here") == set()


def test_suppression_gates_exit_code():
    sess = Session("v5e")
    rep = audit_hlo(HOT_HLO, session=sess, label="hot",
                    suppress=["ATOM001"])
    (f,) = [f for f in rep.findings if f.rule_id == "ATOM001"]
    assert f.suppressed
    assert rep.gated("error") == []
    assert exit_code(rep, "error") == 0
    assert rep.counts()["error"] == 0
    rep2 = audit_hlo(HOT_HLO, session=sess, label="hot")
    assert exit_code(rep2, "error") == 1
    assert exit_code(rep2, "never") == 0


def test_zamba2_config_declares_noqa():
    assert "BANK001" in config_noqa("zamba2-1.2b")
    assert config_noqa("qwen3-moe-235b-a22b") == set()
    assert config_noqa("nope") == set()


def test_merge_reports(granite_decode):
    sess = Session("v5e")
    a = audit_hlo(HOT_HLO, session=sess, label="a")
    b = audit_hlo(granite_decode, session=sess, label="b")
    m = merge([a, b], label="zoo")
    assert m.label == "zoo"
    assert len(m.findings) == len(a.findings) + len(b.findings)
    assert m.sites_scanned == a.sites_scanned + b.sites_scanned
    assert m.steps == ["a:a", "b:b"]


@pytest.mark.parametrize("step", ["decode", "prefill"])
def test_qwen3_audit_acceptance(texts, step):
    """The reference's acceptance on its ``audit_config`` of qwen3-moe,
    on the full-width step texts: the dispatch scatter and the
    expert-count histogram, with rule ids, model-predicted utilization and
    fix-it hints — zero kernel executions."""
    sess = Session("v5e")
    rep = audit_hlo(texts[f"qwen3_moe_235b_a22b__{step}"], session=sess,
                    label=f"qwen3-moe-235b-a22b/{step}")
    kinds = {f.site.kind for f in rep.findings if f.site is not None}
    assert "dispatch_scatter" in kinds
    assert "histogram_scatter" in kinds
    sited = [f for f in rep.findings if f.site is not None]
    assert len({f.site.op_name for f in sited}) >= 2
    for f in sited:
        assert f.rule_id and f.utilization is not None and f.fixit
    assert [f.rule_id for f in rep.findings if f.severity == "error"] == \
        ["ATOM001"]
    assert sess.stats == ZERO_STATS


def test_session_audit_method(granite_decode):
    sess = Session("v5e")
    rep = sess.audit(granite_decode, label="g")
    assert isinstance(rep, AuditReport)
    assert rep.label == "g" and rep.findings
    assert sess.stats == ZERO_STATS
    # an hlo spec is audited at its text, under its own label
    spec = WorkloadSpec.from_compiled(hlo_text=granite_decode, label="s")
    rep2 = sess.audit(spec)
    assert rep2.label == "s"
    assert [f.rule_id for f in rep2.findings] == \
        [f.rule_id for f in rep.findings]
    assert sess.stats == ZERO_STATS


def test_audit_refusals_name_their_roadmap_item():
    """Sources with no HLO and no capture still raise ``ValueError``,
    naming what ``audit`` takes, as the reference's do; a zoo config,
    which waited for ROADMAP queue 1 ("Multi-device and the zoo audit"),
    is now captured and audited, launching nothing."""
    sess = Session("v5e")
    spec = WorkloadSpec.from_indices(np.zeros(1024, np.int64), 8,
                                     label="ids")
    for source in (spec, object(), None):
        with pytest.raises(ValueError, match="captured step"):
            sess.audit(source)
    rep = audit_config("qwen3_moe_235b_a22b", session=sess,
                       steps=["decode"], reduced=True)
    assert rep.steps == ["decode"] and rep.findings
    assert sess.stats == ZERO_STATS


# -- the command line (the reference's cases) -----------------------------------


def run_cli(argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_audit_hlo_file(tmp_path, capsys):
    path = tmp_path / "hotbin.hlo"
    path.write_text(HOT_HLO)
    rc, out = run_cli(["audit", "--hlo-file", str(path),
                       "--no-artifact"], capsys)
    assert rc == 1
    assert "ATOM001" in out and "error(s)" in out
    rc, _ = run_cli(["audit", "--hlo-file", str(path), "--no-artifact",
                     "--fail-on", "never"], capsys)
    assert rc == 0
    rc, _ = run_cli(["audit", "--hlo-file", str(path), "--no-artifact",
                     "--suppress", "ATOM001"], capsys)
    assert rc == 0


def test_cli_audit_artifacts(tmp_path, capsys):
    path = tmp_path / "hotbin.hlo"
    path.write_text(HOT_HLO)
    rc, out = run_cli(["audit", "--hlo-file", str(path),
                       "--fail-on", "never", "--format", "sarif"], capsys)
    assert rc == 0
    doc = json.loads(out)
    assert doc["version"] == SARIF_VERSION
    artifact = tmp_path / "port" / "cli" / "audit" / "audit-hotbin.sarif"
    assert artifact.is_file()
    assert json.loads(artifact.read_text()) == doc


def test_cli_audit_usage_rejected_up_front():
    parser = build_parser()
    for argv in (["audit", "--format", "yaml"],
                 ["audit", "--fail-on", "sometimes"],
                 ["audit", "--steps", "serve"]):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)


def test_cli_audit_no_target_is_usage_error(capsys):
    rc, _ = run_cli(["audit", "--no-artifact"], capsys)
    assert rc == 2


@pytest.mark.parametrize("argv", [
    ["--config", "qwen3_moe_235b_a22b"],
    ["--config", "granite-moe-1b-a400m", "zamba2_1p2b", "--reduced",
     "--steps", "decode", "--variant", "base"],
    ["--all", "--format", "sarif", "--fail-on", "warning"]])
def test_cli_audit_config_and_all_refuse(argv, capsys):
    """``--config``/``--all`` parse as in the reference, and now capture
    and audit the configs at their production shapes (they exited 2 until
    ROADMAP queue 1, "Multi-device and the zoo audit", was done): a report
    on stdout, exit 1 where a finding reaches the gate."""
    rc = main(["audit", *argv, "--no-artifact"])
    cap = capsys.readouterr()
    assert rc in (0, 1) and cap.out
    if "sarif" in argv:
        assert rc == 1 and json.loads(cap.out)["runs"][0]["results"]


def test_cli_audit_subprocess_fail_on(tmp_path):
    path = tmp_path / "hotbin.hlo"
    path.write_text(HOT_HLO)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_RESULTS=str(tmp_path / "ref"),
               REPRO_TORCH_RESULTS=str(tmp_path / "port"))
    procs = {}
    for pkg in ("repro", "repro_torch"):
        for gate in ("error", "never"):
            procs[pkg, gate] = subprocess.run(
                [sys.executable, "-m", pkg, "audit", "--hlo-file",
                 str(path), "--no-artifact", "--fail-on", gate,
                 "--format", "sarif"],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=300)
    port = procs["repro_torch", "error"]
    assert port.returncode == 1, port.stderr
    assert "ATOM001" in port.stdout
    assert "--fail-on error" in port.stderr
    assert procs["repro_torch", "never"].returncode == 0
    for gate in ("error", "never"):
        ref, got = procs["repro", gate], procs["repro_torch", gate]
        assert (got.returncode, got.stdout) == (ref.returncode, ref.stdout)


# -- the same text through both packages ---------------------------------------


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_scan_equals_reference(texts, name):
    from repro.audit import scan_hlo as ref_scan_hlo
    got, want = scan_hlo(texts[name]), ref_scan_hlo(texts[name])
    assert [s.__dict__ for s in got.sites] == [s.__dict__ for s in want.sites]
    assert (got.num_instructions, got.num_computations,
            got.unresolved_loops, got.entry) == (
        want.num_instructions, want.num_computations,
        want.unresolved_loops, want.entry)
    assert got.by_kind() == want.by_kind()


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_audit_equals_reference(texts, name):
    for kw in ({}, {"hlo_uri": f"hlo/{name}.hlo", "num_cores": 4},
               {"suppress": ["ATOM001", "BANK001"]}):
        got, want = _both_reports(texts[name], name, **kw)
        assert_reports_equal(got, want)


@pytest.mark.parametrize("name", GOLDENS)
def test_pinned_counts(texts, name):
    """The counts ``chip_smoke.py`` holds the card to."""
    counts, n_specs = PINNED[name]
    rep = audit_hlo(texts[name], session=Session("v5e"), label=name)
    assert collections.Counter(
        (f.rule_id, f.severity) for f in rep.findings) == counts
    assert len(distinct_specs(rep)) == n_specs


def test_fresh_lowering_equals_the_golden(texts):
    """The committed qwen3-moe decode text is what the reference lowers
    today, so the card audits the same module."""
    assert texts["qwen3_moe_235b_a22b__decode_fresh"] == \
        texts["qwen3_moe_235b_a22b__decode"]


def test_merge_and_merge_sarif_equal_reference(texts):
    names = ("hot", "granite_moe_1b_a400m__decode",
             "qwen3_moe_235b_a22b__prefill")
    pairs = [_both_reports(texts[n], n, hlo_uri=f"hlo/{n}.hlo")
             for n in names]
    got = merge([p for p, _ in pairs], label="zoo")
    want = ref_merge([r for _, r in pairs], label="zoo")
    assert_reports_equal(got, want)
    got_doc = merge_sarif([p.to_sarif() for p, _ in pairs])
    want_doc = ref_merge_sarif([r.to_sarif() for _, r in pairs])
    assert json.dumps(got_doc) == json.dumps(want_doc)
    # each package's SARIF merges with the other's
    assert json.dumps(merge_sarif([r.to_sarif() for _, r in pairs])) == \
        json.dumps(want_doc)


@pytest.mark.parametrize("name", ["hot", "granite_moe_1b_a400m__decode",
                                  "qwen3_moe_235b_a22b__decode"])
def test_attach_advice_equals_reference(texts, name):
    got, want = _both_reports(texts[name], name)
    sess, ref_sess = Session("v5e"), RefSession("v5e")
    attach_advice(got, sess)
    ref_attach_advice(want, ref_sess)
    assert any(f.advice for f in got.findings)
    assert_reports_equal(got, want)
    assert sess.stats == ref_sess.stats


def test_audit_launches_nothing(texts, monkeypatch):
    """No kernel wrapper is reached, on the card or here: every launcher
    and plain version raises if called, and the counts stay put."""
    def refuse(*args, **kwargs):
        raise AssertionError("the audit reached a kernel")

    for mod in (hk, sk):
        for attr in dir(mod):
            if attr.endswith(("_launch", "_plain")):
                monkeypatch.setattr(mod, attr, refuse)
    before = {**hk.LAUNCHES, **sk.LAUNCHES}
    sess = Session("v5e")
    for name in GOLDENS:
        sess.audit(texts[name], label=name)
    assert sess.stats == ZERO_STATS
    assert {**hk.LAUNCHES, **sk.LAUNCHES} == before


@pytest.mark.parametrize("name", GOLDENS)
def test_finding_specs_validate_through_k6_plain(texts, name):
    """Each distinct finding spec through ``trace`` and K6's plain version
    (``torch_device="cpu"``): e relative error exactly 0.0, N and O equal."""
    sess = Session("v5e")
    rep = audit_hlo(texts[name], session=sess, label=name)
    kernel = InstrumentedKernelProvider(torch_device="cpu")
    for spec in distinct_specs(rep).values():
        ready = kernel_ready(spec)
        if ready is not spec:
            assert counters.bitwise_equal(sess.collect(spec, "trace"),
                                          sess.collect(ready, "trace"))
        report = sess.validate(ready, ("trace", kernel))
        trace, measured = report.comparisons
        assert measured.rel_err["e"] == 0.0 and report.max_rel_err == 0.0
        assert measured.counters["N"] == trace.counters["N"]
        assert measured.counters["O"] == trace.counters["O"]
        assert [c.batch_bitwise_equal for c in report.comparisons] == \
            [True, True]


# -- the command line against the reference's ----------------------------------


def _cli_both(argv, capsys, tmp_path):
    """(rc, stdout, stderr, artifact) for the reference, then the port."""
    out = []
    for fn, root in ((ref_main, "ref"), (main, "port")):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        arts = sorted((tmp_path / root / "cli" / "audit").glob("*"))
        out.append((rc, cap.out, cap.err.replace(str(tmp_path / root), ""),
                    [(p.name, p.read_text()) for p in arts]))
    return out


@pytest.mark.parametrize("name", GOLDENS)
@pytest.mark.parametrize("fmt", ["text", "json", "csv", "sarif"])
def test_cli_audit_equals_reference(texts, name, fmt, tmp_path, capsys):
    path = tmp_path / f"{name}.hlo"
    path.write_text(texts[name])
    ref, got = _cli_both(["audit", "--hlo-file", str(path), "--format", fmt],
                         capsys, tmp_path)
    assert got == ref
    assert got[0] == (1 if name.startswith("qwen3") else 0)
    assert got[3] and got[3][0][1].splitlines() == got[1].splitlines()


@pytest.mark.parametrize("extra", [
    ["--advise", "--format", "sarif"],
    ["--advise", "--fail-on", "warning"],
    ["--suppress", "ATOM001", "--fail-on", "error", "--format", "json"],
    ["--suppress", "BANK001", "GEOM001", "--fail-on", "note"],
    ["--fail-on", "never", "--num-cores", "4", "--no-artifact"],
    ["--output", "{out}", "--format", "csv"]])
@pytest.mark.parametrize("name", ["granite_moe_1b_a400m__decode",
                                  "qwen3_moe_235b_a22b__decode"])
def test_cli_audit_gate_and_advise_equal_reference(texts, name, extra,
                                                   tmp_path, capsys):
    path = tmp_path / f"{name}.hlo"
    path.write_text(texts[name])
    out = tmp_path / "report.out"
    argv = ["audit", "--hlo-file", str(path)] + \
        [a.format(out=out) for a in extra]
    results = []
    for fn, root in ((ref_main, "ref"), (main, "port")):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        written = out.read_text() if out.exists() else None
        arts = sorted((tmp_path / root / "cli" / "audit").glob("*"))
        results.append((rc, cap.out, cap.err.replace(str(tmp_path / root), ""),
                        written, [(p.name, p.read_text()) for p in arts]))
    assert results[1] == results[0]
