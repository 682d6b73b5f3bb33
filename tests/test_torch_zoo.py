"""The port's zoo audit against the reference's.

``repro_torch.audit.audit_config`` captures each step of a config on meta
tensors under a one-rank mesh (``launch.lowering.build_captured``) and
scans the captured aten graph (``audit.scanner.scan_graph``); the
reference lowers each step to pre-optimization HLO and scans that.  For
every config at the reduced geometry, and for each step the reference
audits, the set of distinct (rule, severity, site kind, loop depth)
among the port's findings equals the reference's, after one rule is
applied to the reference's side: ``lax_scan_stacking`` drops each
``kv_cache_write`` whose update has a leading 1 and the same trailing
dims as its buffer (a ``lax.scan`` stacking one iteration's slab into
its stacked output, which a Python loop does not write).  Any other
difference stands in ``DIVERGENCES`` with its reason.  The counts of
each triple, port beside reference, are printed, not gated: a Python
loop and a ``lax.scan`` place different numbers of writes.

Three sites have no divergence by design — the decode step's K/V write,
the embedding gradient and the label-gather backward — and carry the
reference's (bins, updates, row, combiner, trips), with utilization and
contention within rtol 1e-9.  The MoE sites are printed side by side
and held to the same rule and severity.
"""

import collections
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import Session as RefSession
from repro.audit import audit_config as ref_audit_config
from repro.audit import zoo as ref_zoo
from repro.cli.main import main as ref_main
from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.audit import audit_config, zoo
from repro_torch.cli.main import main

REPO = Path(__file__).resolve().parents[1]
ZOO = sorted(ref_zoo.ARCHS)
MOE = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
ZERO_STATS = {"collected": 0, "memo_hits": 0, "disk_hits": 0,
              "batch_calls": 0}

# (configs, step, side, (rule, severity, kind, depth)) -> reason
DIVERGENCES = {
    (("rwkv6-7b",), "train", "reference",
     ("BANK001", "warning", "kv_cache_write", 2)):
        "the reference's WKV scans the sequence and stacks each time "
        "step's (1, 1, H, N) output into (1, T, H, N) along its time "
        "axis (a dynamic-update-slice the stacking rule does not drop: "
        "its trailing dims differ); the port's chunk loop collects a "
        "list and stacks it with torch.stack, which writes no slice",
    (("zamba2-1.2b",), "train", "reference",
     ("BANK001", "warning", "kv_cache_write", 2)):
        "the reference's SSD scans the chunks and stacks each chunk's "
        "entering state into (B, H, C, ...) along a non-leading axis; "
        "the port's chunk loop stacks a list with torch.stack",
    (MOE, "train", "reference",
     ("ATOM001", "warning", "one_hot_histogram", 1)):
        "XLA hoists the loop-invariant iota half of the router's "
        "aux-loss one_hot out of the layer scan into the microbatch "
        "body: a `_one_hot` call of no operand, (1, E); torch runs the "
        "one_hot inside its layer (the depth-2 site both sides have)",
    (MOE, "train", "port",
     ("ATOM003", "note", "histogram_scatter", 2)):
        "the port's combine is K5, a segment sum over the expert-sorted "
        "rows, with each row's gate gathered by the sort order "
        "(moe.combine_inputs); the gather's backward accumulates T*k "
        "scalars into T*k bins.  The reference unsorts the rows and "
        "combines them with an einsum against the (T, k) gates: no "
        "gather, so no such scatter",
    (MOE, "prefill", "port",
     ("ATOM001", "warning", "one_hot_histogram", 1)):
        "the port's eager serving step computes the router's aux loss "
        "(its one_hot) and drops it; the reference's jit removes the "
        "unused aux loss from the prefill before lowering",
    (MOE, "decode", "port",
     ("ATOM001", "warning", "one_hot_histogram", 1)):
        "as in the prefill: the eager decode step computes the unused "
        "aux loss's one_hot, which the reference's jit removes",
}


def lax_scan_stacking(site) -> bool:
    """A ``lax.scan`` writing one iteration's slab into its stacked
    output: an update (1, ...) into (L, ...) with equal trailing dims."""
    u, o = tuple(site.update_shape), tuple(site.operand_shape)
    return (site.kind == "kv_cache_write" and len(u) > 0 and u[0] == 1
            and len(u) == len(o) and u[1:] == o[1:])


def _triple(f):
    return (f.rule_id, f.severity, f.site.kind, f.site.loop_depth)


def _by_step(report):
    out = collections.defaultdict(list)
    for f in report.findings:
        if f.site is not None:
            out[f.label.split("/")[1]].append(f)
    return out


@pytest.fixture(scope="module")
def reports():
    """Every config, reduced: (the port's report, the reference's)."""
    port, ref = Session("v5e"), RefSession("v5e")
    return {arch: (audit_config(arch, session=port, reduced=True),
                   ref_audit_config(arch, session=ref, reduced=True))
            for arch in ZOO}


def _allowed(arch, step, side):
    return {triple for (archs, s, sd, triple) in DIVERGENCES
            if arch in archs and s == step and sd == side}


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_findings_equal_the_reference(reports, arch):
    """Per step, the distinct (rule, severity, kind, depth) sets are
    equal after ``lax_scan_stacking`` on the reference's side, but for
    ``DIVERGENCES``; the counts of each triple are printed."""
    port, ref = reports[arch]
    assert port.steps == ref.steps
    pb, rb = _by_step(port), _by_step(ref)
    for step in ref.steps:
        kept = [f for f in rb[step] if not lax_scan_stacking(f.site)]
        dropped = len(rb[step]) - len(kept)
        pc = collections.Counter(_triple(f) for f in pb[step])
        rc = collections.Counter(_triple(f) for f in kept)
        print(f"{arch}/{step}: stacking writes dropped {dropped}")
        for t in sorted(set(pc) | set(rc)):
            print(f"  {t}: port {pc[t]}, reference {rc[t]}")
        only_port = set(pc) - set(rc)
        only_ref = set(rc) - set(pc)
        assert only_port == _allowed(arch, step, "port"), only_port
        assert only_ref == _allowed(arch, step, "reference"), only_ref


def test_divergences_spare_the_sites_that_must_match():
    """The table names no decode K/V write, no MoE histogram or dispatch
    site, no embedding gradient and no label-gather backward."""
    for (archs, step, side, (rule, sev, kind, depth)), why in \
            DIVERGENCES.items():
        assert why
        assert not (step == "decode" and kind == "kv_cache_write")
        assert not (kind == "dispatch_scatter")
        assert not (kind == "histogram_scatter" and side == "reference")
        assert not (step == "train" and depth == 1 and kind in (
            "dispatch_scatter", "histogram_scatter"))


def _fields(site):
    return (site.num_bins, site.num_updates, site.row_elems, site.combiner,
            site.trip_count)


def _dense_sites(findings, step, kind):
    """The findings of one of the three dense sites: the decode K/V
    writes, the embedding gradient (the train step's depth-1 dispatch
    scatter) or the label-gather backward (its depth-1 histogram)."""
    if step == "decode":
        return [f for f in findings if f.site.kind == "kv_cache_write"
                and not lax_scan_stacking(f.site)]
    return [f for f in findings if f.site.kind == kind
            and f.site.loop_depth == 1]


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("step,kind", [
    ("decode", "kv_cache_write"), ("train", "dispatch_scatter"),
    ("train", "histogram_scatter")])
def test_dense_sites_match_the_reference(reports, arch, step, kind):
    """The decode K/V write, the embedding gradient and the label-gather
    backward: the reference's fields, and its utilization and contention
    within rtol 1e-9."""
    port, ref = reports[arch]
    if step not in ref.steps:
        pytest.skip(f"{arch} has no {step} step")
    got = _dense_sites(_by_step(port)[step], step, kind)
    want = _dense_sites(_by_step(ref)[step], step, kind)
    if arch == "rwkv6-7b" and step == "decode":
        assert not got and not want    # RWKV's decode writes no K/V
        return
    assert got and want
    assert {_fields(f.site) for f in got} == {_fields(f.site) for f in want}
    scores = {(_fields(f.site), f.rule_id): (f.utilization, f.contention)
              for f in want}
    for f in got:
        u, c = scores[(_fields(f.site), f.rule_id)]
        assert math.isclose(f.utilization, u, rel_tol=1e-9)
        assert math.isclose(f.contention, c, rel_tol=1e-9)


@pytest.mark.parametrize("arch", MOE)
def test_moe_sites_side_by_side(reports, arch):
    """The MoE histogram and dispatch sites: printed side by side; each
    of the reference's (rule, severity) pairs has a port site of its kind
    and depth.  Their statistics differ by the spare row of the
    dispatch buffer and the one-rank mesh body's capacity."""
    port, ref = reports[arch]
    for step in ref.steps:
        pf = [f for f in _by_step(port)[step]
              if f.site.kind in ("histogram_scatter", "dispatch_scatter")]
        rf = [f for f in _by_step(ref)[step]
              if f.site.kind in ("histogram_scatter", "dispatch_scatter")]
        for side, fs in (("port", pf), ("reference", rf)):
            for f in fs:
                print(f"{arch}/{step} {side}: {f.rule_id} {f.severity} "
                      f"{f.site.kind} depth {f.site.loop_depth} "
                      f"fields {_fields(f.site)} U={f.utilization:.4f}")
        assert {_triple(f) for f in rf} <= {_triple(f) for f in pf}


def test_normalize_arch():
    assert zoo.normalize_arch("zamba2-1.2b") == "zamba2-1.2b"
    assert zoo.normalize_arch("zamba2_1p2b") == "zamba2-1.2b"
    assert zoo.normalize_arch("granite_moe_1b_a400m") \
        == "granite-moe-1b-a400m"
    with pytest.raises(KeyError, match="unknown config"):
        zoo.normalize_arch("nope")
    assert zoo.AUDIT_SHAPES == ref_zoo.AUDIT_SHAPES
    assert zoo._REDUCED_GEOM == ref_zoo._REDUCED_GEOM


def test_qwen3_audit_acceptance():
    """The reference's acceptance test on the port, at full size: the
    qwen3 MoE audit finds the dispatch scatter and the expert-count
    histogram, with rule ids, model-predicted utilization and advisor
    fix-it hints — zero kernel executions."""
    sess = Session("v5e")
    rep = audit_config("qwen3_moe_235b_a22b", session=sess)
    kinds = {f.site.kind for f in rep.findings if f.site is not None}
    assert "dispatch_scatter" in kinds
    assert "histogram_scatter" in kinds
    sited = [f for f in rep.findings if f.site is not None]
    assert len({f.site.op_name for f in sited}) >= 2
    for f in sited:
        assert f.rule_id and f.utilization is not None and f.fixit
    assert sess.stats == ZERO_STATS


def test_from_compiled_fingerprint_stable_across_recapture():
    """Two captures of one step give one fingerprint (the label is
    excluded), and the hlo provider reads the capture."""
    c1, c2 = (zoo.lower_config_steps("granite-moe-1b-a400m",
                                     steps=["decode"], reduced=True)["decode"]
              for _ in range(2))
    s1 = WorkloadSpec.from_compiled(compiled=c1, label="g/decode")
    s2 = WorkloadSpec.from_compiled(compiled=c2, label="relabeled")
    assert s1.fingerprint() is not None
    assert s1.fingerprint() == s2.fingerprint()
    assert c1.text == c2.text
    prof = Session("v5e", provider="hlo").profile(s1)
    assert prof.unit("mxu").utilization > 0
    assert prof.unit("hbm").utilization > 0
    sess = Session("v5e")
    rep = sess.audit(c1, label="g")
    assert rep.label == "g" and rep.findings
    assert [f.rule_id for f in sess.audit(s1).findings] == \
        [f.rule_id for f in rep.findings]


# -- the command line ---------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--config", "granite_moe_1b_a400m", "--reduced"],
    ["--config", "granite-moe-1b-a400m", "zamba2_1p2b", "--reduced",
     "--steps", "decode", "--variant", "base"],
    ["--all", "--reduced", "--format", "sarif", "--fail-on", "warning"],
    ["--config", "nope", "--reduced"]])
def test_cli_audit_config_exit_codes_equal_the_reference(argv, capsys):
    """``audit --config/--all`` exit with the reference's codes (0, 1 at
    the gate, 2 for an unknown config)."""
    rc = main(["audit", *argv, "--no-artifact"])
    out = capsys.readouterr().out
    want = ref_main(["audit", *argv, "--no-artifact"])
    capsys.readouterr()
    assert rc == want
    if rc != 2:
        assert out
    if "sarif" in argv:
        doc = json.loads(out)
        assert doc["runs"][0]["results"]


def test_cli_audit_writes_the_captured_graphs(tmp_path, monkeypatch,
                                              capsys):
    """The printed graphs land where the reference writes its HLO, and
    the SARIF locations name them."""
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path))
    rc = main(["audit", "--config", "qwen2-72b", "--reduced",
               "--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    graphs = sorted((tmp_path / "cli" / "audit" / "graph").iterdir())
    assert [p.name for p in graphs] == [
        f"qwen2_72b__{s}.graph" for s in ("decode", "prefill", "train")]
    uris = {loc["physicalLocation"]["artifactLocation"]["uri"]
            for r in doc["runs"][0]["results"] for loc in r["locations"]}
    assert uris <= {f"graph/{p.name}" for p in graphs}
    assert "aten.copy_" in (graphs[0]).read_text()


def test_cli_audit_as_a_process(tmp_path):
    """``python -m repro_torch audit --config`` in a process of its own."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "REPRO_TORCH_RESULTS": str(tmp_path), "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "repro_torch", "audit",
                        "--config", "granite_moe_1b_a400m", "--reduced",
                        "--format", "json"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout)
    kinds = {f.get("kind") for f in doc["findings"]}
    assert {"dispatch_scatter", "histogram_scatter",
            "kv_cache_write"} <= kinds


def test_example_runs():
    """``examples/torch_audit_zoo.py``: the reference example's
    assertions on the port."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_audit_zoo
        assert torch_audit_zoo.main() == 0
    finally:
        sys.path.remove(str(REPO / "examples"))


def test_capture_under_a_callers_group_runs_in_a_child(tmp_path):
    """With a process group already set up, the zoo's capture leaves it
    alone: it captures in a child process, to the same graph."""
    import torch.distributed as dist
    want = zoo.lower_config_steps("qwen2-72b", steps=["decode"],
                                  reduced=True)["decode"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        got = zoo.lower_config_steps("qwen2-72b", steps=["decode"],
                                     reduced=True)["decode"]
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert got.text == want.text
