"""The port's kernel lint (``repro_torch.lint``) against the reference's.

First the reference's own cases (``tests/test_lint.py``) on the port:
the symbolic layer, a kernel model's structure, KERN003 and KERN004 on
synthetic launches (declarations here, Pallas kernels there), the static
stream against both packages' ``committed_index_stream``, the static
counters bit for bit against both packages' ``TraceProvider`` with zero
collections and zero launches, the reorder floor, the registry's
verdicts, ``Session.lint``, the SARIF catalog, ``merge_sarif``,
``attach_advice`` and the command line.

Then both packages on the same targets.  The reference's lint traces
its Pallas kernels with jax APIs that moved in newer jax; the fixture
``ref_lint`` runs it through ``_ref_lint_compat``'s shim, scoped to the
test by ``pytest.MonkeyPatch.context()`` (``test_reference_compat_is_
scoped`` holds it so; ``tests/test_lint.py`` runs without it).  Each
registered kernel and the hist/hist2 solid and uniform ``lint_spec``s
give the same findings (rule, severity, suppression, label, message,
fixit, site), utilization and contention within rtol 1e-9, and the same
SARIF apart from result locations; ``python -m repro_torch lint`` and
``python -m repro lint`` print the same report for the same argv.  What
differs by design stands in ``DIVERGENCES`` with its reason.

Last the port's own: the tracer on each aten operation it models, the
declarations against the routes their launchers take and against the
SASS their kernels compiled to, in-source suppression, and K3 and K6
(their plain versions here; ``chip_smoke.py`` runs the kernels) against
the static derivation.
"""

import copy
import csv
import gzip
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _lint_card
import _lint_noqa_target
from _port_compare import assert_csv_close, assert_json_close
from _ref_lint_compat import compat_applied, reference_lint_compat
from repro import lint as ref_lint_mod
from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefWorkloadSpec
from repro.analysis.providers.trace import TraceProvider as RefTraceProvider
from repro.cli.main import main as ref_main
from repro.kernels.histogram import ops as ref_hist_ops
from repro.lint import tracing as ref_tracing
from repro_torch import audit as audit_mod
from repro_torch import lint as lint_mod
from repro_torch.analysis import Session, WorkloadSpec
from repro_torch.analysis.providers.trace import TraceProvider
from repro_torch.audit.report import noqa_for_object
from repro_torch.cli.main import main
from repro_torch.core import timing
from repro_torch.data.images import make_image
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.histogram import kernel as hk
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.scatter_add import kernel as sk
from repro_torch.lint import registry as lint_registry_mod
from repro_torch.lint import symbolic
from repro_torch.lint.analysis import (DATA_DEPENDENT, OPAQUE, STATIC,
                                       LintTarget, analyze_target,
                                       degree_stats, derive_counters,
                                       derive_stream, target_from_spec)
from repro_torch.lint.tracing import (Accumulator, LaunchDecl, Operand,
                                      combine_classes, trace_stream)

PROBE_PIXELS = lint_registry_mod.PROBE_PIXELS
REPO = Path(__file__).resolve().parents[1]
KERNELS = ("hist", "hist2", "hist_weighted", "scatter_add", "moe_dispatch",
           "flash_attention")

# what differs between the two lints by design: (kernel or "*", rule id
# or report field) -> why
DIVERGENCES = {
    ("scatter_add", "KERN002"):
        "at the probe's (4096, 32) f32 result, 512 KiB, above K5's shared "
        "budget of 96 KiB, K5 takes its global-vector route: f32x4 adds at "
        "L2 (REDG.E.ADD.F32x4, which chip_smoke.py requires in the SASS), "
        "no shared copy, so no bank stride.  The reference's one-hot matmul "
        "accumulates 32-value rows in VMEM, where the rule fires and its "
        "kernel module suppresses it; a suppressed finding does not gate, "
        "so the active findings agree",
    ("*", "instructions_scanned"):
        "the reference counts the equations of each Pallas kernel's jaxpr; "
        "the port counts the aten operations of the traced stream and the "
        "declaration's writes (zeroing, accumulation, stores)",
    ("*", "location"):
        "a finding's location: the reference names the launcher it traces "
        "(its lint's analysis.py or registry.py), the port the CUDA "
        "kernel's __global__ function under kernels/csrc",
}


def _diverging_rules(kernel):
    return {rule for (k, rule) in DIVERGENCES
            if k in (kernel, "*") and rule.startswith("KERN")}


@pytest.fixture
def ref_lint():
    """The reference's lint with the jax shim, for this test only."""
    with pytest.MonkeyPatch.context() as mp:
        reference_lint_compat(mp)
        yield ref_lint_mod


@pytest.fixture(scope="module")
def sess():
    return Session("v5e")


@pytest.fixture
def no_launches():
    """Every launch count zero before the test, held zero after it."""
    for mod in (hk, sk, fk):
        mod.reset_launches()
    yield
    assert not any({**hk.LAUNCHES, **sk.LAUNCHES, **fk.LAUNCHES}.values())


def _probe_spec(variant, kind="solid", pixels=PROBE_PIXELS, cls=WorkloadSpec):
    img = make_image(kind, pixels, seed=0)
    return cls.from_histogram(
        img, label=f"{variant}-{kind}", variant=variant,
        waves_per_tile=8, overhead_cycles=2500.0)


def _model(target):
    (model,) = analyze_target(target)
    return model


# -- symbolic expressions ----------------------------------------------------


_I32 = np.dtype("int32")


def test_symbolic_affine_evaluation():
    # (iota(8) * 4 + pid) % 8 evaluated exactly
    iota = symbolic.Iota(shape=(8,), dtype=_I32, dim=0)
    four = symbolic.Const(shape=(), dtype=_I32, value=np.int32(4))
    eight = symbolic.Const(shape=(), dtype=_I32, value=np.int32(8))
    pid = symbolic.ProgramId(shape=(), dtype=_I32, axis=0)
    mul = symbolic.Elem(shape=(8,), dtype=_I32, op="mul",
                        args=(iota, four))
    add = symbolic.Elem(shape=(8,), dtype=_I32, op="add", args=(mul, pid))
    expr = symbolic.Elem(shape=(8,), dtype=_I32, op="rem",
                         args=(add, eight))
    got = symbolic.evaluate(expr, {("pid", 0): 3})
    np.testing.assert_array_equal(got, (np.arange(8) * 4 + 3) % 8)


def test_symbolic_trunc_and_floor_division():
    # div/rem truncate toward zero (C, lax); floor_divide/remainder round
    # toward minus infinity, the remainder taking the divisor's sign
    # (Python, torch.remainder)
    num = symbolic.Const(shape=(3,), dtype=_I32,
                         value=np.array([-7, 7, -7], np.int32))
    den = symbolic.Const(shape=(3,), dtype=_I32,
                         value=np.array([2, -2, -2], np.int32))

    def ev(op):
        return symbolic.evaluate(symbolic.Elem(
            shape=(3,), dtype=_I32, op=op, args=(num, den)), {})

    np.testing.assert_array_equal(ev("div"), [-3, -3, 3])
    np.testing.assert_array_equal(ev("rem"), [-1, 1, -1])
    np.testing.assert_array_equal(ev("floor_divide"), [-4, -4, 3])
    np.testing.assert_array_equal(ev("remainder"), [1, -1, -1])
    t_num, t_den = torch.tensor([-7, 7, -7]), torch.tensor([2, -2, -2])
    np.testing.assert_array_equal(ev("floor_divide"),
                                  torch.floor_divide(t_num, t_den))
    np.testing.assert_array_equal(ev("remainder"),
                                  torch.remainder(t_num, t_den))


def test_symbolic_gather_along_an_axis():
    src = symbolic.Const(shape=(2, 3), dtype=_I32,
                         value=np.array([[1, 2, 3], [4, 5, 6]], np.int32))
    idx = symbolic.Const(shape=(2, 3), dtype=_I32,
                         value=np.array([[2, 0, 1], [1, 1, 0]], np.int32))
    got = symbolic.evaluate(symbolic.Gather(shape=(2, 3), dtype=_I32,
                                            src=src, index=idx, dim=1), {})
    np.testing.assert_array_equal(got, [[3, 1, 2], [5, 5, 4]])
    bad = symbolic.Const(shape=(2, 3), dtype=_I32,
                         value=np.full((2, 3), 3, np.int32))
    with pytest.raises(symbolic.EvalError):
        symbolic.evaluate(symbolic.Gather(shape=(2, 3), dtype=_I32, src=src,
                                          index=bad, dim=1), {})


def test_symbolic_data_refs_and_program_axes():
    data = symbolic.Data(shape=(4,), dtype=_I32, ref=2, name="ref2")
    pid = symbolic.ProgramId(shape=(), dtype=_I32, axis=1)
    expr = symbolic.Elem(shape=(4,), dtype=_I32, op="add",
                         args=(data, pid))
    assert symbolic.data_refs(expr) == {2}
    assert symbolic.program_axes(expr) == {1}
    assert symbolic.data_refs(pid) == set()


# -- tracing: the stream and the model ---------------------------------------


def _ops_stream(x):
    """Every aten operation the tracer models, on an (8, 4) int32 block."""
    a = torch.arange(8, dtype=torch.int32, device=x.device)[:, None] - 3
    b = torch.remainder(a * 5 - x, 7) + torch.div(x - 9, 4,
                                                  rounding_mode="floor")
    c = torch.div(x - 9, 4, rounding_mode="trunc") // 2
    g = torch.gather(x, 1, torch.remainder(x, 4).to(torch.int64))
    h = (x / 4 - 0.5).to(torch.int32)          # true division, truncated
    w = torch.where(x > 2, b, c) + g.to(torch.int32) + h
    out = w.transpose(0, 1)[1:3].unsqueeze(0).expand(3, 2, 8)
    return torch.maximum(out, -out).reshape(-1)[::2]


def test_trace_stream_models_each_aten_op():
    expr, ops = trace_stream(_ops_stream, [(0, "x", (8, 4), torch.int32)])
    assert symbolic.opaque_reasons(expr) == [] and ops > 15
    assert symbolic.data_refs(expr) == {0}
    x = np.random.default_rng(1).integers(-40, 40, (8, 4)).astype(np.int32)
    got = symbolic.evaluate(expr, {("ref", 0): x})
    np.testing.assert_array_equal(got, _ops_stream(torch.from_numpy(x)))


def test_an_unmodeled_op_is_opaque_by_its_aten_name():
    def sorted_stream(x):
        return torch.sort(x.reshape(-1)).values + 1

    expr, _ = trace_stream(sorted_stream, [(0, "ids", (2048,), torch.int32)])
    assert any("aten.sort" in r for r in symbolic.opaque_reasons(expr))
    grid, ids = sk._id_stream(2048, sk.DEFAULT_TILE)
    decl = LaunchDecl(
        kernel="bincount_kernel<store>", source="csrc/scatter_add.cu",
        grid=grid, inputs=(ids,),
        accumulators=(Accumulator("counts", (64,), 64),),
        stream=sorted_stream, stream_refs=((0, torch.int32),))
    model = _model(LintTarget("sorted", decl, (np.zeros(2048, np.int32),)))
    deriv = derive_stream(model, model.sites[0], (np.zeros(2048, np.int32),))
    assert deriv.classification == OPAQUE
    assert deriv.reasons[0].startswith("unmodeled op: aten.sort")


def test_hist_kernel_model_structure():
    target = lint_registry_mod.build_target("hist")
    m = _model(target)
    assert m.grid == (PROBE_PIXELS // 2048,)   # one step per 2048-px tile
    site = m.sites[0]
    assert site.kind == "one_hot_popcount"
    assert site.rmw and site.num_bins == 1024 and site.row_elems == 1
    # each block zeroes its shared copy before __syncthreads: an init
    # guard on every grid axis
    assert m.init_guards.get(site.ref) == {0}
    assert (site.memory, site.padded, site.combine) == ("shared", False,
                                                        "popc")
    assert m.source_file.endswith("kernels/csrc/histogram.cu")
    src = Path(m.source_file).read_text().splitlines()
    assert "hist_kernel(" in src[m.source_line - 1]
    assert "__global__" in src[m.source_line - 2]


def test_unguarded_accumulation_fires_kern003(sess):
    # an accumulator no block and no launcher zeroes, shared across the
    # grid axis: a race on any order, uninitialized memory on every one
    decl = LaunchDecl(
        kernel="unguarded", source="csrc/histogram.cu", grid=(4,),
        inputs=(Operand("x", (256, 8), (0, None)),),
        accumulators=(Accumulator("o", (8,), 8, memory="global",
                                  init="none", combine="fao", flush=""),))
    target = LintTarget(label="unguarded", decl=decl, operands=(None,),
                        job_class=timing.FAO, waves_per_tile=8)
    findings = lint_mod.evaluate_target(target, sess)
    assert any(f.rule_id == "KERN003" and f.severity == "error"
               for f in findings), findings
    guarded = LintTarget(label="guarded", decl=LaunchDecl(
        kernel="guarded", source="csrc/histogram.cu", grid=(4,),
        inputs=decl.inputs, accumulators=(Accumulator(
            "o", (8,), 8, memory="global", init="caller", combine="fao",
            flush=""),)), operands=(None,), job_class=timing.FAO)
    assert lint_mod.evaluate_target(guarded, sess) == []


def test_while_swap_fires_kern004(sess):
    # an atomicCAS retry loop written in the source, with no stream the
    # lint could derive a site from: structural KERN004
    decl = LaunchDecl(
        kernel="retry", source="csrc/histogram.cu", grid=(2,),
        inputs=(Operand("x", (8,), (None,)),),
        accumulators=(Accumulator("o", (8,), 8, init="block",
                                  combine="cas", retry_loop=True),))
    models = analyze_target(LintTarget("retry", decl, (None,)))
    assert models[0].while_has_swap and not models[0].sites
    target = LintTarget(label="retry", decl=decl, operands=(None,),
                        job_class=timing.FAO, waves_per_tile=8)
    findings = lint_mod.evaluate_target(target, sess, models=models)
    assert any(f.rule_id == "KERN004" for f in findings), findings


# -- static derivation: the bit-for-bit guarantee ----------------------------


@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_static_stream_equals_committed_stream(variant):
    spec = _probe_spec(variant, "solid")
    target = target_from_spec(spec)
    m = _model(target)
    site = m.sites[0]
    deriv = derive_stream(m, site, target.operands)
    assert deriv.classification == STATIC, deriv.reasons
    img = spec.kernel.params["img"]
    assert site.num_bins == 256 * img.shape[-1]
    expected = hist_ops.committed_index_stream(
        img, num_bins=256, variant=variant)
    np.testing.assert_array_equal(deriv.stream, expected)
    np.testing.assert_array_equal(deriv.stream,
                                  ref_hist_ops.committed_index_stream(
                                      img, num_bins=256, variant=variant))
    # and the function K3's degrees are held to, on the whole image
    plain = hk.issue_ordered_bins_plain(
        torch.from_numpy(img), 256, variant == "hist2")
    np.testing.assert_array_equal(deriv.stream, plain.numpy())


@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_uniform_probe_is_data_dependent(variant):
    # non-constant operand contents cannot be proved: the lint must
    # classify them for the dynamic path, never guess a stream
    spec = _probe_spec(variant, "uniform")
    target = target_from_spec(spec)
    m = _model(target)
    deriv = derive_stream(m, m.sites[0], target.operands)
    assert deriv.classification == DATA_DEPENDENT
    assert deriv.stream is None


def _assert_fields_equal(got, want):
    for field in vars(want):
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field


@pytest.mark.parametrize("variant", ["hist", "hist2"])
def test_derived_counters_bitwise_equal_trace_provider(variant, no_launches):
    sess = Session("v5e")
    spec = _probe_spec(variant)
    derived, deriv = derive_counters(spec)
    assert derived is not None and deriv.is_static
    _assert_fields_equal(derived, TraceProvider().collect(spec, sess.device))
    ref_sess = RefSession("v5e")
    ref_spec = _probe_spec(variant, cls=RefWorkloadSpec)
    _assert_fields_equal(derived,
                         RefTraceProvider().collect(ref_spec,
                                                    ref_sess.device))
    # the whole derivation ran zero collections
    assert sess.stats == {"collected": 0, "memo_hits": 0, "disk_hits": 0,
                          "batch_calls": 0}


def test_degree_floor_separates_hist_from_hist2():
    stats = {}
    for variant in ("hist", "hist2"):
        target = target_from_spec(_probe_spec(variant))
        m = _model(target)
        stats[variant] = degree_stats(derive_stream(m, m.sites[0],
                                                    target.operands))
    assert stats["hist"].mean_degree == 32.0
    assert stats["hist"].floor_degree == 8.0
    assert stats["hist2"].mean_degree == pytest.approx(
        stats["hist2"].floor_degree)


# -- rule firing over the registry -------------------------------------------


def test_hist_fires_kern001_error(sess):
    rep = lint_mod.lint_kernel("hist", session=sess)
    f = next(f for f in rep.findings if f.rule_id == "KERN001")
    assert f.severity == "error" and not f.suppressed
    assert f.utilization is not None and f.contention > 1.0
    assert "derived mean degree 32.0 vs reorder floor 8.0" in f.message


def test_hist2_lints_clean(sess):
    rep = lint_mod.lint_kernel("hist2", session=sess)
    assert rep.active() == [] and rep.sites_scanned == 1


def test_flash_attention_lints_clean(sess):
    rep = lint_mod.lint_kernel("flash_attention", session=sess)
    assert rep.active() == [] and rep.sites_scanned == 0


def test_weighted_hist_fires_kern004(sess):
    rep = lint_mod.lint_kernel("hist_weighted", session=sess)
    ids = {f.rule_id for f in rep.active()}
    assert "KERN004" in ids and "KERN001" in ids


def test_scatter_add_has_no_shared_copy_for_kern002(sess):
    # K5 at the probe takes its global-vector route: no shared copy, so
    # no bank stride to find (DIVERGENCES), and no noqa in its module
    target = lint_registry_mod.build_target("scatter_add")
    assert target.decl.kernel == "scatter_tiles_kernel<f32,vector>"
    (acc,) = target.decl.accumulators
    assert (acc.memory, acc.combine, acc.vector) == ("global", "fao", 4)
    rep = lint_mod.lint_kernel("scatter_add", session=sess)
    assert [f.rule_id for f in rep.findings] == ["KERN005"]
    assert not rep.findings[0].suppressed
    assert "KERN002" not in noqa_for_object(sk)


def test_in_source_suppression_of_kern002(sess):
    # an unpadded shared copy of 32-value rows (K5's shared route), linted
    # from a module that carries `# repro: noqa KERN002`
    target = _lint_noqa_target.shared_route_target()
    assert target.decl.kernel == "scatter_tiles_kernel<f32,shared>"
    assert noqa_for_object(target.module) == {"KERN002"}
    rep = lint_mod.lint_target(target, session=sess)
    k2 = [f for f in rep.findings if f.rule_id == "KERN002"]
    assert k2 and all(f.suppressed and f.severity == "warning" for f in k2)
    k5 = [f for f in rep.findings if f.rule_id == "KERN005"]
    assert k5 and not any(f.suppressed for f in k5)
    res = [r for r in rep.to_sarif()["runs"][0]["results"]
           if r["ruleId"] == "KERN002"]
    assert res[0]["suppressions"] == [{"kind": "inSource"}]
    # linted from K5's own module, which carries no suppression, the same
    # launch's KERN002 is active, beside KERN004: a shared atomicAdd(float)
    # is a CAS loop on Hopper
    rep = lint_mod.lint_spec(_lint_noqa_target.shared_route_spec(),
                             session=sess)
    active = {f.rule_id: f for f in rep.active()}
    assert set(active) == {"KERN002", "KERN004", "KERN005"}
    assert active["KERN002"].severity == "warning"
    assert active["KERN004"].site.combiner == "cas"


def test_data_dependent_kernels_emit_kern005_with_spec(sess):
    rep = lint_mod.lint_kernel("moe_dispatch", session=sess)
    f = next(f for f in rep.findings if f.rule_id == "KERN005")
    assert f.severity == "note"
    assert f.spec is not None        # carries the dynamic-audit workload
    assert f.site.classification == DATA_DEPENDENT


def test_session_lint_front_door(sess, no_launches):
    rep = sess.lint(["hist2"])
    assert rep.active() == []
    rep = sess.lint(_probe_spec("hist"))   # a WorkloadSpec routes through
    assert any(f.rule_id == "KERN001" for f in rep.findings)
    assert not any(sess.stats_snapshot().values())


# -- unified audit/lint reporting --------------------------------------------


def test_sarif_catalog_spans_audit_and_kern_rules(sess):
    rep = lint_mod.lint_kernel("hist", session=sess)
    sarif = rep.to_sarif()
    ids = [d["id"] for d in sarif["runs"][0]["tool"]["driver"]["rules"]]
    for rid in ("ATOM001", "BANK001", "GEOM001", "AUDIT000",
                "KERN001", "KERN005"):
        assert rid in ids
    for r in sarif["runs"][0]["results"]:
        assert ids[r["ruleIndex"]] == r["ruleId"]


def test_merge_sarif_reindexes_by_rule_id(sess):
    lint_doc = lint_mod.lint_kernel("hist", session=sess).to_sarif()
    audit_doc = {"runs": [{"results": [
        {"ruleId": "ATOM001", "ruleIndex": 99, "level": "error",
         "message": {"text": "x"}}]}]}
    merged = audit_mod.merge_sarif([audit_doc, lint_doc])
    ids = [d["id"] for d in merged["runs"][0]["tool"]["driver"]["rules"]]
    results = merged["runs"][0]["results"]
    assert len(results) == 1 + len(lint_doc["runs"][0]["results"])
    for r in results:
        assert ids[r["ruleIndex"]] == r["ruleId"]
    json.dumps(merged)               # serializable end to end


def test_attach_advice_rotation_in_paper_band(sess):
    rep = lint_mod.lint_kernel("hist", session=sess)
    audit_mod.attach_advice(rep, sess)
    f = next(f for f in rep.findings if f.rule_id == "KERN001")
    assert f.advice is not None
    assert "rotation" in f.advice["families"]
    # the paper's headline: reordering buys up to ~30%
    assert 1.0 < f.advice["predicted_speedup"] <= 1.30
    assert f.advice["predicted_bottleneck"]
    res = next(r for r in rep.to_sarif()["runs"][0]["results"]
               if r["ruleId"] == "KERN001")
    assert res["properties"]["advise"]["families"] == f.advice["families"]


# -- CLI ---------------------------------------------------------------------


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_RESULTS", str(tmp_path / "port"))
    return tmp_path


def test_cli_lint_gate(results, capsys, no_launches):
    rc = main(["lint", "--kernel", "hist2", "--fail-on", "warning",
               "--no-artifact"])
    assert rc == 0
    assert "no findings" in capsys.readouterr().out
    out_path = results / "lint.sarif"
    rc = main(["lint", "--kernel", "hist", "--format", "sarif",
               "--output", str(out_path), "--no-artifact"])
    assert rc == 1                   # KERN001 is an error at default gate
    doc = json.loads(out_path.read_text())
    assert any(r["ruleId"] == "KERN001"
               for r in doc["runs"][0]["results"])


def test_cli_lint_list(capsys):
    assert main(["lint", "--list"]) == 0
    assert capsys.readouterr().out.split() == list(KERNELS)


def test_cli_lint_sarif_merges_with_an_audit_sarif(results, capsys):
    hlo = results / "granite.hlo"
    hlo.write_bytes(gzip.decompress(
        (REPO / "tests" / "data" /
         "granite_moe_1b_a400m__decode.hlo.gz").read_bytes()))
    assert main(["lint", "--format", "sarif", "--output",
                 str(results / "lint.sarif")]) == 1
    assert main(["audit", "--hlo-file", str(hlo), "--format", "sarif",
                 "--output", str(results / "audit.sarif"),
                 "--fail-on", "never"]) == 0
    capsys.readouterr()
    docs = [json.loads((results / f"{t}.sarif").read_text())
            for t in ("audit", "lint")]
    merged = audit_mod.merge_sarif(docs)
    ids = [d["id"] for d in merged["runs"][0]["tool"]["driver"]["rules"]]
    results_ = merged["runs"][0]["results"]
    assert len(results_) == sum(len(d["runs"][0]["results"]) for d in docs)
    assert {r["ruleId"] for r in results_} >= {"KERN001", "KERN005"}
    for r in results_:
        assert ids[r["ruleIndex"]] == r["ruleId"]


def test_cli_lint_as_a_process_needs_no_card(results):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="",
               REPRO_TORCH_RESULTS=str(results / "port"))
    runs = [subprocess.run(
        [sys.executable, "-m", "repro_torch", "lint", *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        for argv in (["--format", "json"],
                     ["--kernel", "hist2", "--fail-on", "warning"])]
    assert [r.returncode for r in runs] == [1, 0], runs[0].stderr
    assert json.loads(runs[0].stdout)["counts"] == {
        "error": 3, "warning": 0, "note": 2}


# -- both packages on the same targets ---------------------------------------


def test_reference_compat_is_scoped():
    """The shim is in place inside its context and gone after it, so
    ``tests/test_lint.py`` sees this jax as it is, whatever ran before."""
    assert not compat_applied()
    with pytest.MonkeyPatch.context() as mp:
        reference_lint_compat(mp)
        assert compat_applied()
    assert not compat_applied()
    assert not hasattr(jax.core, "ClosedJaxpr")
    assert not hasattr(ref_tracing._Interpreter, "_prim_jit")


def _site_key(site):
    if site is None:
        return None
    return (site.op_name, site.kind, site.num_bins, site.num_updates,
            site.row_elems, site.combiner, site.trip_count,
            site.classification)


def _finding_key(f):
    return (f.rule_id, f.rule_slug, f.severity, f.suppressed, f.label,
            f.message, f.fixit, f.hint, f.bottleneck, _site_key(f.site),
            None if f.spec is None else f.spec.label,
            None if f.spec is None else f.spec.fingerprint())


def assert_reports_match(kernel, got, want):
    """Findings equal but for ``DIVERGENCES``; floats within rtol 1e-9."""
    drop = _diverging_rules(kernel)
    kept = [f for f in want.findings if f.rule_id not in drop]
    assert [_finding_key(f) for f in got.findings] == \
        [_finding_key(f) for f in kept]
    for g, w in zip(got.findings, kept):
        for field in ("utilization", "baseline_utilization", "contention"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if b is not None:
                assert a == pytest.approx(b, rel=1e-9, abs=0.0), field
    assert (got.label, got.device, got.steps, got.sites_scanned,
            got.counts()) == (want.label, want.device, want.steps,
                              want.sites_scanned, want.counts())


def _sarif_comparable(doc, drop_rules):
    doc = copy.deepcopy(doc)
    run = doc["runs"][0]
    run["results"] = [r for r in run["results"]
                      if r["ruleId"] not in drop_rules]
    for r in run["results"]:
        r.pop("locations", None)     # DIVERGENCES: location
    return doc


@pytest.mark.parametrize("kernel", KERNELS)
def test_registry_report_equals_reference(ref_lint, kernel, no_launches):
    sess, ref_sess = Session("v5e"), RefSession("v5e")
    got = lint_mod.lint_kernel(kernel, session=sess)
    want = ref_lint.lint_kernel(kernel, session=ref_sess)
    assert_reports_match(kernel, got, want)
    drop = _diverging_rules(kernel)
    assert_json_close(_sarif_comparable(got.to_sarif(), drop),
                      _sarif_comparable(want.to_sarif(), drop))
    assert not any(sess.stats_snapshot().values())


@pytest.mark.parametrize("variant", ["hist", "hist2"])
@pytest.mark.parametrize("kind", ["solid", "uniform"])
def test_lint_spec_equals_reference(ref_lint, variant, kind):
    got = lint_mod.lint_spec(_probe_spec(variant, kind),
                             session=Session("v5e"))
    want = ref_lint.lint_spec(_probe_spec(variant, kind, cls=RefWorkloadSpec),
                              session=RefSession("v5e"))
    assert_reports_match(variant, got, want)
    assert [f.rule_id for f in got.findings] == (
        {("hist", "solid"): ["KERN001"], ("hist2", "solid"): [],
         ("hist", "uniform"): ["KERN005"],
         ("hist2", "uniform"): ["KERN005"]}[(variant, kind)])


def test_attach_advice_equals_reference(ref_lint):
    got = lint_mod.lint_kernel("hist", session=Session("v5e"))
    want = ref_lint.lint_kernel("hist", session=RefSession("v5e"))
    audit_mod.attach_advice(got, Session("v5e"))
    from repro import audit as ref_audit
    ref_audit.attach_advice(want, RefSession("v5e"))
    assert_json_close([f.advice for f in got.findings],
                      [f.advice for f in want.findings])


_INSTRUCTIONS = re.compile(r"from \d+ instruction\(s\)")


def _comparable_output(text, fmt, drop_rules):
    """A CLI report with what ``DIVERGENCES`` lists taken out."""
    if fmt == "text":
        return _INSTRUCTIONS.sub("from N instruction(s)", text)
    if fmt == "sarif":
        return _sarif_comparable(json.loads(text), drop_rules)
    if fmt == "json":
        doc = json.loads(text)
        doc.pop("instructions_scanned")
        doc["findings"] = [
            {k: v for k, v in row.items() if k != "hlo_line"}
            for row in doc["findings"] if row["rule"] not in drop_rules]
        return doc
    rows = list(csv.DictReader(io.StringIO(text)))
    out = io.StringIO()
    fields = [k for k in rows[0] if k != "hlo_line"]
    writer = csv.DictWriter(out, fields, extrasaction="ignore")
    writer.writeheader()
    writer.writerows(rows)
    return out.getvalue()


def _cli(fn, argv, capsys, root):
    rc = fn(list(argv))
    cap = capsys.readouterr()
    arts = sorted((root / "cli" / "lint").glob("*"))
    return (rc, cap.out, cap.err.replace(str(root), ""),
            [(p.name, p.read_text()) for p in arts])


@pytest.mark.parametrize("argv,fmt", [
    (["--kernel", "hist"], "text"),
    (["--kernel", "hist2", "--fail-on", "warning"], "text"),
    (["--kernel", "hist_weighted", "--format", "csv"], "csv"),
    (["--kernel", "moe_dispatch", "--fail-on", "note", "--format", "json"],
     "json"),
    (["--kernel", "flash_attention", "--format", "sarif"], "sarif"),
    (["--kernel", "hist", "--advise", "--format", "sarif"], "sarif"),
    (["--kernel", "hist", "hist2", "--suppress", "KERN001"], "text"),
    (["--kernel", "scatter_add", "--format", "sarif"], "sarif"),
    (["--format", "json", "--num-cores", "4"], "json"),
    (["--list"], "list")])
def test_cli_lint_equals_reference(ref_lint, results, capsys, argv, fmt):
    drop = {"KERN002"} if "--kernel" not in argv or "scatter_add" in argv \
        else set()
    assert drop <= _diverging_rules("scatter_add")
    want = _cli(ref_main, ["lint", *argv], capsys, results / "ref")
    got = _cli(main, ["lint", *argv], capsys, results / "port")
    assert got[0] == want[0] and got[2] == want[2]
    if fmt == "csv":
        assert_csv_close(_comparable_output(got[1], fmt, drop),
                         _comparable_output(want[1], fmt, drop))
    elif fmt in ("json", "sarif"):
        assert_json_close(_comparable_output(got[1], fmt, drop),
                          _comparable_output(want[1], fmt, drop))
    else:
        assert _comparable_output(got[1], fmt, drop) == \
            _comparable_output(want[1], fmt, drop)
    assert [name for name, _ in got[3]] == [name for name, _ in want[3]]


# -- the declarations against the launchers and their SASS --------------------


def test_declarations_follow_the_launchers_routes():
    # K5: shared while the (S, D) f32 result fits 96 KiB, else the global
    # routes by row width and alignment
    def k5(n, d, s, dtype=torch.float32):
        return sk.scatter_add_lint_declaration(n, d, s, dtype).kernel

    assert k5(4096, 32, 64) == "scatter_tiles_kernel<f32,shared>"
    assert k5(4096, 1, 64) == "scatter_rows_kernel<f32,shared>"
    assert k5(4096, 1, 1 << 16) == "scatter_rows_kernel<f32>"
    assert k5(4096, 6, 8192, torch.bfloat16) == "scatter_tiles_kernel<bf16>"
    assert k5(4096, 32, 4096) == "scatter_tiles_kernel<f32,vector>"
    assert k5(4096, 2048, 64, torch.bfloat16) == \
        "scatter_owned_kernel<bf16>"
    for n, d, s in ((4096, 32, 64), (4096, 32, 4096), (4096, 2048, 64)):
        values = torch.zeros((n, d))
        route = sk.scatter_add_route(values, s)
        decl = sk.scatter_add_lint_declaration(n, d, s)
        assert ({"shared": "shared,", "global-vector": "vector",
                 "global-owned": "owned"}[route].rstrip(",")
                in decl.kernel)
    # K7: one block up to 8192 ids, one an SM beyond
    assert sk.bincount_lint_declaration(8192, 64).kernel == \
        "bincount_kernel<store>"
    decl = sk.bincount_lint_declaration(8193, 64)
    assert decl.kernel == "bincount_kernel<>"
    assert decl.accumulators[0].flush == "add"
    # K8: f32 on the CUDA cores, bf16 on wgmma or mma.sync
    assert fk.lint_declaration(1, 4, 1024, 64).kernel == \
        "flash_f32_kernel<64>"
    assert fk.lint_declaration(1, 4, 1024, 128, dtype=torch.bfloat16
                               ).kernel == "flash_bf16_sm90_kernel<128>"
    assert fk.lint_declaration(2, 4, 100, 32, dtype=torch.bfloat16
                               ).grid == (2, 4, 2)
    # K2/K4: the image's tiles, K4's copy padded and CAS-combined
    decl = hk.lint_declaration(5000, 3, weighted=True, reorder=True)
    assert decl.kernel == "hist_weighted_kernel<reorder>"
    assert decl.grid == (3,)
    (acc,) = decl.accumulators
    assert (acc.padded, acc.combine, acc.bins) == (True, "cas", 3 * 256)


# the atomic opcodes cuobjdump listed for these instantiations on the H100
# (chip_smoke.py's build phase); the card checks the live ones
SASS = {
    "hist_kernel<>": ["ATOMS.POPC.INC.32", "REDG.E.ADD.STRONG.GPU"],
    "hist_kernel<reorder>": ["ATOMS.POPC.INC.32", "REDG.E.ADD.STRONG.GPU"],
    "hist_weighted_kernel<>": [
        "ATOMS.CAST.SPIN", "MATCH.ANY", "REDG.E.ADD.F32.FTZ.RN.STRONG.GPU",
        "REDUX.MAX", "SHFL.BFLY", "SHFL.IDX", "VOTE.ANY"],
    "scatter_tiles_kernel<f32,vector>": [
        "MATCH.ANY", "REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU", "SHFL.IDX",
        "VOTE.ANY"],
    "scatter_tiles_kernel<f32,shared>": [
        "ATOMS.CAST.SPIN", "MATCH.ANY", "REDG.E.ADD.F32.FTZ.RN.STRONG.GPU",
        "SHFL.IDX", "VOTE.ANY"],
    "scatter_owned_kernel<bf16>": ["ATOMS.ADD", "ATOMS.POPC.INC.32",
                                   "SHFL.IDX", "SHFL.UP", "VOTE.ANY"],
    "bincount_kernel<store>": ["ATOMS.POPC.INC.32"],
    "bincount_kernel<>": ["ATOMS.POPC.INC.32", "REDG.E.ADD.STRONG.GPU"],
    "flash_f32_kernel<64>": ["SHFL.BFLY", "SHFL.IDX"],
}


def test_combine_classes_of_the_sass():
    assert combine_classes(SASS["hist_kernel<>"]) == {
        ("shared", "popc", 1), ("global", "fao", 1)}
    assert combine_classes(SASS["hist_weighted_kernel<>"]) == {
        ("shared", "cas", 1), ("global", "fao", 1)}
    assert combine_classes(SASS["scatter_tiles_kernel<f32,vector>"]) == {
        ("global", "fao", 4)}
    assert combine_classes(SASS["flash_f32_kernel<64>"]) == set()
    assert combine_classes(["ATOMG.E.EXCH.STRONG.GPU"]) == {
        ("global", "ATOMG.E.EXCH.STRONG.GPU", 1)}
    rows = _lint_card.declared_combines(SASS)
    assert [r["name"] for r in rows] == list(KERNELS)
    for decl in (sk.scatter_add_lint_declaration(4096, 32, 64),
                 sk.scatter_add_lint_declaration(4096, 2048, 64,
                                                 torch.bfloat16),
                 sk.bincount_lint_declaration(1 << 20, 64)):
        assert decl.expected_combines() == combine_classes(SASS[decl.kernel])
    with pytest.raises(AssertionError, match="compiled to"):
        _lint_card.declared_combines({**SASS, "hist_kernel<>": SASS[
            "hist_weighted_kernel<>"]})


def test_a_declaration_refuses_what_a_kernel_cannot_be():
    with pytest.raises(ValueError, match="combine"):
        Accumulator("o", (8,), 8, combine="xor")
    with pytest.raises(ValueError, match="no copy to flush"):
        Accumulator("o", (8,), 8, memory="global", flush="add")


# -- the kernels (their plain versions here) against the lint ----------------


def test_k3_degrees_equal_the_static_derivation():
    for mod in (hk, sk):
        mod.reset_launches()
    rows = _lint_card.k3_against_derivation("cpu")
    assert [(r["name"], r["waves"], r["mean_degree"], r["floor_degree"])
            for r in rows] == [("hist", 128, 32.0, 8.0),
                               ("hist2", 128, 8.0, 8.0),
                               ("hist_weighted", 128, 32.0, 8.0)]


def test_kern005_specs_through_k6(sess):
    rows = _lint_card.kern005_through_k6(Session("v5e"), "cpu")
    assert sorted(r["label"] for r in rows) == [
        "moe_dispatch-uniform/moe_dispatch-uniform",
        "scatter_add-uniform/scatter_add-uniform"]
    assert all(r["e"] > 1.0 for r in rows)


def test_linting_the_registry_launches_nothing(no_launches):
    sess = Session("v5e")
    rep = lint_mod.lint_registry(session=sess)
    assert rep.counts() == {"error": 3, "warning": 0, "note": 2}
    assert rep.sites_scanned == 5
    assert not any(sess.stats_snapshot().values())
