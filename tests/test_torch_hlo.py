"""The port's HLO text route against the reference's, on the same text.

``repro_torch.core.hlo`` (the module walk, its costs and collectives),
the ``hlo`` provider, ``WorkloadSpec.from_compiled(hlo_text=...)``, the
``hlo meta`` render lines and ``--workload hlo`` on the command line.
The port cannot lower a program (that takes JAX), so where the
reference's case in ``tests/test_hlo_analysis.py`` lowers or compiles one,
the reference does it here and both packages read the same text.

The texts: the two reduced goldens the reference's tests pin, the two
full-width qwen3-moe-235b-a22b goldens (``tests/data/
regen_torch_hlo_goldens.py``), a fresh full-width lowering of qwen3-moe
decode, and the crafted texts of ``tests/test_audit.py``.  Parses,
FLOPs, bytes, wire bytes, loops and collectives are equal exactly;
reports go through ``tests/_port_compare.py`` (floats within rtol 1e-9).
"""

import dataclasses
import gzip
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_compare import assert_json_close
from repro.analysis import Session as RefSession
from repro.analysis import WorkloadSpec as RefSpec
from repro.analysis import get_device as ref_get_device
from repro.analysis.providers.hlo import HloProvider as RefHloProvider
from repro.advisor import transforms as ref_transforms
from repro.audit import zoo
from repro.cli.main import main as ref_main
from repro.core import hlo as ref_hlo
from repro_torch.advisor import transforms
from repro_torch.analysis import Session, WorkloadSpec, get_device
from repro_torch.analysis.providers import HloProvider, get_provider
from repro_torch.cli.main import main
from repro_torch.core import counters
from repro_torch.core import hlo
from test_audit import CAS_HLO, HOT_HLO, PLAIN_DUS_HLO, UNRESOLVED_HLO

DATA = pathlib.Path(__file__).parent / "data"
GOLDENS = ("granite_moe_1b_a400m__decode", "whisper_small__train",
           "qwen3_moe_235b_a22b__decode", "qwen3_moe_235b_a22b__prefill")

COLLECTIVE_HLO = """
ENTRY %main (p0: f32[8,8]) -> f32[8,8] {
  %p0 = f32[8,8]{1,0} parameter(0)
  ROOT %ar = f32[8,8]{1,0} all-reduce(%p0), replica_groups=[2,4]<=[8], to_apply=%add
}
"""

# collectives in a resolved loop, referenced by name, with list groups
LOOPED_COLLECTIVES_HLO = """\
HloModule looped

cond {
  p = (s32[], f32[16,64]) parameter(0)
  i = s32[] get-tuple-element(p), index=0
  n = s32[] constant(6)
  ROOT lt = pred[] compare(i, n), direction=LT
}

body {
  p = (s32[], f32[16,64]) parameter(0)
  i = s32[] get-tuple-element(p), index=0
  x = f32[16,64] get-tuple-element(p), index=1
  one = s32[] constant(1)
  i2 = s32[] add(i, one)
  ag = f32[64,64] all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  rs = f32[16,64] reduce-scatter(%ag), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=add
  cp = f32[16,64] collective-permute(%rs), source_target_pairs={{0,1},{1,0}}
  t = f32[16,64] tanh(cp)
  ROOT r = (s32[], f32[16,64]) tuple(i2, t)
}

ENTRY main {
  a = s32[] parameter(0)
  x0 = f32[16,64] parameter(1)
  t0 = (s32[], f32[16,64]) tuple(a, x0)
  ROOT w = (s32[], f32[16,64]) while(t0), condition=cond, body=body
}
"""

CRAFTED = {"hot": HOT_HLO, "cas": CAS_HLO, "unresolved": UNRESOLVED_HLO,
           "plain_dus": PLAIN_DUS_HLO, "collective": COLLECTIVE_HLO,
           "looped": LOOPED_COLLECTIVES_HLO}


def golden(name: str) -> str:
    return gzip.decompress((DATA / f"{name}.hlo.gz").read_bytes()).decode()


@pytest.fixture(scope="module")
def fresh_decode():
    """qwen3-moe decode lowered now, at every published width (the
    reference's lowering; about 3 s)."""
    return zoo.lower_config_steps("qwen3_moe_235b_a22b",
                                  steps=["decode"])["decode"]


@pytest.fixture(scope="module")
def texts(fresh_decode):
    out = {name: golden(name) for name in GOLDENS}
    out["qwen3_moe_235b_a22b__decode_fresh"] = fresh_decode
    out.update(CRAFTED)
    return out


TEXT_NAMES = GOLDENS + ("qwen3_moe_235b_a22b__decode_fresh",) \
    + tuple(CRAFTED)


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


def _cost(mc) -> dict:
    return {"flops": mc.flops, "bytes": mc.bytes,
            "collective_operand_bytes": mc.collective_operand_bytes,
            "collective_wire_bytes": mc.collective_wire_bytes,
            "unresolved_loops": mc.unresolved_loops,
            "collectives": [dataclasses.asdict(c) for c in mc.collectives]}


def assert_counter_sets_equal(got, want):
    """Every field of a port ``CounterSet`` equal to the reference's."""
    for f in dataclasses.fields(counters.CounterSet):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert np.array_equal(g, w) and g.dtype == w.dtype, f.name
        else:
            assert g == w, (f.name, g, w)


# -- the reference's own cases (tests/test_hlo_analysis.py) -------------------


def test_scan_trip_count_flops():
    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    w = jax.ShapeDtypeStruct((7, 128, 128), jnp.float32)

    def f(x, w):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, x, w)[0]

    text = jax.jit(f).lower(x, w).compile().as_text()
    mc = hlo.analyze_module(text, 1)
    expect = 2 * 128 ** 3 * 7
    assert 1.0 <= mc.flops / expect < 1.25
    assert mc.unresolved_loops == 0
    assert _cost(mc) == _cost(ref_hlo.analyze_module(text, 1))


def test_nested_scan_multiplies():
    x = jax.ShapeDtypeStruct((64, 64), jnp.float32)

    def f(x):
        def outer(h, _):
            def inner(h2, _):
                return jnp.tanh(h2 @ h2), None
            h, _ = jax.lax.scan(inner, h, None, length=3)
            return h, None
        return jax.lax.scan(outer, x, None, length=5)[0]

    text = jax.jit(f).lower(x).compile().as_text()
    mc = hlo.analyze_module(text, 1)
    expect = 2 * 64 ** 3 * 15
    assert 0.9 <= mc.flops / expect < 1.3, mc.flops / expect
    assert _cost(mc) == _cost(ref_hlo.analyze_module(text, 1))


@pytest.mark.parametrize("shape,nbytes", [
    ("f32[2,3]", 24), ("bf16[10]{0}", 20), ("(f32[2], s32[4])", 24),
    ("pred[]", 1), ("token[]", 0),
    ("(f32[8,128]{1,0}, s32[])", 8 * 128 * 4 + 4),
    ("((f32[8,128]{1,0}, s32[]), f32[4]{0})", 8 * 128 * 4 + 4 + 16),
    ("s32[<=16]", 64), ("s32[<=16]{0}", 64)])
def test_shape_bytes(shape, nbytes):
    assert hlo.shape_bytes(shape) == nbytes == ref_hlo.shape_bytes(shape)


def test_instr_re_tuple_results():
    m = hlo._INSTR_RE.match(
        "  while.1 = (f32[8,128]{1,0}, s32[]) while(tuple.0), "
        "condition=cond, body=body")
    assert m is not None
    assert m.groups() == ("while.1", "(f32[8,128]{1,0}, s32[])", "while")
    m = hlo._INSTR_RE.match(
        "  t = ((f32[8,128]{1,0}, s32[]), f32[4]{0}) tuple(a, b, c)")
    assert m is not None and m.group(3) == "tuple"
    m = hlo._INSTR_RE.match("  d = s32[<=16]{0} add(a, b)")
    assert m is not None and m.group(2) == "s32[<=16]{0}"
    assert hlo._INSTR_RE.pattern == ref_hlo._INSTR_RE.pattern


def test_parse_golden_granite_decode():
    text = golden("granite_moe_1b_a400m__decode")
    comps = hlo.parse_computations(text)
    assert len(comps) > 20
    assert hlo.find_entry(text) is not None
    assert [i for c in comps.values() for i in c
            if i.result.startswith("(")]
    assert hlo.analyze_module(text, 1).unresolved_loops == 0


def test_parse_golden_whisper_train():
    text = golden("whisper_small__train")
    comps = hlo.parse_computations(text)
    assert len(comps) > 50
    assert hlo.find_entry(text) is not None
    assert sum(len(c) for c in comps.values()) > 2000


def test_ring_wire_model():
    rw = hlo.CollectiveOp.ring_wire_bytes
    assert rw("all-gather", 100, 4) == 300
    assert rw("all-reduce", 100, 4) == 150
    assert rw("reduce-scatter", 100, 4) == 75
    assert rw("collective-permute", 100, 4) == 100
    assert rw("all-reduce", 100, 1) == 0
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "ragged-all-to-all", "collective-permute",
               "collective-broadcast", "send"):
        for k in (1, 2, 8):
            assert rw(op, 96, k) == ref_hlo.CollectiveOp.ring_wire_bytes(
                op, 96, k)


def test_collectives_detected_in_sharded_program():
    mc = hlo.analyze_module(COLLECTIVE_HLO, 8)
    assert len(mc.collectives) == 1
    op = mc.collectives[0]
    assert op.opcode == "all-reduce"
    assert op.operand_bytes == 256
    assert op.group_size == 4
    np.testing.assert_allclose(op.wire_bytes, 2 * 256 * 3 / 4)


def test_compiled_object_helpers_wait_for_their_item():
    """The reference's helpers that read a compiled XLA object
    (``test_memory_analysis_dict_tolerant``) read a captured step in the
    port, which waited for ROADMAP queue 1, "Multi-device and the zoo
    audit": the same names and keys, positive FLOPs and bytes, and
    ``flops_and_bytes`` the cost analysis's pair."""
    from repro_torch.audit import zoo as port_zoo
    cap = port_zoo.lower_config_steps("granite-moe-1b-a400m",
                                      steps=["decode"], reduced=True)["decode"]
    for name in ("cost_analysis_dict", "memory_analysis_dict",
                 "flops_and_bytes"):
        assert hasattr(ref_hlo, name) and hasattr(hlo, name)
    cost = hlo.cost_analysis_dict(cap)
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    assert hlo.flops_and_bytes(cap) == (cost["flops"],
                                        cost["bytes accessed"])
    mem = hlo.memory_analysis_dict(cap)
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"} <= set(mem)
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0


# -- the same text through both packages ---------------------------------------


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_module_walk_equals_reference(texts, name):
    text = texts[name]
    comps = hlo.parse_computations(text)
    want = ref_hlo.parse_computations(text)
    assert list(comps) == list(want)
    for c in want:
        assert [(i.name, i.result, i.opcode, i.line) for i in comps[c]] == \
            [(i.name, i.result, i.opcode, i.line) for i in want[c]]
    assert hlo.find_entry(text) == ref_hlo.find_entry(text)
    for line in text.splitlines():
        assert hlo.called_computations(line) == \
            ref_hlo.called_computations(line)
        if " while(" in line:
            cond = line.split("condition=")[1].split(",")[0].lstrip("%")
            assert hlo.resolve_trip_count(comps, line, cond) == \
                ref_hlo.resolve_trip_count(want, line, cond)
    for n in (1, 4, 8):
        assert _cost(hlo.analyze_module(text, n)) == \
            _cost(ref_hlo.analyze_module(text, n))
        got = hlo.parse_collectives(text, n)
        ref = ref_hlo.parse_collectives(text, n)
        assert [dataclasses.asdict(o) for o in got.ops] == \
            [dataclasses.asdict(o) for o in ref.ops]
        assert got.by_opcode() == ref.by_opcode()


def test_crafted_collectives_are_counted_through_the_loop():
    """A loop's collectives add their bytes once a trip; the module's op
    list holds only the entry's own (the reference's walk does the same)."""
    model = hlo.HloCostModel(LOOPED_COLLECTIVES_HLO, 4)
    body = model._cost_of("body")
    assert [c.opcode for c in body.collectives] == [
        "all-gather", "reduce-scatter", "collective-permute"]
    assert [c.group_size for c in body.collectives] == [4, 4, 4]
    mc = hlo.analyze_module(LOOPED_COLLECTIVES_HLO, 4)
    assert mc.unresolved_loops == 0 and mc.collectives == []
    assert mc.collective_wire_bytes == 6 * body.collective_wire_bytes > 0
    assert mc.collective_operand_bytes == 6 * body.collective_operand_bytes


# -- the hlo provider and the spec ---------------------------------------------


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_hlo_provider_equals_reference(texts, name):
    for n in (1, 8):
        spec = WorkloadSpec.from_compiled(hlo_text=texts[name], label=name,
                                          num_devices=n)
        ref = RefSpec.from_compiled(hlo_text=texts[name], label=name,
                                    num_devices=n)
        assert spec.fingerprint() == ref.fingerprint() is not None
        got = get_provider("hlo").collect(spec, get_device("v5e"))
        want = RefHloProvider().collect(ref, ref_get_device("v5e"))
        assert_counter_sets_equal(got, want)
        frame = HloProvider().collect_batch([spec], get_device("v5e"))
        assert counters.bitwise_equal(frame.row(0), got)


def test_hlo_provider_error_keeps_label():
    spec = WorkloadSpec.from_scatter_add(
        np.zeros(8, dtype=np.int64), np.ones(8, dtype=np.float32), 4,
        label="my-workload")
    with pytest.raises(ValueError, match="my-workload"):
        HloProvider().collect(spec, get_device("v5e"))


def test_from_compiled_fingerprint_stable_across_relowering():
    t1, t2 = (zoo.lower_config_steps("granite-moe-1b-a400m", steps=["decode"],
                                     reduced=True)["decode"]
              for _ in range(2))
    s1 = WorkloadSpec.from_compiled(hlo_text=t1, label="g/decode")
    s2 = WorkloadSpec.from_compiled(hlo_text=t2, label="relabeled")
    assert s1.fingerprint() is not None
    assert s1.fingerprint() == s2.fingerprint()
    assert s1.fingerprint() == RefSpec.from_compiled(
        hlo_text=t1, label="x").fingerprint()


def test_from_compiled_refuses_a_compiled_object():
    compiled = jax.jit(lambda x: x + 1).lower(
        jax.ShapeDtypeStruct((4,), jnp.float32)).compile()
    with pytest.raises(ValueError, match="captured step"):
        WorkloadSpec.from_compiled(compiled, label="c")


def test_hlo_specs_carry_no_wave_trace():
    """The one-source check, ``resolve_trace``'s refusal and the other
    providers' refusals say what the reference's say."""
    text = golden("granite_moe_1b_a400m__decode")
    messages = []
    for spec_cls in (WorkloadSpec, RefSpec):
        spec = spec_cls.from_compiled(hlo_text=text, label="g")
        got = []
        with pytest.raises(ValueError) as ei:
            spec_cls.from_compiled(hlo_text=text, label="g",
                                   indices=np.zeros(8))
        got.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            spec_cls.from_compiled(label="none")
        got.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            spec.resolve_trace()
        got.append(str(ei.value))
        messages.append(got)
    assert messages[0] == messages[1]
    assert "collect them with the 'hlo' provider" in messages[0][2]
    spec = WorkloadSpec.from_compiled(hlo_text=text, label="g")
    with pytest.raises(ValueError, match="compiled artifact"):
        get_provider("kernel").collect(spec, get_device("v5e"))
    with pytest.raises(ValueError, match="has no wave-trace source"):
        Session("v5e").profile(spec)


def test_geometry_transforms_skip_hlo_specs():
    text = golden("granite_moe_1b_a400m__decode")
    spec = WorkloadSpec.from_compiled(hlo_text=text, label="g")
    ref = RefSpec.from_compiled(hlo_text=text, label="g")
    for mod, s in ((transforms, spec), (ref_transforms, ref)):
        assert not mod.SetWavesPerTile(8).legal(s)
        assert not mod.SetPipelineDepth(4).legal(s)


def test_sweep_renders_hlo_meta_like_reference():
    """The ``hlo meta`` lines: unresolved loops and collectives."""
    specs = [(WorkloadSpec, "unresolved", UNRESOLVED_HLO, 1),
             (WorkloadSpec, "looped", LOOPED_COLLECTIVES_HLO, 4),
             (WorkloadSpec, "collective", COLLECTIVE_HLO, 8)]
    port = Session("v5e", provider="hlo").sweep(
        [WorkloadSpec.from_compiled(hlo_text=t, label=lab, num_devices=n)
         for _, lab, t, n in specs])
    ref = RefSession("v5e", provider="hlo").sweep(
        [RefSpec.from_compiled(hlo_text=t, label=lab, num_devices=n)
         for _, lab, t, n in specs])
    text = port.render("text")
    assert text == ref.render("text")
    assert "hlo meta [unresolved]: 1 unresolved loop trip count(s)" in text
    assert "hlo meta [collective]: 1 collective op(s)" in text
    assert_json_close(json.loads(port.render("json")),
                      json.loads(ref.render("json")))
    assert port.render("csv") == ref.render("csv")


# -- the command line ----------------------------------------------------------


def _both(argv, capsys):
    """(rc, stdout, stderr) of the reference, then the port, one argv."""
    out = []
    for fn in (ref_main, main):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.mark.parametrize("name", GOLDENS)
def test_cli_profile_workload_hlo_equals_reference(name, tmp_path, capsys):
    path = tmp_path / f"{name}.hlo"
    path.write_text(golden(name))
    for fmt in ("text", "json", "csv"):
        (rc_r, ref, _), (rc, got, _) = _both(
            ["profile", "--workload", "hlo", "--hlo-file", str(path),
             "--format", fmt], capsys)
        assert rc == rc_r == 0
        if fmt == "json":
            assert_json_close(json.loads(got), json.loads(ref))
        else:
            assert got == ref
    if name == "granite_moe_1b_a400m__decode":
        # the reference's verdict on this text
        text = _both(["profile", "--workload", "hlo", "--hlo-file",
                      str(path)], capsys)[1][1]
        assert "hbm=98.96%" in text and "-> hbm (saturated)" in text


def test_cli_sweep_workload_hlo_equals_reference(tmp_path, capsys):
    path = tmp_path / "collective.hlo"
    path.write_text(COLLECTIVE_HLO)
    for extra in ([], ["--num-devices", "8", "--label", "step"],
                  ["--provider", "hlo", "--bytes-read", "1e9"]):
        (rc_r, ref, _), (rc, got, _) = _both(
            ["sweep", "--workload", "hlo", "--hlo-file", str(path),
             "--no-artifact", "--no-cache", *extra], capsys)
        assert rc == rc_r == 0
        assert got == ref and "hlo meta [" in got


def test_cli_hlo_workload_refusals_equal_reference(tmp_path, capsys):
    path = tmp_path / "hot.hlo"
    path.write_text(HOT_HLO)
    for argv in (["profile", "--workload", "hlo"],
                 ["profile", "--workload", "hlo", "--hlo-file",
                  str(tmp_path / "missing.hlo")],
                 ["profile", "--workload", "hlo", "--hlo-file", str(path),
                  "--provider", "kernel"]):
        rc_r = ref_main(list(argv))
        ref = capsys.readouterr()
        rc = main(list(argv) + ["--torch-device", "cpu"])
        got = capsys.readouterr()
        assert rc == rc_r == 2
        assert got.err == ref.err and got.out == ref.out == ""
