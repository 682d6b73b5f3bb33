"""The port's dry run: captured steps on a ``fake`` process group.

``launch.lowering.build_captured`` captures a step on meta tensors placed
on a mesh; ``core.hlo``'s cost and memory helpers, ``core.roofline`` and
``core.profiler.profile_compiled_step`` read the capture as the
reference's read a compiled XLA object.  A ``fake`` group of 8, 256 or
512 ranks moves no data, so each case below runs in a subprocess of one
rank with its own group (as ``tests/test_torch_sharding.py`` does), each
with a time limit of its own.

The small mesh: granite-moe-1b-a400m reduced in bf16 on a (4, 2) mesh, 2
microbatches of 4 x 32 tokens (the reference's
``test_small_mesh_dryrun_lower_compile``).  Its matmul FLOPs equal an
analytic count from the config and the mesh to 1e-6 relative; the ratio
to the reference's ``cost_analysis`` FLOPs of the same step (which also
count elementwise work, after fusion) is printed, not gated.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT = 300


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env.update(extra)
    return env


def _run(code: str, **env) -> dict:
    """``code`` in a fresh process; it prints one JSON line last."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=_env(**env))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


FAKE = """
import json, dataclasses, warnings
warnings.filterwarnings("ignore")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
"""

SMALL_MESH = FAKE.replace("WORLD", "8") + """
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import hlo, roofline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.lowering import build_captured
cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                          dtype="bfloat16")
mesh = mesh_mod.compat_make_mesh((4, 2), ("data", "model"), "cpu")
shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8, seq_len=32)
cap = build_captured(cfg, shape, mesh)
terms = roofline.from_compiled(cap, arch="granite-reduced", shape="tiny",
                               mesh_name="4x2", chips=8, model_flops=1e9)
mm = sum(n.flops * n.trips for n in cap.nodes
         if n.op in ("aten.mm", "aten.bmm", "aten.addmm"))
print(json.dumps({"hlo_flops": terms.hlo_flops, "compute_s": terms.compute_s,
                  "dominant": terms.dominant, "matmul_flops": mm,
                  "accum": cap.meta["accum"], "trips": cap.meta["trips"],
                  "collectives": terms.collective_counts,
                  "chips": terms.chips,
                  "multiplier": roofline.probe_cost_normalization()}))
dist.destroy_process_group()
"""

REF_SMALL_MESH = """
import json, dataclasses
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import hlo
from repro.launch import specs as specs_mod, mesh as mesh_mod
from repro.models.registry import build_model
from repro.optim import adamw
from repro.parallel import ctx as pctx
from repro.train import step as train_mod
cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                          dtype="bfloat16")
model = build_model(cfg)
mesh = mesh_mod.compat_make_mesh((4, 2), ("data", "model"))
with pctx.use_mesh(mesh, data_axes=("data",), tp_axis="model"):
    step = train_mod.make_train_step(
        model, train_mod.TrainConfig(accum_steps=2), adamw.AdamWConfig())
    state_sds, state_sh = specs_mod.state_specs(model, mesh)
    batch = {k: jax.ShapeDtypeStruct((8, 32), jnp.int32,
                                     sharding=NamedSharding(mesh, P(("data",))))
             for k in ("tokens", "labels")}
    compiled = jax.jit(step, in_shardings=(state_sh, jax.tree.map(
        lambda s: s.sharding, batch)), donate_argnums=(0,)).lower(
            state_sds, batch).compile()
flops, _ = hlo.flops_and_bytes(compiled)
print(json.dumps({"cost_flops": flops}))
"""


def analytic_matmul_flops(cfg, *, rows=8, seq=32, accum=2, data=4,
                          model=2) -> float:
    """The (4, 2) step's matmul FLOPs, summed over its 8 ranks, from the
    config and the mesh.

    Each rank takes t = rows / accum / data sequences of ``seq`` tokens a
    microbatch, its heads and the expert hidden split over the model
    axis.  A layer's forward runs twice (remat) and its backward once,
    each product's backward two products of its size; the expert buffers
    hold the capacity of the rank's own tokens; the router's product is
    the same on both model ranks; the output projection's backward runs
    on the whole (heads x head_dim, d) weight on each model rank (DTensor
    gathers the row-sharded product's input for it).  The tied unembed
    splits the vocabulary over the model axis and d over the data axis,
    on every row of the microbatch.
    """
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    e, k, f = cfg.num_experts, cfg.top_k, cfg.d_expert
    t = rows // accum // data * seq
    cap = max(1, int(t * k / e * cfg.moe_capacity_factor))
    qkv = 3 * 2 * t * d * (h * hd // model)
    attn = 2 * 2 * (h // model) * t * t * hd
    out = 2 * t * (h * hd // model) * d
    router = 2 * t * d * e
    experts = 3 * 2 * e * cap * d * (f // model)
    fwd = qkv + attn + out + router + experts
    bwd = 2 * (qkv + attn + router + experts) + 2 * (2 * t * h * hd * d)
    layer = 2 * fwd + bwd
    pos = rows // accum * (seq - 1)
    head = 3 * 2 * pos * (d // data) * (cfg.padded_vocab // model)
    per_rank = accum * (cfg.num_layers * layer + head)
    return float(per_rank * data * model)


def test_small_mesh_dryrun_capture(tmp_path):
    """granite reduced, bf16, (4, 2), accum 2 on a ``fake`` group of 8:
    positive FLOPs and compute time, a dominant term, and matmul FLOPs
    equal to ``analytic_matmul_flops``; the ratio to the reference's
    ``cost_analysis`` FLOPs is printed."""
    import dataclasses

    from repro_torch.configs import get_config
    got = _run(SMALL_MESH)
    assert got["hlo_flops"] > 0 and got["compute_s"] > 0
    assert got["dominant"] in ("compute", "memory", "collective")
    assert got["accum"] == 2 and got["trips"] == {"layers": 4}
    assert got["multiplier"] == 1.0
    assert got["collectives"]
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              dtype="bfloat16")
    want = analytic_matmul_flops(cfg)
    whole = got["matmul_flops"] * got["chips"]
    assert abs(whole - want) <= 1e-6 * want, (whole, want)
    ref = _run(REF_SMALL_MESH, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    print(f"port hlo_flops {got['hlo_flops']:.6g}, matmul {whole:.6g}; "
          f"reference cost_analysis {ref['cost_flops']:.6g}; ratio "
          f"{got['hlo_flops'] / ref['cost_flops']:.4f}")


PROBE = FAKE.replace("WORLD", "8") + """
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.core import roofline
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("x",))
x = distribute_tensor(torch.empty((64, 32), device="meta"), mesh, [Replicate()])
w = distribute_tensor(torch.empty((32, 256), device="meta"), mesh, [Shard(1)])
with FlopCounterMode(display=False) as fc:
    x @ w
print(json.dumps({"multiplier": roofline.probe_cost_normalization(),
                  "flop_counter": fc.get_total_flops(),
                  "whole": 2 * 64 * 32 * 256}))
dist.destroy_process_group()
"""


def test_probe_cost_normalization():
    """On a ``fake`` group of 8 the capture counts each rank's own
    product (multiplier 1, as the reference finds XLA's per-partition
    cost analysis), where ``FlopCounterMode`` alone, which sees the
    DTensor operation before DTensor splits it, counts the whole
    program's; with no group the probe is 1 without a measurement."""
    from repro_torch.core import roofline
    got = _run(PROBE)
    assert got["multiplier"] == 1.0
    assert got["flop_counter"] == got["whole"]
    roofline.probe_cost_normalization.cache_clear()
    assert roofline.probe_cost_normalization() == 1.0


def test_production_cell_writes_the_reference_fields(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the cheapest production
    cell (granite-moe-1b-a400m x train_4k x single, a ``fake`` group of
    256) writes the reference's fields and roofline terms."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-1b-a400m", "--shape", "train_4k", "--mesh", "single"],
        capture_output=True, text=True, timeout=60,
        env=_env(REPRO_TORCH_RESULTS=str(tmp_path)))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    path = tmp_path / "dryrun" / \
        "granite-moe-1b-a400m__train_4k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    for key in ("arch", "shape", "mesh", "compile_seconds", "params",
                "active_params", "tokens_per_step", "memory_analysis",
                "cost_flops", "cost_bytes", "roofline"):
        assert key in rec, key
    terms = rec["roofline"]
    for key in ("hlo_flops", "hlo_bytes", "collective_operand_bytes",
                "collective_wire_bytes", "compute_s", "memory_s",
                "collective_s", "model_flops", "bytes_per_device",
                "collective_counts", "dominant", "useful_ratio",
                "roofline_fraction", "collective_wire_s",
                "step_lower_bound_s"):
        assert key in terms, key
    assert terms["hlo_flops"] > 0 and terms["collective_counts"]
    assert rec["tokens_per_step"] == 256 * 4096
    assert "[dryrun] granite-moe-1b-a400m x train_4k x single" in r.stdout


def test_profile_compiled_step():
    """The three static units of a captured step, each its cost over
    the chip's rate in cycles, the window the largest."""
    from repro_torch.audit import zoo
    from repro_torch.core import hlo, profiler, timing
    cap = zoo.lower_config_steps("granite-moe-1b-a400m", steps=["decode"],
                                 reduced=True)["decode"]
    prof = profiler.profile_compiled_step(cap, label="g", chips=1)
    chip = timing.V5E
    flops, nbytes = hlo.flops_and_bytes(cap)
    assert [u.name for u in prof.units] == ["mxu", "hbm", "ici"]
    mxu = prof.unit("mxu")
    assert mxu.busy_cycles == pytest.approx(
        flops / (chip.peak_bf16_flops / chip.clock_hz), rel=1e-12)
    assert prof.unit("hbm").busy_cycles == pytest.approx(
        nbytes / (chip.hbm_bw / chip.clock_hz), rel=1e-12)
    assert prof.unit("ici").busy_cycles == 0.0
    window = max(u.busy_cycles for u in prof.units)
    assert mxu.window_cycles == window and prof.T_cycles[0] == window
