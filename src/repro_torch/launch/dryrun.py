"""Multi-pod dry run: the reference's ``launch/dryrun.py`` on captured
torch steps.

For every (architecture x input shape) cell, on the single-pod 16x16
mesh and the 2x16x16 multi-pod mesh: build the step (train / prefill /
decode per shape kind), capture it on meta tensors placed on the mesh
(``launch.lowering.build_captured``: each rank's own program, one
microbatch and one layer group scaled by their trips), read its memory
and cost analyses and its collectives, and write the roofline terms to
``results/torch/dryrun/<arch>__<shape>__<mesh>.json``
(``REPRO_TORCH_RESULTS`` moves ``results/torch/``).

The mesh is built on a ``fake`` process group of 256 or 512 ranks that
this module starts itself (it moves no data), so a cell runs in one
plain process.  The roofline terms use the reference's TPU v5e constants
(``core/roofline.py``): model outputs held for comparison, not H100
times.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.core import hlo as hlo_mod
from repro_torch.core import roofline
from repro_torch.launch.lowering import build_captured, shape_tuned_config


def results_dir() -> str:
    from repro_torch.analysis.sweep_cache import results_root
    return os.path.join(str(results_root()), "dryrun")


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks (this process
    is rank 0), torn down on exit; refuses where a group is set up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: "
                           "run it where none is set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "base") -> dict:
    """One cell's record; needs a ``fake`` group of the mesh's size."""
    from repro_torch.launch.mesh import make_production_mesh, mesh_chips
    cfg0 = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg0, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "pod2" if multi_pod else "single",
                "status": "skipped", "reason": why}
    cfg, loss_chunk, train_kw = shape_tuned_config(cfg0, shape, variant)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh_chips(mesh)
    mesh_name = "pod2" if multi_pod else "single"
    tokens_per_step = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6.0 * n_active * tokens_per_step
    else:
        model_flops = 2.0 * n_active * tokens_per_step

    t0 = time.time()
    cap = build_captured(cfg, shape, mesh, loss_chunk=loss_chunk,
                         train_kw=train_kw)
    capture_s = time.time() - t0

    mem = hlo_mod.memory_analysis_dict(cap)
    cost = hlo_mod.cost_analysis_dict(cap)
    terms = roofline.from_compiled(
        cap, arch=arch, shape=shape_name, mesh_name=mesh_name,
        chips=chips, model_flops=model_flops)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips,
        "compile_seconds": round(capture_s, 1),
        "params": n_params, "active_params": n_active,
        "tokens_per_step": tokens_per_step,
        "memory_analysis": mem,
        "cost_flops": cost.get("flops"),
        "cost_bytes": cost.get("bytes accessed"),
        "roofline": terms.as_dict(),
    }


def cell_path(arch, shape_name, mesh_name, variant="base"):
    safe = arch.replace("/", "_")
    suffix = "" if variant == "base" else f"__{variant}"
    return os.path.join(results_dir(),
                        f"{safe}__{shape_name}__{mesh_name}{suffix}.json")


def run_and_save(arch, shape_name, multi_pod, force=False,
                 variant="base") -> dict:
    """One cell, cached in its JSON (only errors are retried); needs a
    ``fake`` group of the mesh's size."""
    mesh_name = "pod2" if multi_pod else "single"
    path = cell_path(arch, shape_name, mesh_name, variant)
    if not force and os.path.exists(path):
        with open(path) as f:
            cached = json.load(f)
        if cached.get("status") in ("ok", "skipped"):
            return cached  # only errors are retried
    try:
        rec = lower_cell(arch, shape_name, multi_pod, variant)
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()[-4000:]}
    os.makedirs(results_dir(), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" dominant={r['dominant']} useful={r['useful_ratio']:.2f}"
                 f" capture={rec['compile_seconds']}s")
    elif status == "error":
        extra = " " + rec["error"][:120]
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({variant}): "
          f"{status}{extra}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    args = ap.parse_args(argv)

    meshes = {"single": [False], "pod2": [True], "both": [False, True]}[
        args.mesh]
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    n_bad = 0
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch in archs:
                for shape_name in shapes:
                    rec = run_and_save(arch, shape_name, mp,
                                       force=args.force,
                                       variant=args.variant)
                    n_bad += rec["status"] == "error"
    print(f"[dryrun] done; {n_bad} errors")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
