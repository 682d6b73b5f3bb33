"""Model-zoo capture for the audit: config -> per-step captured graph.

The reference lowers each step to pre-optimization HLO under a ``(1,
1)`` mesh; the port captures it (``launch/lowering.build_captured``)
under a ``(1, 1)`` mesh on a one-rank ``fake`` process group, so that an
MoE layer takes the mesh bodies (``apply_ep`` / ``apply_sharded``) the
reference's does.  The group is the audit's own: ``lower_config_steps``
starts it where no group is set up and tears it down afterwards; where
the caller has set up a group already, the capture runs in a child
process of its own, so that nothing of the caller's group is touched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import subprocess
import sys
from typing import Optional, Sequence

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable

# step name -> production shape audited for it
AUDIT_SHAPES = {
    "train": "train_4k",
    "prefill": "prefill_32k",
    "decode": "decode_32k",
}

# ``reduced=True`` smoke geometry: keeps a capture sub-second in tests
# while preserving every scatter / cache-write idiom of the full shapes.
_REDUCED_GEOM = {"train": (4, 64), "prefill": (4, 256), "decode": (4, 256)}


def normalize_arch(name: str) -> str:
    """Accept underscore- or module-spelled config names (CLI/CI)."""
    if name in ARCHS:
        return name
    dashed = name.replace("_", "-")
    if dashed in ARCHS:
        return dashed
    for arch, module in ARCHS.items():   # e.g. zamba2_1p2b -> zamba2-1.2b
        if name == module:
            return arch
    raise KeyError(f"unknown config {name!r} (known: {', '.join(ARCHS)})")


@contextlib.contextmanager
def one_rank_group():
    """A one-rank ``fake`` process group for the capture's mesh, torn
    down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def capture_config_steps(arch: str, *, steps: Optional[Sequence[str]] = None,
                         reduced: bool = False, variant: str = "base"
                         ) -> dict:
    """Capture each requested step of a config on a ``(1, 1)`` mesh of
    the current (one-rank) group; returns step -> ``Capture``.
    Inapplicable (config, shape) cells are skipped, as in the dry run."""
    from repro_torch.launch.lowering import build_captured, shape_tuned_config
    from repro_torch.launch.mesh import compat_make_mesh
    arch = normalize_arch(arch)
    cfg0 = get_config(arch)
    if reduced:
        cfg0 = cfg0.reduced()
    mesh = compat_make_mesh((1, 1), ("data", "model"), "cpu")
    out = {}
    for step in (steps or AUDIT_SHAPES):
        shape = SHAPES[AUDIT_SHAPES[step]]
        if reduced:
            gb, sl = _REDUCED_GEOM[step]
            shape = dataclasses.replace(shape, global_batch=gb, seq_len=sl)
        ok, _why = shape_applicable(cfg0, shape)
        if not ok:
            continue
        cfg, loss_chunk, train_kw = shape_tuned_config(cfg0, shape, variant)
        out[step] = build_captured(cfg, shape, mesh, loss_chunk=loss_chunk,
                                   train_kw=train_kw, label=f"{arch}/{step}")
    return out


_CHILD = """
import pickle, sys
from repro_torch.audit import zoo
arch, steps, reduced, variant = pickle.loads(sys.stdin.buffer.read())
with zoo.one_rank_group():
    caps = zoo.capture_config_steps(arch, steps=steps, reduced=reduced,
                                    variant=variant)
sys.stdout.buffer.write(pickle.dumps(caps))
"""


def lower_config_steps(arch: str, *, steps: Optional[Sequence[str]] = None,
                       reduced: bool = False, variant: str = "base") -> dict:
    """Capture each requested step of a config: step -> ``Capture`` (its
    ``text`` the printed graph).  Starts and ends the audit's own
    one-rank group, or captures in a child process where the caller has
    a group already."""
    import torch.distributed as dist
    steps = list(steps) if steps else None
    if not dist.is_initialized():
        with one_rank_group():
            return capture_config_steps(arch, steps=steps, reduced=reduced,
                                        variant=variant)
    import os
    from pathlib import Path
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD],
                          input=pickle.dumps((arch, steps, reduced, variant)),
                          capture_output=True, env=env, check=False)
    if proc.returncode:
        raise RuntimeError(f"capturing {arch} failed:\n"
                           + proc.stderr.decode()[-4000:])
    return pickle.loads(proc.stdout)
