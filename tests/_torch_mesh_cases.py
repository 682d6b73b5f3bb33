"""The port's mesh cases, each run on gloo ranks of the CPU.

    python tests/_torch_mesh_cases.py WORLD WORKDIR

spawns WORLD processes that join one gloo group through a ``file://``
store under WORKDIR, run the case that WORKDIR/in.pkl names on their
meshes with the inputs it holds (the reference's parameters and data,
as numpy), and write rank 0's results, as numpy, to WORKDIR/out.pkl.  The tests of
``tests/test_torch_distributed.py`` write the inputs, run this script in
a subprocess with a timeout, and hold the results against the
reference's.  Each rank uses one thread.
"""

from __future__ import annotations

import os
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = Path(__file__).resolve().parents[1] / "src"


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to(torch.float32 if t.is_floating_point() else t.dtype
                         ).cpu().numpy()


def _grads(fn, leaves):
    live = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        out = fn(live)
        return torch.autograd.grad(out, live)


def case_moe(inp, mesh_shape, axes, data_axes, path):
    """``apply_ep`` or ``apply_sharded`` of the reference's layer on the
    mesh, at each capacity factor of the inputs: out, aux, the dispatch
    ids, and the gradients of ``sum(out * cot) + aux`` with respect to
    each parameter and x."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.parallel import ctx as pctx
    mesh = mesh_mod.compat_make_mesh(mesh_shape, axes, "cpu")
    p = tree.map(torch.from_numpy, inp["params"])
    x = torch.from_numpy(inp["x"])
    cot = torch.from_numpy(inp["cot"])
    res = {}
    for cf in inp["capacity_factors"]:
        cfg = dataclasses.replace(moe.MoEConfig(**inp["cfg"]),
                                  capacity_factor=cf)

        def apply(p, x):
            if path == "ep":
                return moe.apply_ep(p, x, cfg, mesh, data_axes=data_axes)
            return moe.apply_sharded(p, x, cfg, mesh, data_axes=data_axes)

        flat = tree.leaves(p) + [x]

        def loss(live):
            o, a, _ = apply(tree.unflatten(p, live[:-1]), live[-1])
            return (o * cot).sum() + a

        with pctx.use_mesh(mesh, data_axes=data_axes):
            out, aux, disp = apply(p, x)
            g = _grads(loss, flat)
        res[cf] = {"out": _np(out), "aux": _np(aux), "disp": _np(disp),
                   "grads": tree.unflatten(p, [_np(t) for t in g[:-1]]),
                   "grad_x": _np(g[-1])}
    return res


def _lm(inp):
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config(inp["arch"]).reduced(),
                              **inp.get("changes", {}))
    model = build_model(cfg, "cpu")
    carry = (convert.whisper_params_from_numpy if cfg.family == "audio"
             else convert.lm_params_from_numpy)
    params = carry(inp["params"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    return cfg, model, params, batch


def _on_mesh(cfg, params, batch, mesh, data_axes):
    from repro_torch import convert
    from repro_torch.parallel import sharding as shd
    ps = convert.params_on_mesh(params, cfg, mesh)
    bs = shd.distribute(batch, shd.shardings_of(
        shd.batch_pspecs(batch, data_axes), mesh))
    return ps, bs


def case_loss(inp, mesh_shape, axes, data_axes, grads=True):
    """The loss and xent of the batch, unsharded and on the mesh, and
    each parameter's gradient on the mesh."""
    from repro_torch import tree
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import ctx as pctx
    cfg, model, params, batch = _lm(inp)
    loss0, m0 = model.loss(params, batch)
    mesh = mesh_mod.compat_make_mesh(mesh_shape, axes, "cpu")
    ps, bs = _on_mesh(cfg, params, batch, mesh, data_axes)
    with pctx.use_mesh(mesh, data_axes=data_axes, tp_axis="model"):
        loss1, m1 = model.loss(ps, bs)
        out = {"loss": _np(loss0), "xent": _np(m0["xent"]),
               "mesh_loss": _np(loss1), "mesh_xent": _np(m1["xent"])}
        if grads:
            g = _grads(lambda live: model.loss(tree.unflatten(ps, live),
                                               bs)[0], tree.leaves(ps))
            out["mesh_grads"] = tree.unflatten(params, [_np(t) for t in g])
    return out


def case_zoo(inp, mesh_shape, axes, data_axes):
    """``case_loss``'s losses (no gradients) for each model of
    ``inp["models"]``, by name."""
    return {m["name"]: {k: v for k, v in case_loss(
        m, mesh_shape, axes, data_axes, grads=False).items()}
        for m in inp["models"]}


DECODE_B, DECODE_STEPS, DECODE_LEN = 4, 4, 8


def _decode_run(model, params, toks, extras, mesh=None, data_axes=()):
    """The prefill's logits over ``toks``, then the logits of
    ``DECODE_STEPS`` decode steps from an empty cache of ``DECODE_LEN``
    slots, teacher-forced with ``toks``; on ``mesh``, with the cache laid
    out by ``cache_pspecs``."""
    from repro_torch.parallel import sharding as shd
    logits, _ = model.forward(params, toks, **extras)
    out = {"prefill": _np(logits)}
    cache = model.init_cache(params, toks.shape[0], DECODE_LEN, **extras)
    if mesh is not None:
        cache = shd.distribute(cache, shd.shardings_of(shd.cache_pspecs(
            cache, model.cfg, data_axes=data_axes, seq_axis="model"), mesh))
    for i in range(DECODE_STEPS):
        step_logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                               cache, pos=i)
        out[f"step{i}"] = _np(step_logits)
    return out


def case_decode(inp, mesh_shape, axes, data_axes):
    """For each model of ``inp["models"]``: a prefill, then decode steps
    against a cache, unsharded and on the mesh (``_decode_run``)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import ctx as pctx
    mesh = mesh_mod.compat_make_mesh(mesh_shape, axes, "cpu")
    res = {}
    for m in inp["models"]:
        cfg, model, params, batch = _lm(m)
        toks = batch["tokens"][:DECODE_B, :DECODE_STEPS].contiguous()
        extras = {k: v[:DECODE_B] for k, v in batch.items()
                  if k not in ("tokens", "labels")}
        with torch.no_grad():
            want = _decode_run(model, params, toks, extras)
            ps, bs = _on_mesh(cfg, params, dict(extras, tokens=toks), mesh,
                              data_axes)
            with pctx.use_mesh(mesh, data_axes=data_axes, tp_axis="model"):
                got = _decode_run(model, ps, bs.pop("tokens"), bs, mesh,
                                  data_axes)
        res[m["name"]] = {"want": want, "got": got}
    return res


def case_train_step(inp, mesh_shape, axes, data_axes):
    """One train step with ``accum_steps`` and ``constrain_grad_sharding``
    on the mesh, and the same step unsharded: the new parameters, the
    new AdamW state and the metrics of each; the placements of the new
    state against the old."""
    from repro_torch import tree
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as train_mod
    cfg, model, params, batch = _lm(inp)
    ocfg = adamw.AdamWConfig(**inp["ocfg"])
    tcfg = train_mod.TrainConfig(accum_steps=inp["accum"],
                                 constrain_grad_sharding=True)
    step = train_mod.make_train_step(model, tcfg, ocfg)

    def state_of(p):
        return {"params": p, "opt": adamw.init(p),
                "step": torch.zeros((), dtype=torch.int32)}

    s0, met0 = step(state_of(tree.map(lambda t: t.clone(), params)), batch)
    mesh = mesh_mod.compat_make_mesh(mesh_shape, axes, "cpu")
    ps, bs = _on_mesh(cfg, params, batch, mesh, data_axes)
    with pctx.use_mesh(mesh, data_axes=data_axes, tp_axis="model"):
        state = state_of(ps)
        before = [tuple(t.placements) for t in tree.leaves(state["opt"])
                  if hasattr(t, "placements")]
        s1, met1 = step(state, bs)
        after = [tuple(t.placements) for t in tree.leaves(s1["opt"])
                 if hasattr(t, "placements")]
        specs = shd.param_pspecs(params, cfg)
        want = [shd.to_placements(s, mesh) for s in tree.leaves(specs)]
        got = [tuple(t.placements) for t in tree.leaves(s1["params"])]
    return {"before": tree.map(_np, params),
            "params": tree.map(_np, s0["params"]),
            "mesh_params": tree.map(_np, s1["params"]),
            "opt": tree.map(_np, s0["opt"]),
            "mesh_opt": tree.map(_np, s1["opt"]),
            "metrics": {k: _np(v) for k, v in met0.items()},
            "mesh_metrics": {k: _np(v) for k, v in met1.items()},
            "placements_kept": before == after and got == want,
            "n_opt_dtensors": len(after)}


def case_checkpoint(inp, workdir):
    """A train state saved from a (2, 4) mesh and restored onto a (4, 2)
    and a (1, 8) mesh: each restored leaf's full tensor and placements."""
    from repro_torch import tree
    from repro_torch.checkpoint import store
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    cfg, model, params, _ = _lm(inp)
    axes = ("data", "model")
    src = mesh_mod.compat_make_mesh((2, 4), axes, "cpu")
    ps = shd.distribute(params, shd.param_shardings(params, cfg, src))
    state = {"params": ps, "opt": adamw.init(ps),
             "step": torch.full((), 7, dtype=torch.int32)}
    with torch.no_grad():
        for leaf in tree.leaves(state["opt"]["m"]):
            leaf.add_(0.25)
    ckpt = os.path.join(workdir, "ckpt")
    store.save(ckpt, 7, state)
    out = {"saved": tree.map(_np, state)}
    for shape in ((4, 2), (1, 8)):
        mesh = mesh_mod.compat_make_mesh(shape, axes, "cpu")
        pspecs = shd.param_pspecs(params, cfg)
        specs = {"params": pspecs,
                 "opt": shd.opt_state_pspecs(state["opt"], pspecs),
                 "step": shd.P()}
        sh = shd.shardings_of(specs, mesh)
        restored, step = store.restore(ckpt, state, shardings=sh)
        ok = all(tuple(t.placements) == s.placements for t, s in
                 zip(tree.leaves(restored), tree.leaves(sh)))
        out[shape] = {"state": tree.map(_np, restored), "step": step,
                      "placements": ok}
    return out


def _worker(rank, world, workdir):
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world)
    try:
        with open(os.path.join(workdir, "in.pkl"), "rb") as f:
            inp = pickle.load(f)
        kind = inp["case"]
        if kind == "moe":
            res = case_moe(inp, inp["mesh"], inp["axes"], inp["data_axes"],
                           inp["path"])
        elif kind == "loss":
            res = case_loss(inp, inp["mesh"], inp["axes"], inp["data_axes"])
        elif kind == "zoo":
            res = case_zoo(inp, inp["mesh"], inp["axes"], inp["data_axes"])
        elif kind == "decode":
            res = case_decode(inp, inp["mesh"], inp["axes"],
                              inp["data_axes"])
        elif kind == "train_step":
            res = case_train_step(inp, inp["mesh"], inp["axes"],
                                  inp["data_axes"])
        elif kind == "checkpoint":
            res = case_checkpoint(inp, workdir)
        else:
            raise ValueError(kind)
        if rank == 0:
            with open(os.path.join(workdir, "out.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    world, workdir = int(argv[0]), argv[1]
    mp.spawn(_worker, args=(world, workdir), nprocs=world)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
