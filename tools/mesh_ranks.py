"""The port's mesh paths across real ranks: one rank a card of one host.

    python3 tools/mesh_ranks.py [--ranks 4] [--out PATH]
    python3 tools/mesh_ranks.py --device cpu      # gloo, reduced widths

``chip_smoke.py``'s mesh phase runs the mesh bodies over one rank, where
every collective is a copy; this script runs them over ``--ranks`` ranks
(4: NCCL over the cards' links, a ``tcp://localhost`` rendezvous on a
free port), the same checks at every published width:

  1. qwen3-moe-235b-a22b's MoE layer through ``moe.apply_ep`` on a
     (1, 2, 2) ("pod", "data", "model") mesh (64 experts a rank, the
     expert hidden split in two): at capacity 8.0 on
     ``chip_smoke.MESH_NODROP_B`` x ``MESH_NODROP_T`` tokens, where
     nothing drops, against ``apply_local`` of the same tokens on one
     card (max and mean |err|: the TP sum adds bf16 parts, as the
     reference's ``psum`` does, so the error scales with the parts, not
     with the sum); at 1.25 on
     ``PREFILL_B`` x ``PREFILL_T`` tokens both drop shares;
  2. granite-moe-1b-a400m's layer through ``moe.apply_sharded`` on a
     (2, 2) ("data", "model") mesh, the same two ways;
  3. granite whole at capacity 8.0: the loss of ``TRAIN_B`` x
     ``TRAIN_T`` tokens (the training phase's step 0) with its
     parameters as DTensors on the (2, 2) mesh, against the unmeshed
     loss on one card.  Where rows drop the two differ by design: each
     data shard reckons its experts' capacity from its own tokens, as in
     the reference.

Each call is timed on rank 0 by CUDA events (median of ``--reps``, after
a warm-up and a barrier), beside ``apply_local`` on one card; K5's, K7's
and K8's launches are counted on each rank.  The weights and tokens are
drawn from seed 0 on every rank alike.  With ``--device cpu`` the ranks
join a gloo group and run the reduced configs (a rehearsal: no time is a
device time).  Rank 0 prints one JSON object, also written to ``--out``
(default ``results/torch/mesh_ranks.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _time_ms(fn, dev: str, reps: int) -> float:
    """Median ms of ``fn()`` over ``reps`` calls after a warm-up; every
    rank calls it, rank 0's clock is read (CUDA events on the card)."""
    import torch
    import torch.distributed as dist
    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        if dev == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _config(arch: str, dev: str):
    import chip_smoke as cs
    cfg = cs._serve_config(arch=arch)
    if dev == "cpu":
        cfg = dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                  moe_capacity_factor=1.25)
    return cfg


def _launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.scatter_add import kernel as sk
    return {**sk.LAUNCHES, **fk.LAUNCHES}


def moe_layer(dev, mesh, arch: str, path: str, sizes, reps: int) -> dict:
    """The layer through ``apply_ep`` or ``apply_sharded`` on ``mesh``
    against ``apply_local`` of the same tokens on this rank's card."""
    import torch

    import chip_smoke as cs
    from repro_torch.models import moe, transformer
    from repro_torch.parallel import ctx as pctx

    cfg = _config(arch, dev)
    base = transformer._moe_cfg(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init(gen, base)
    d, e, k = base.d_model, base.num_experts, base.top_k
    (b_big, t_big), (b_small, t_small) = sizes
    x = (torch.randn((b_big * t_big, d), generator=gen, device=dev)
         + cs.MESH_SHARED_SCALE * torch.randn((1, d), generator=gen,
                                              device=dev)).to(torch.bfloat16)
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    cfs = (8.0, base.capacity_factor)
    out = {}
    for cf in cfs:
        mcfg = dataclasses.replace(base, capacity_factor=cf)
        b, t = (b_small, t_small) if cf > 2 else (b_big, t_big)
        xs = x[:b * t]
        tk = b * t * k

        def meshed():
            with pctx.use_mesh(mesh, data_axes=data_axes, tp_axis="model"):
                if path == "ep":
                    return moe.apply_ep(p, xs.view(b, t, d), mcfg, mesh,
                                        data_axes=data_axes, tp_axis="model",
                                        ep_axis=data_axes[-1])
                return moe.apply_sharded(p, xs.view(b, t, d), mcfg, mesh,
                                         data_axes=data_axes,
                                         tp_axis="model")

        with torch.no_grad(), cs.recording_counts() as local_rec:
            want, _, _ = moe.apply_local(p, xs, mcfg)
        before = _launches()
        with torch.no_grad(), cs.recording_counts() as mesh_rec:
            got, _, _ = meshed()
            got = got.full_tensor().reshape(b * t, d)
        launches = {n: v - before[n] for n, v in _launches().items()
                    if v != before[n]}
        cs._k7_bit_equal(local_rec, f"{arch} apply_local cf {cf}")
        cs._k7_bit_equal(mesh_rec, f"{arch} {path} cf {cf}")
        capacity = max(1, int(tk / e * cf))
        row = {"tokens": b * t, "launches_rank0": launches,
               "drop_share_local": cs._dropped(local_rec[0][1], capacity) / tk}
        # this rank's own dispatch: its tokens' rows over the EP shards,
        # then its local experts' rows (EP); or its tokens' rows (TP)
        rows_local = mesh_rec[0][0].numel()
        if path == "ep":
            shards = mesh.size(mesh.mesh_dim_names.index(data_axes[-1]))
            cap = max(1, int(rows_local / shards * cf))
            cap2 = max(1, int(shards * cap / (e // shards) * cf))
            row["drop_share_mesh_rank0"] = (
                cs._dropped(mesh_rec[0][1], cap)
                + cs._dropped(mesh_rec[1][1], cap2)) / rows_local
        else:
            row["drop_share_mesh_rank0"] = cs._dropped(
                mesh_rec[0][1], max(1, int(rows_local / e * cf))) / rows_local
        if cf > 2:   # nothing drops on either route
            diff = (got.float() - want.float()).abs()
            row.update(max_abs_err=float(diff.max()),
                       mean_abs_err=float(diff.mean()),
                       mean_abs_want=float(want.float().abs().mean()))
        with torch.no_grad():
            row["ms"] = _time_ms(meshed, dev, reps)
            row["local_ms"] = _time_ms(lambda: moe.apply_local(p, xs, mcfg),
                                       dev, reps)
        out[cf] = row
        del want, got, local_rec, mesh_rec
    return out


def whole_loss(dev, mesh, reps: int) -> dict:
    """granite whole at capacity 8.0 (nothing drops): the loss of the
    training phase's step-0 tokens on ``mesh`` against the same on one
    card, both on K5."""
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as shd

    cfg = dataclasses.replace(_config(cs.TRAIN_ARCH, dev),
                              moe_capacity_factor=8.0)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    b, t = (cs.TRAIN_B, cs.TRAIN_T) if dev == "cuda" else (8, 64)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=t,
                                  global_batch=b))
    toks = torch.from_numpy(data.global_batch_at(0)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        want = float(model.loss(params, batch)[1]["xent"])
    ps = shd.distribute(params, shd.param_shardings(params, cfg, mesh))
    bs = shd.distribute(batch, shd.shardings_of(
        shd.batch_pspecs(batch, ("data",)), mesh))

    def meshed():
        with torch.no_grad(), pctx.use_mesh(mesh, data_axes=("data",),
                                            tp_axis="model"):
            return model.loss(ps, bs)[1]["xent"].full_tensor()

    before = _launches()
    got = float(meshed())
    launches = {n: v - before[n] for n, v in _launches().items()
                if v != before[n]}
    out = {"tokens": b * t, "xent": got, "xent_one_card": want,
           "gap": abs(got - want), "launches_rank0": launches}
    out["ms"] = _time_ms(meshed, dev, reps)
    with torch.no_grad():
        out["one_card_ms"] = _time_ms(lambda: model.loss(params, batch),
                                      dev, reps)
    return out


def _rank(rank: int, world: int, dev: str, port: int, reps: int,
          out_path: str) -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod

    if dev == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        if dev == "cuda" and rank == 0:
            _build.build_all()
        dist.barrier()
        half = world // 2
        ep = mesh_mod.compat_make_mesh((1, half, 2), ("pod", "data", "model"),
                                       dev)
        tp = mesh_mod.compat_make_mesh((half, 2), ("data", "model"), dev)
        sizes = (((cs.PREFILL_B, cs.PREFILL_T),
                  (cs.MESH_NODROP_B, cs.MESH_NODROP_T)) if dev == "cuda"
                 else ((4, 64), (4, 32)))
        res = {"ranks": world, "backend": backend,
               "qwen3-moe apply_ep": moe_layer(
                   dev, ep, "qwen3-moe-235b-a22b", "ep", sizes, reps),
               "granite-moe apply_sharded": moe_layer(
                   dev, tp, "granite-moe-1b-a400m", "sharded", sizes, reps),
               "granite-moe loss": whole_loss(dev, tp, reps)}
        cards = [None] * world
        dist.all_gather_object(
            cards, torch.cuda.get_device_name(rank) if dev == "cuda"
            else "cpu")
        if rank == 0:
            res["devices"] = cards
            if dev == "cuda":
                res["card"] = cs.card_line()
            text = json.dumps(res, default=str)
            Path(out_path).parent.mkdir(parents=True, exist_ok=True)
            Path(out_path).write_text(text)
            print(text, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "results" / "torch"
                                         / "mesh_ranks.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"mesh_ranks: {args.ranks} ranks need as many cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.ranks % 2 or args.ranks < 4:
        print("mesh_ranks: --ranks must be an even number, 4 or more",
              file=sys.stderr)
        return 2
    mp.spawn(_rank, args=(args.ranks, args.device, _free_port(), args.reps,
                          args.out), nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
