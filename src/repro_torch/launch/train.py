"""End-to-end training with checkpoint/restart fault tolerance.

Runs a reduced (or full) config for N steps on one device:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reduced --steps 50 --batch 8 --seq 128 \\
      --save-every 10 [--simulate-failure-at 17] [--device cpu]

The reference's ``repro/launch/train.py`` on the port: the
deterministic data pipeline (its tokens bit for bit the reference's), the
train step, async checkpoints with atomic commit (``--save-every 0``:
none), failure injection with restore-from-latest (the data stream's
replay is exact), and straggler reports from the queue-model detector.
``--device`` defaults to ``cuda``: the model trains on the card unless
the CPU is asked for.  Checkpoints go to ``--ckpt-dir``, by default
``ckpt/`` under ``results/torch/`` (``REPRO_TORCH_RESULTS`` moves it).
It raises where the loss did not fall.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.analysis.sweep_cache import results_root
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.registry import build_model, make_batch
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import stragglers
from repro_torch.train import step as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = torch.device(args.device)
    model = build_model(cfg, dev)

    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                             total_steps=args.steps)
    tcfg = train_mod.TrainConfig(accum_steps=args.accum)
    step_fn = train_mod.make_train_step(model, tcfg, ocfg)

    state = train_mod.init_state(model,
                                 torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch))
    ckpt_dir = args.ckpt_dir or str(results_root() / "ckpt")
    ckpt = store.AsyncCheckpointer(ckpt_dir)
    coord = ft.Coordinator(num_hosts=4)
    injector = None
    if args.simulate_failure_at is not None:
        injector = ft.FailureInjector({args.simulate_failure_at: 1})

    # modality stubs are deterministic per step
    def batch_for(step: int) -> dict:
        toks = torch.from_numpy(data.global_batch_at(step)).to(dev)
        b = {"tokens": toks, "labels": toks}
        if cfg.family in ("audio", "vlm"):
            stub = make_batch(cfg, args.batch, args.seq,
                              torch.Generator(device=dev).manual_seed(step))
            b.update({k: v for k, v in stub.items()
                      if k in ("frames", "image_embeds")})
        return b

    state_box = {"state": state}

    def train_one_step(step: int) -> dict:
        t0 = time.time()
        new_state, metrics = step_fn(state_box["state"], batch_for(step))
        loss = float(metrics["xent"])     # waits for the step
        state_box["state"] = new_state
        return {"xent": loss, "step_time_s": time.time() - t0}

    def save_fn(step: int) -> None:
        ckpt.submit(step, state_box["state"])

    def restore_fn() -> int:
        ckpt.wait()
        restored, step = store.restore(ckpt_dir, state_box["state"])
        state_box["state"] = restored
        print(f"[train] restored from checkpoint at step {step}")
        return step

    try:
        out = ft.run_with_restarts(
            num_steps=args.steps, train_one_step=train_one_step,
            save_every=args.save_every or args.steps + 1, save_fn=save_fn,
            restore_fn=restore_fn, coordinator=coord, injector=injector)
    finally:
        ckpt.close()

    hist = out["history"]
    first, last = hist[0]["xent"], hist[-1]["xent"]
    print(f"[train] {args.arch} on {dev}: steps={len(hist)} "
          f"restarts={out['restarts']} loss {first:.3f} -> {last:.3f}")
    reports = stragglers.detect(
        {h.host_id: h.step_times for h in coord.hosts.values()})
    for r in reports:
        flag = " STRAGGLER" if r.is_straggler else ""
        print(f"[train] host {r.host_id}: mean {r.mean_step_s:.3f}s "
              f"barrier-U {r.barrier_utilization:.2f}{flag}")
    if not (np.isfinite(last) and last < first):
        raise SystemExit("loss did not improve")
    return out


if __name__ == "__main__":
    main()
