"""Serving driver: batched prefill + autoregressive decode on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
      --reduced --batch 4 --prompt-len 16 --gen 16 [--device cpu]

Every architecture of ``repro_torch.configs``: the dense and the MoE
ones (``qwen3-moe-235b-a22b``, ``granite-moe-1b-a400m``: each MoE layer
counts its dispatch with K7 and sums its combine with K5),
``gemma2-27b``, ``llama-3.2-vision-11b`` (its image stub passed
through), ``whisper-small`` (its frame stub passed through), and the
two with O(1) state a token: ``rwkv6-7b`` (attention-free) and
``zamba2-1.2b`` (Mamba-2 layers with one shared attention block after
every 6).  ``--device`` defaults to ``cuda``: the model runs on the card
unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model, make_batch
from repro_torch.serve import step as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    stub = make_batch(cfg, args.batch, args.prompt_len, device=args.device)
    prompt = stub["tokens"]
    extras = {k: v for k, v in stub.items()
              if k in ("frames", "image_embeds")}
    scfg = serve_mod.ServeConfig(temperature=args.temperature,
                                 max_len=args.prompt_len + args.gen)
    t0 = time.perf_counter()
    out = serve_mod.generate(
        model, params, prompt, args.gen, scfg, extras=extras,
        gen=torch.Generator(device=args.device).manual_seed(1))
    dt = time.perf_counter() - t0
    total_new = args.batch * args.gen
    print(f"[serve] {args.arch} on {args.device}: generated "
          f"{tuple(out.shape)} in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. prompt replay)")
    if out.shape != (args.batch, args.prompt_len + args.gen) or not bool(
            ((out >= 0) & (out < cfg.padded_vocab)).all()):
        raise RuntimeError(f"generate returned {tuple(out.shape)} tokens "
                           f"outside [0, {cfg.padded_vocab})")
    return out


if __name__ == "__main__":
    main()
