"""End-to-end training example on the PyTorch/H100 port: trains a
reduced MoE LM for a few hundred steps with checkpoints, an injected
failure at the halfway step with a restore, and straggler reports.

``repro_torch.launch.train`` on ``--torch-device`` (default ``cuda``;
``cpu`` runs there), with the reference example's settings (batch 8,
seq 128, lr 3e-3, a checkpoint every 25 steps).  The checkpoints go to a
temporary directory, removed at the end.  The reference example is
``examples/train_lm.py``.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
         [--torch-device cpu]
"""

import argparse
import os
import sys
import tempfile
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train as train_cli  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as ckpt:
        out = train_cli.main([
            "--arch", args.arch, "--reduced",
            "--steps", str(args.steps), "--batch", "8", "--seq", "128",
            "--lr", "3e-3", "--ckpt-dir", ckpt, "--save-every", "25",
            "--simulate-failure-at", str(args.steps // 2),
            "--device", args.torch_device,
        ])
    hist = out["history"]
    print(f"final loss {hist[-1]['xent']:.3f} after {len(hist)} executed "
          f"steps with {out['restarts']} restart(s)")
    return out


if __name__ == "__main__":
    main()
