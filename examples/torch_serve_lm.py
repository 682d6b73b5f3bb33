"""Serving example on the PyTorch/H100 port: batched generation with an
attention-free (O(1)-state) model and a windowed hybrid, the two
long_500k-capable families.

rwkv6-7b and zamba2-1.2b, reduced, each at batch 4 with 12 prompt tokens
and 20 generated, through ``repro_torch.launch.serve`` on
``--torch-device`` (default ``cuda``; ``cpu`` runs there).  The
reference example is ``examples/serve_lm.py``.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--torch-device cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve as serve_cli  # noqa: E402

ARCHS = ("rwkv6-7b", "zamba2-1.2b")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        serve_cli.main(["--arch", arch, "--reduced", "--batch", "4",
                        "--prompt-len", "12", "--gen", "20",
                        "--device", args.torch_device])


if __name__ == "__main__":
    main()
