"""Train granite-moe-1b-a400m as ``chip_smoke.py``'s training phase does,
several times in one process, to find where the xent of two runs from the
same seed parts, and whether K5's atomic order is what parts them.

    python3 tools/train_repeat.py [--out PATH] [--steps N]

on a machine with an NVIDIA GPU and ``nvcc``.  Builds the kernels of this
checkout, then runs ``repro_torch.launch.train.main`` on the card at every
published width (24 layers, bf16 parameters with an f32 master), batch
``chip_smoke.TRAIN_B`` x seq ``chip_smoke.TRAIN_T``, no checkpoints, in
three modes, each twice, interleaved:

  * ``k5``: the MoE combine is K5 under autograd, as the phase runs it;
  * ``k5 det``: the same under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: every PyTorch operation that has a deterministic
    form takes it, K5's atomic adds stay as they are;
  * ``plain det``: the combine is ``scatter_add_plain`` (``index_add``,
    as ``chip_smoke.plain_combine`` swaps it in) under the same setting.

``CUBLAS_WORKSPACE_CONFIG`` is ``:4096:8`` in every run, as the
deterministic setting needs.  Prints, for each run, the xent by step and
the median step seconds (steps 1 on); for each pair of runs, the first
step whose xent differs (bit for bit) and the largest relative gap; and
the warnings of operations that have no deterministic form.  The whole
record goes to ``--out`` (default ``results/torch/train_repeat.json``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

MODES = ("k5", "k5 det", "plain det")


def run(mode: str, steps: int, tmp: Path) -> dict:
    import contextlib

    import torch

    import chip_smoke as cs
    from repro_torch.launch import train as launch_train

    torch.use_deterministic_algorithms(mode.endswith("det"), warn_only=True)
    combine = (cs.plain_combine() if mode.startswith("plain")
               else contextlib.nullcontext())
    with warnings.catch_warnings(record=True) as caught, combine:
        warnings.simplefilter("always")
        before = cs._launches()
        t0 = time.perf_counter()
        try:
            hist = launch_train.main([
                "--arch", cs.TRAIN_ARCH, "--steps", str(steps),
                "--batch", str(cs.TRAIN_B), "--seq", str(cs.TRAIN_T),
                "--save-every", "0", "--ckpt-dir", str(tmp / "unused"),
                "--device", "cuda"])["history"]
            fell = True
        except SystemExit:
            hist, fell = None, False
        seconds = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    launched = {k: v - before[k] for k, v in cs._launches().items()
                if v != before[k]}
    nondet = sorted({str(w.message).split("\n")[0][:200] for w in caught
                     if "deterministic" in str(w.message)})
    return {"mode": mode, "fell": fell, "seconds": seconds,
            "xent": [h["xent"] for h in hist] if hist else None,
            "median_step_s": (statistics.median(
                h["step_time_s"] for h in hist[1:]) if hist else None),
            "launches": launched, "nondeterministic_ops": nondet}


def parted(a: list, b: list) -> dict:
    """The first step whose xent differs, and the largest relative gap."""
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    gaps = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    return {"first_step_apart": first, "max_rel_gap": max(gaps),
            "last_rel_gap": gaps[-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "results" / "torch"
                                         / "train_repeat.json"))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("train_repeat: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            for mode in MODES:
                r = run(mode, args.steps, Path(tmp))
                r["rep"] = rep
                runs.append(r)
                xent = (", ".join(f"{x!r}" for x in r["xent"])
                        if r["xent"] else "did not fall")
                print(f"{mode} #{rep}: {r['seconds']:.1f} s, median step "
                      f"{r['median_step_s']} s, launches {r['launches']}; "
                      f"xent {xent}", flush=True)
                for op in r["nondeterministic_ops"]:
                    print(f"  no deterministic form: {op}", flush=True)
    pairs = {}
    for a, b in itertools.combinations(runs, 2):
        if a["xent"] and b["xent"]:
            key = f"{a['mode']} #{a['rep']} vs {b['mode']} #{b['rep']}"
            pairs[key] = parted(a["xent"], b["xent"])
            print(f"{key}: {pairs[key]}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": cs.card_line(), "runs": runs, "pairs": pairs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
