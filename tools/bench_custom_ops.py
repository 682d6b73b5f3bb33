"""What the ``torch.library`` operators of K5, K7 and K8 cost (card only).

    python3 tools/bench_custom_ops.py [--tree PATH] [--out FILE]

Runs the kernels of the tree at PATH (default: this checkout), so that a
parent tree unpacked beside it (``git archive <parent> | tar -x -C
build/parent``) and this one run in one call, in turns.  For each tree:

  * the device time of K5, K7 and K8 at ``chip_smoke.py``'s rows
    (``time_scatter_kernels`` and ``time_flash_kernel`` of that tree's
    ``chip_smoke.py``: CUDA events, the host's enqueue hidden),
  * the host time of one wrapper call, launch included, at a decode
    step's shapes (K7 on 32 ids into 128 bins, K5 on 32 x 2048 f32 rows
    into 4 tokens, K8 on one 4 x 8 x 128 x 128 bf16 prefill tile): the
    median over 2000 back-to-back calls, so what the dispatcher adds to
    a call shows here,
  * the host seconds of a decode step of granite-moe-1b-a400m whole and
    of qwen3-moe-235b-a22b at full width cut to QWEN3_LAYERS layers, bf16
    at random weights, batch 4 at position 128 of a 256-slot cache: the
    median of 20 steps, each synchronized.

Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

QWEN3_LAYERS = 4
DECODE_B, DECODE_POS, DECODE_LEN, DECODE_REPS = 4, 128, 256, 20
HOST_CALLS = 2000


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    """Median host microseconds of one call over blocks of 100 calls."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(calls // 100):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        per.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def _decode_seconds(arch: str, layers=None) -> float:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(params, DECODE_B, DECODE_LEN)
    tok = torch.zeros((DECODE_B, 1), dtype=torch.int32, device="cuda")
    times = []
    with torch.no_grad():
        for rep in range(DECODE_REPS + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = model.decode_step(params, tok, cache, pos=DECODE_POS)
            torch.cuda.synchronize()
            if rep >= 3:
                times.append(time.perf_counter() - t0)
    del model, params, cache
    torch.cuda.empty_cache()
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.scatter_add import kernel as sk

    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build_all()
    out = {"tree": str(tree), "card": smoke.card_line(),
           "torch": torch.__version__}
    rows = smoke.time_scatter_kernels("cuda")
    rows.update(smoke.time_flash_kernel("cuda"))
    out["device_ms"] = {k: {case: row["ms"] for case, row in cases.items()}
                        for k, cases in rows.items()
                        if k in ("scatter_add", "bincount", "flash_attention")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, 128, (32,), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.randn((32, 2048), generator=gen, device="cuda")
    tok = torch.randint(0, 4, (32,), generator=gen, device="cuda",
                        dtype=torch.int32)
    q = torch.randn((4, 8, 128, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    out["host_us"] = {
        "bincount": _host_us(lambda: sk.bincount_launch(ids, 128)),
        "scatter_add": _host_us(lambda: sk.scatter_add_launch(vals, tok, 4)),
        "flash_attention": _host_us(
            lambda: fk.flash_attention_launch(q, q, q)),
        "empty": _host_us(lambda: torch.cuda._sleep(0)),
    }
    out["decode_s"] = {
        "granite-moe-1b-a400m": _decode_seconds("granite-moe-1b-a400m"),
        f"qwen3-moe-235b-a22b/{QWEN3_LAYERS}": _decode_seconds(
            "qwen3-moe-235b-a22b", QWEN3_LAYERS),
    }
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
