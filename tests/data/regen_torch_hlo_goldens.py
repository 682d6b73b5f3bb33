"""Regenerate the full-width HLO texts that the port's audit is held to.

The PyTorch port (``src/repro_torch``) audits HLO text but cannot lower a
model to it: lowering takes JAX.  So the full-width texts it audits, in
its tests and on the card (``chip_smoke.py``), are lowered here by the
reference (``repro.audit.zoo``), at every published width of the config,
and committed gzipped:

    qwen3_moe_235b_a22b__decode.hlo.gz    MoE decode at decode_32k
    qwen3_moe_235b_a22b__prefill.hlo.gz   MoE prefill at prefill_32k

This is a data tool of the tests, not part of either package.  Run it
from the repo root after an intentional lowering change:

    PYTHONPATH=src python tests/data/regen_torch_hlo_goldens.py
"""
import gzip
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro.audit import zoo  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ARCH = "qwen3-moe-235b-a22b"
STEPS = ("decode", "prefill")


def golden_name(arch: str, step: str) -> str:
    return f"{arch.replace('-', '_')}__{step}.hlo.gz"


def main() -> int:
    texts = zoo.lower_config_steps(ARCH, steps=list(STEPS), reduced=False)
    for step in STEPS:
        path = HERE / golden_name(ARCH, step)
        # mtime=0 keeps the archive byte-stable across regenerations
        with gzip.GzipFile(path, "wb", mtime=0) as fh:
            fh.write(texts[step].encode())
        print(f"wrote {path} ({path.stat().st_size} bytes, "
              f"{len(texts[step])} chars)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
