"""Run one benchmark cell once and print its result as the last line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``harness.py`` says what a run does.
Every cache that the program's kernels and PyTorch may write goes under
``perfbench/runs/cache/`` in the checkout, at fixed paths.
"""

import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / "runs" / "cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.main(sys.argv[1:], t0=T0)
