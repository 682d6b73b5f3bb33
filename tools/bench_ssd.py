"""The chunked SSD's kernels on the card: built, checked and timed (card
only).

    python3 tools/bench_ssd.py [--out FILE]

The part of ``chip_smoke.py`` that a change to ``csrc/ssd.cu`` needs, in
a minute or two where the whole script takes twenty: it builds the
kernels and prints what ptxas said of each SSD kernel (registers,
shared memory, spills), then runs ``chip_smoke.check_ssd`` (the kernels
against ``mamba2._ssd_plain`` at Granite 4.0-H Small's and Zamba2's
shapes, ragged T and extreme decays, two runs bit-equal) and
``chip_smoke.time_ssd`` (layer 0's live inputs at 32,768 and 8,192
tokens against the bound).  Prints one JSON object last and writes it to
``--out``; a failed check raises.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = cs.card_line()
    cs.log(card)
    func = None
    for line in _build.build_all()["ssd"].splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            func = cs._template_args(entry.group(1))
        elif func and any(w in line for w in ("registers", "spill", "smem")):
            cs.log(f"  ptxas {func}: {line.split(':', 1)[-1].strip()}")
    out = {"card": card, "max_err": cs.check_ssd("cuda"),
           "times": cs.time_ssd("cuda")}
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
