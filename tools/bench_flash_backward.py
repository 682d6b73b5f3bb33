"""K8 under autograd on the card: built, checked and timed (card only).

    python3 tools/bench_flash_backward.py [--out FILE]

The part of ``chip_smoke.py`` that a change to K8's backward needs, in
about a minute where the whole script takes twenty: it builds
``csrc/flash_attention.cu`` and prints what ptxas said of the forward's
LSE instantiations and of the backward's kernels (registers, spills),
then runs ``chip_smoke.check_flash_backward`` (the output bit-equal to
K8's, the LSE against the plain version's, dq, dk and dv against f32
autograd, two runs bit-equal) and ``chip_smoke.time_flash_backward``
(the forward with the LSE and the backward at the live train shapes
against their bounds).  Prints one JSON object last and writes it to
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
    for line in _build.build_all()["flash_attention"].splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            func = cs._template_args(entry.group(1))
        elif (func and (func.startswith("flash_bwd_") or ",lse" in func)
              and any(w in line for w in ("registers", "spill"))):
            cs.log(f"  ptxas {func}: {line.split(':', 1)[-1].strip()}")
    out = {"card": card, "max_err": cs.check_flash_backward("cuda"),
           "times": cs.time_flash_backward("cuda")}
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
