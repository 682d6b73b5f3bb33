"""The readings that a cell's limits are set from, on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 3] [--seconds 6] [--out FILE]

For each seed, in one process: the program's numbers as a run's check
gives them (set-up, a window of ``--seconds`` at the cell's load, the
check); for the first ``--control-seeds`` seeds also the control's (the
reference in float8 in the program's place, at the same positions or
on the same batches) and, for a train cell, the faults' (half of each
batch left out; a state left unchanged).  Prints one JSON object, also
written to ``--out``: every reading, and for each number the largest
program reading (the lower reading) and the smallest control or fault
reading (the upper one).  The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def calibrate(workload: str, seeds: list, control_seeds: int,
              seconds: float, details: bool = False) -> dict:
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run = harness.start(workload, seed, seconds, False)
        if run.kind != "train":
            harness.window(run)
        d = run.driver
        row = {"seed": seed, "program": d.check()}
        if i < control_seeds:
            row["control"] = d.control()
            row["faults"] = d.faults()
        if details:
            row["details"] = d.details(full=i < control_seeds)
        row["seconds"] = time.perf_counter() - t0
        harness.log(json.dumps(row))
        rows.append(row)
        del run, d
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    names = rows[0]["program"].keys()
    summary = {}
    for n in names:
        upper = [r["control"][n] for r in rows if "control" in r]
        upper += [f[n] for r in rows for f in r.get("faults", {}).values()]
        summary[n] = {"lower": max(r["program"][n] for r in rows),
                      "control_min": min((r["control"][n] for r in rows
                                          if "control" in r), default=None),
                      "upper_min": min(upper, default=None)}
    return {"workload": workload, "rows": rows, "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    ap.add_argument("--details", action="store_true",
                    help="also the spread of the gaps, or each step's loss")
    args = ap.parse_args(argv)
    out = calibrate(args.workload, args.seeds, args.control_seeds,
                    args.seconds, details=args.details)
    if torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
