"""Comparison helpers for the port's tests against the reference.

Reports are compared as parsed json (or csv rows): strings, booleans,
ints and the integer counters are held bit for bit, other floats within
``RTOL``, the batch-vs-loop bound of ``tests/test_profile_batch.py``.
Both packages run the same numpy on equal counters, so equality is
expected; the tolerance only says how much a difference may be.
"""

import csv
import importlib.util
import io
import math
from pathlib import Path

RTOL = 1e-9
# float-typed fields that hold integer counts: compared exactly
EXACT_FLOATS = {"N", "O", "total_O", "total_jobs", "num_waves", "pixels",
                "scratch_bytes", "reduce_flops"}
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def assert_json_close(got, want, path="$"):
    """Recursive equality of two parsed json documents (see module doc)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (path, got, want)
        key = path.rsplit(".", 1)[-1]
        if key in EXACT_FLOATS or not math.isfinite(want):
            assert got == want, (path, got, want)
        else:
            assert math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0), \
                (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _cell(text):
    try:
        return float(text)
    except ValueError:
        return text


def assert_csv_close(got: str, want: str):
    """csv reports: same header, same rows, numeric cells as above."""
    rows_g = list(csv.DictReader(io.StringIO(got)))
    rows_w = list(csv.DictReader(io.StringIO(want)))
    assert rows_g and len(rows_g) == len(rows_w)
    assert list(rows_g[0]) == list(rows_w[0])
    assert_json_close([{k: _cell(v) for k, v in r.items()} for r in rows_g],
                      [{k: _cell(v) for k, v in r.items()} for r in rows_w])


def load_example(name: str):
    """Import ``examples/<name>.py`` as a module (examples are scripts)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
