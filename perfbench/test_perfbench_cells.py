"""Every cell end to end on the CPU, through the harness's own code at a
reduced size: the result line's schema, the program against the plain
reference (agreeing), and the reference in float8 in the program's
place (failing the cell's limits)."""

import json
import math

import pytest

from perfbench import harness
from perfbench.cpu_cells import CELLS, args

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(cell, hook, trace, capsys):
    result = harness.main(args(cell, trace=trace), hook=hook)
    out, err = capsys.readouterr()
    return result, out, err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(cell, trace, hook, capsys):
    result, out, err = _run(cell, hook, trace, capsys)
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert RESULT_KEYS <= set(line)
    assert list(line)[-1] == "checks"          # the compared numbers last
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    dev = line["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    c = harness.load_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    for name, m in line["metrics"].items():
        entry = next(e for e in want if e["name"] == name)
        assert m["unit"] == entry["unit"] and math.isfinite(m["value"])
    if trace:
        # off the card the rooflines and peaks are not read at all
        assert dev["busy_s"] > 0 and dev["window_s"] >= dev["busy_s"]
        for key in ("device_ops", "idle_gaps"):
            rows = line["breakdown"][key]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and v >= 0 for n, v in rows)
        assert not any("roofline" in n or "mfu" in n
                       for n in line["metrics"])
    else:
        assert set(line["metrics"]) == {e["name"] for e in want}
    # the numbers compared, with their limits, are stderr's last lines
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for text, (name, c) in zip(tail, line["checks"].items()):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_and_the_control_fails(cell, hook):
    """In f32 the program reads far inside every limit of the cell; the
    reference in float8 in its place fails one."""
    limits = harness.load_cell(cell).limits["numbers"]
    run = harness.start(cell, 3000000023, 0.3, False, hook)
    harness.window(run)
    got = run.driver.check()
    assert set(limits) <= set(got)
    for name in limits:
        assert got[name] <= 0.1 * limits[name]["limit"], (name, got[name])
    control = run.driver.control()
    assert any(control[n] > limits[n]["limit"] for n in limits), control
