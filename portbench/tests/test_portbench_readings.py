"""The chip readings that each cell's limits were set from
(`readings/<cell>.jsonl`, written by `calibrate.py` and the cell's timed
runs on an H100; a held cell's too) judged again against the committed
`limits/<cell>.json`:
every sound run of the program is correct, and the control and every
planted fault are not.  A limit moved past the control's readings, or
under the program's, fails here."""

import json

import pytest

pytest.importorskip("torch")

from portbench import bench
from portbench.tests import smoke

MANIFEST = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]] + sorted(smoke.HELD)


def _readings(cell):
    path = bench.HERE / "readings" / f"{cell}.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _limits(cell):
    return bench.load_json(bench.HERE / "limits" / f"{cell}.json")


@pytest.mark.parametrize("cell", CELLS)
def test_the_limits_were_set_from_enough_seeds(cell):
    rs = _readings(cell)
    program = {r["seed"] for r in rs if r["what"] == "program"}
    control = {r["seed"] for r in rs if r["what"] == "control"}
    assert len(program) >= 12 and len(control) >= 3
    for r in rs:
        assert set(r["checks"]) == set(_limits(cell)), r


@pytest.mark.parametrize("cell", CELLS)
def test_every_sound_run_is_correct(cell):
    limits = _limits(cell)
    for r in _readings(cell):
        if r["what"] == "program":
            ok, judged = bench.judge(list(r["checks"].items()), limits)
            assert ok, (r["seed"], judged)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_every_fault_are_not_correct(cell):
    limits = _limits(cell)
    rs = [r for r in _readings(cell) if r["what"] != "program"]
    assert any(r["what"] == "control" for r in rs)
    for r in rs:
        ok, judged = bench.judge(list(r["checks"].items()), limits)
        assert not ok, (r["what"], r["seed"], judged)
