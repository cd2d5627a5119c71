"""The control, at a size a test run holds: the reference one step of
precision below the configuration (products in fp8, the front end's in
TF32) put in the program's place reads at least three times what the
program reads on one of the cell's numbers, so the limits can lie between.
The chip's readings at the cells' own sizes set the limits (`PERF.md`)."""

import pytest

pytest.importorskip("torch")

from portbench import calibrate
from portbench.tests import smoke


@pytest.mark.parametrize("cell", sorted(smoke.CELLS))
def test_the_control_reads_far_above_the_program(cell):
    config, traffic = smoke.CELLS[cell]
    _, program = smoke.run(cell)
    control = dict(calibrate.control(smoke.root_of(cell), cell, smoke.SEED, device=smoke.CPU,
                                     arch_overrides=smoke.ARCH[config],
                                     traffic_overrides=smoke.TRAFFIC[traffic], issued=24))
    assert set(control) == set(program)
    ratios = {k: control[k] / max(program[k]["value"], 1e-12) for k in control}
    assert max(ratios.values()) >= 3.0, (control, program)
