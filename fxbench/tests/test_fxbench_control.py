"""The control of each cell's comparison at the CPU's size: the reference
in bfloat16, put in the program's place, fails one of the cell's numbers
at the limits the cell holds, while the program's readings of the same
run pass every one."""

import pytest

from fxbench import control
from fxbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("workload", [
    "effex2.live_spectrum", "array8.engine_int8"])
def test_the_control_fails_and_the_program_passes(workload):
    cell = tiny_cell(workload)
    rows = control.readings(cell, [2**31 + 57], 1.5, "cpu")
    prog, ctl = rows[0]["program"], rows[0]["control"]
    assert set(prog) == set(cell.limits) and set(ctl) <= set(prog)
    assert all(prog[n] <= cell.limits[n] for n in prog), prog
    assert any(ctl[n] > cell.limits[n] for n in ctl), ctl
    b = control.bounds(rows)
    assert all(b[n]["lower"] == prog[n] for n in prog)
