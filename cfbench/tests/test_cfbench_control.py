"""The control, the reference in TF32 (the nearest precision below the
configuration's float32) put in the program's place, comes out not
correct against every cell's limits, at a size a test run can hold."""

import pytest

from cfbench.tests.tiny import FIT_CELLS, SERVE_CELLS, run, tiny_spec


@pytest.mark.parametrize("cell", FIT_CELLS + SERVE_CELLS)
def test_control_fails(tmp_path, cell):
    res = run(tiny_spec(tmp_path), cell, control=True)
    assert not res["correct"], res["checks"]
