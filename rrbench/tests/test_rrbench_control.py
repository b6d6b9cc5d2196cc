"""The control: the reference in the program's place, one precision
below the configuration's (float8 e4m3 for bfloat16), fails the
comparison. On the CPU at tiny sizes; on the card at the cell's own."""

import pytest

from rrbench import control, harness

from conftest import tiny_cell


def _fails(numbers, limits):
    return any(not j["ok"] for j in harness.judge(numbers, limits).values())


@pytest.mark.parametrize("workload", ["rrnet-eval6", "hrnet_attn-eval6"])
def test_fp8_detections_fail(workload):
    cell = tiny_cell(workload, seed=21)
    got = control.detection_controls(cell, frames_checked=2)
    assert _fails(got["fp8"], cell.limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rrnet-eval6", "hrnet_attn-eval6"])
def test_controls_fail_at_the_cells_size(cuda, workload):
    cell = harness.Cell(workload, 97, 0, False, "cuda")
    for name, numbers in control.detection_controls(cell).items():
        assert _fails(numbers, cell.limits), (name, numbers)
