"""The check sees what it exists to see, on the CPU at small shapes: whole
runs with the harness's look for a card skipped (the program on the
kernels' plain twins), the sound program held correct, and the controls
and each planted fault held not correct. (One chip: no exchange between
chips to leave out.)

The limits are set from readings at the cells' own sizes on the card
(``PERF.md``). TF32 contractions in place of f32 are separated there in
cells mode (7.7x the program's worst seed); at 60 epochs on the small
shapes the mapping has not reached the jitter that sets those readings, so
here the test holds TF32's reading to many times the program's instead.
"""

import time

import pytest
import torch

from benchmark.faults import FAULTS
from benchmark.harness import measure

CELLS = ["mop_slideseq.cells_adam"]
SEED = 2**31 + 21
#: the control of each cell: the program's own path below f32 storage
CONTROL = {"mop_slideseq.cells_adam": "control_bf16"}


def _run(cell, variant="program"):
    out = measure(cell, SEED, 0.0, False, torch.device("cpu"), time.perf_counter(), variant)
    return out.result


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(tiny, name):
    result = _run(tiny(name))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny, name):
    result = _run(tiny(name), CONTROL[name])
    assert not result["correct"], result["checks"]


def test_tf32_contractions_read_far_above_the_program(tiny):
    cell = tiny("mop_slideseq.cells_adam")
    program = _run(cell)["checks"]["map_row_l1_median"]["value"]
    tf32 = _run(cell, "control")["checks"]["map_row_l1_median"]["value"]
    assert tf32 > 5 * program, (tf32, program)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(tiny, name, fault):
    with FAULTS[fault]():
        result = _run(tiny(name))
    assert not result["correct"], (fault, result["checks"])


def test_a_few_rows_off_fail_on_their_own_number(tiny):
    """A minority of the mapping's rows altered leaves the median row alone
    and is caught by the share of rows off."""
    with FAULTS["few_rows"]():
        checks = _run(tiny("mop_slideseq.cells_adam"))["checks"]
    failed = {k for k, c in checks.items() if not c["value"] <= c["limit"]}
    assert failed == {"map_rows_off"}, checks
