"""The check of driver ``job_graph`` sees what it exists to see, on the CPU
at small shapes: a whole run of the graph cell with the harness's look for
a card skipped (the program on the kernels' plain twins), the sound
program held correct by the cell's own limits, and the TF32 control and
each planted graph fault held not correct. ``mop_slideseq_spatial``'s small
shapes come from the repository's root ``conftest.py``.
"""

import time

import pytest
import torch

from benchmark.faults_graph import FAULTS
from benchmark.harness import measure


CELL = "mop_slideseq_spatial.stack_knn"
SEED = 2**31 + 27


def _run(cell, variant="program"):
    out = measure(cell, SEED, 0.0, False, torch.device("cpu"), time.perf_counter(), variant)
    return out.result


def test_the_sound_program_is_correct(tiny):
    result = _run(tiny(CELL))
    assert result["correct"], result["checks"]


def test_the_control_is_not_correct(tiny):
    result = _run(tiny(CELL), "control")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_graph_fault_is_not_correct(tiny, fault):
    with FAULTS[fault]():
        result = _run(tiny(CELL))
    assert not result["correct"], (fault, result["checks"])
