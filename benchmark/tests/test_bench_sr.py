"""The check of driver ``job_sr`` on the CPU at small shapes: the sound
program in bf16 storage with stochastic rounding held correct against the
stochastic-rounding reference, each control and each planted fault held
not correct; the configuration against the f32 one it is built from; the
reference run without the program or JAX.

The small shapes take 200 epochs (``benchmark/conftest.py``): after ~30
the two runs' independent rounding noise still hides both controls,
whose gaps grow with the epochs; at 200 each control reads many times the
program's ``loss_tail``. The limits are the cell's, set from readings at
its own size on the card (``PERF.md``), but for ``loss_max``: the worst
step's loss gap is rounding noise, which a smaller problem averages less,
so at 300 × 120 the program reads 1.5e-4 against 6.2e-5 at most at
26,431 × 9,852; here it is held to 3e-4, which each control still exceeds
1.9-fold or more (nearest 7.5e-4, e4m3 5.8e-4).
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.faults import FAULTS
from benchmark.harness import ROOT, load_cell, measure

CELL = "mop_slideseq_bf16.cells_adam"
SEED = 2**31 + 21
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the limits that do not carry to the small shapes (see above)
SMALL_LIMITS = {"loss_max": 3e-4}


def _cell(tiny):
    cell = tiny(CELL)
    cell.workload["limits"].update(SMALL_LIMITS)
    return cell


def _run(cell, variant="program"):
    out = measure(cell, SEED, 0.0, False, torch.device("cpu"), time.perf_counter(), variant)
    return out.result


def _failed(checks):
    return {k for k, c in checks.items() if not c["value"] <= c["limit"]}


def test_the_sound_program_is_correct(tiny):
    result = _run(_cell(tiny))
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("control", ["control_nearest", "control_e4m3"])
def test_a_control_is_not_correct(tiny, control):
    cell = _cell(tiny)
    program = _run(cell)["checks"]["loss_tail"]["value"]
    result = _run(cell, control)
    assert not result["correct"], result["checks"]
    assert result["checks"]["loss_tail"]["value"] > 5 * program, (program, result["checks"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(tiny, fault):
    with FAULTS[fault]():
        result = _run(_cell(tiny))
    assert not result["correct"], (fault, result["checks"])


def test_a_few_rows_off_fail_on_their_own_number(tiny):
    with FAULTS["few_rows"]():
        checks = _run(_cell(tiny))["checks"]
    assert "map_rows_off" in _failed(checks), checks


def test_an_unknown_variant_is_refused(tiny):
    with pytest.raises(ValueError, match="variant"):
        _run(_cell(tiny), "control")


def test_the_configuration_is_the_f32_one_in_bf16_storage():
    f32, bf16 = (json.loads((ROOT / "benchmark" / "configs" / f"{n}.json").read_text())
                 for n in ("mop_slideseq", "mop_slideseq_bf16"))
    changed = {"name", "source", "storage", "rounding", "precision", "assumed"}
    assert {k: v for k, v in f32.items() if k not in changed} == \
        {k: v for k, v in bf16.items() if k not in changed}
    # the tutorial's shapes, and the source of the rounding that sets it apart
    assert bf16["source"].startswith(f32["source"] + " ") and "stochastic" in bf16["source"]
    assert bf16["storage"] == dict.fromkeys(("param", "moments", "operands"), "bfloat16")
    assert bf16["rounding"] == "stochastic" and bf16["reduced"] == []
    assert {k: v for k, v in bf16["assumed"].items() if k != "storage"} == f32["assumed"]


def test_no_two_configurations_share_a_source_and_their_cuts():
    configs = MANIFEST["configs"]
    assert len({(c["source"], tuple(c["reduced"])) for c in configs}) == len(configs)
    for c in configs:
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]


def test_the_cell_reports_what_the_f32_cell_reports():
    cell = load_cell(CELL)
    assert cell.workload["driver"] == "job_sr" and cell.chips == 1
    assert cell.workload["call"]["rounding"] == "stochastic"
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        if "mop_slideseq.cells_adam" in m.get("workloads", ()):
            assert CELL in m["workloads"], m["name"]
    assert {"map_row_l1_median", "map_rows_off", "loss_max", "score_max"} <= \
        set(cell.workload["limits"])


def test_a_reference_job_loads_nothing_of_the_program_or_jax():
    script = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness import forbidden_modules
from benchmark.reference import generators, stochastic
p = generators.tutorial_pair(60, 40, 80, 70, 14, 12, 3, 5, 0.09, 0.006)
out = stochastic.run_job(p.markers, p.genes_sc, p.X_sc, None, p.genes_sp, p.X_sp, "cells",
                         "rna_count_based", 5, 0.1, 6, "cpu")
assert out.mapping.shape == (60, 40)
print(forbidden_modules() + sorted(m for m in sys.modules if m.startswith("tangram_tpu_torch")))
"""
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "[]"
