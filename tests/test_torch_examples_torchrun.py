"""The torchrun branches of the port's atlas and sweep tutorials
(``tangram_tpu_torch/examples/tutorial_{atlas_mesh,fault_tolerant_sweep}.py``)
on four gloo processes on the CPU (``tests/_parallel_worker.py``, suite
``"tutorials"``), against the same tutorials in one process.

The atlas tutorial maps over a ``("cell",)`` mesh of 4, the sweep over
``("fold", "cell")`` and ``("trial", "cell")`` meshes of 2 × 2. Only the
lead rank prints. Tolerances: the atlas's printed score and losses (4
decimals) within one unit of the last place, as
``test_torch_examples_atlas.py`` holds them against JAX's 8-device mesh;
the sweep's CV dict within 1e-5 and its tuner frame within 2e-3 per metric
with the same configurations, as ``test_torch_examples_sweep.py`` (the
global numpy stream seeded alike on every side, which its
``random_state=0`` leaves unseeded).
"""

import ast

import numpy as np
import pytest

import _parallel_worker as pw
from _examples import line_starting, masked, numbers, one_thread, printed  # noqa: F401
from tangram_tpu_torch.examples import tutorial_atlas_mesh as atlas
from tangram_tpu_torch.examples import tutorial_fault_tolerant_sweep as sweep

CV_TOL, TUNER_TOL = 1e-5, 2e-3


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return pw.run(str(tmp_path_factory.mktemp("gloo_tutorials")), suite="tutorials")


@pytest.fixture(scope="module")
def one_process(one_thread):  # noqa: F811
    out = {"atlas": printed(lambda: atlas.main(quick=True, device="cpu"))}
    np.random.seed(pw.TUTORIAL_SEED)
    out["sweep"] = printed(lambda: sweep.main(device="cpu"))
    return out


def lines_of(gloo, rank, name):
    out = gloo[rank][name]
    assert "error" not in out, out.get("error")
    return out["lines"]


@pytest.mark.parametrize("name", ["atlas", "sweep"])
def test_only_the_lead_rank_prints_the_tutorials_lines(gloo, one_process, name):
    lead = lines_of(gloo, 0, name)

    def shape(lines):
        # the sweep's "cv folds" progress lines come from cross_val on every rank
        return [masked(x) for x in lines if not x.startswith(("cv ", "journal:", "mesh:"))]

    assert shape(lead) == shape(one_process[name])
    for rank in range(1, pw.WORLD):
        assert all(x.startswith("cv ") for x in lines_of(gloo, rank, name))


def test_atlas_over_four_processes(gloo, one_process):
    lead, one = lines_of(gloo, 0, "atlas"), one_process["atlas"]
    assert lead[0] == f"mesh: {{'cell': {pw.WORLD}}} over {pw.WORLD} cpu device(s)"
    for prefix in ("sharded mapping done", "resumed"):
        for g, w in zip(numbers(line_starting(lead, prefix)),
                        numbers(line_starting(one, prefix))):
            assert abs(g - w) <= 1e-4 + 1e-9, prefix
    assert line_starting(lead, "...preempted") == "...preempted at epoch 20"


def test_sweep_over_four_processes(gloo, one_process):
    lead, one = lines_of(gloo, 0, "sweep"), one_process["sweep"]
    (got,), (want,) = ([ast.literal_eval(x[len("cross_val:"):].strip())
                        for x in lines if x.startswith("cross_val:")] for lines in (lead, one))
    for key in want:
        assert abs(got[key] - want[key]) <= CV_TOL, key

    def frame(lines):
        start = [i for i, x in enumerate(lines) if x.split()[:1] == ["cell_map_agreement"]][0]
        end = [i for i, x in enumerate(lines) if x.startswith("best config:")][0]
        return lines[start].split(), [numbers(x) for x in lines[start + 1:end]]

    (g_head, g_rows), (w_head, w_rows) = frame(lead), frame(one)
    assert g_head == w_head and len(g_rows) == len(w_rows) == 8
    for g, w in zip(g_rows, w_rows):
        for name, a, b in zip(["index"] + g_head, g, w):
            if name == "index" or name.startswith("config/"):
                assert a == b, name
            else:
                assert abs(a - b) <= TUNER_TOL + 1e-4, name
    assert line_starting(lead, "best config:") == line_starting(one, "best config:")
