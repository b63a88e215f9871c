"""``tangram_tpu_torch/examples/tutorial_atlas_mesh.py`` against
``examples/tutorial_atlas_mesh.py`` with ``--quick`` on the CPU, in this
process: the JAX tutorial on the suite's 8-device CPU mesh (its ``("cell",)``
layout over every device), the port in one process (no mesh: a mesh of
processes holds one device's results within 4.8e-6,
``tests/test_torch_parallel.py``), 100 epochs of ``map_cells_to_space`` and
a checkpointed run cut at a third and resumed to 60 epochs.

Tolerances: the printed scores and losses (4 decimals) within one unit of
the last place, with a rounding margin; the epochs equal; the mesh line
names the port's world.
"""

import sys

import pytest

from _examples import (jax_tutorial, line_starting, masked, numbers, one_thread,  # noqa: F401
                       printed)
from tangram_tpu_torch.examples import tutorial_atlas_mesh as port_tutorial

MARGIN = 1e-9


@pytest.fixture(scope="module")
def runs(one_thread):  # noqa: F811
    port = printed(lambda: port_tutorial.main(quick=True, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        # the JAX tutorial reads sys.argv in main()
        mp.setattr(sys, "argv", ["tutorial_atlas_mesh.py", "--quick", "--cpu"])
        jax = printed(jax_tutorial("tutorial_atlas_mesh").main)
    return dict(port=port, jax=jax)


def test_prints_the_jax_tutorials_lines(runs):
    assert [masked(x) for x in runs["port"][1:]] == [masked(x) for x in runs["jax"][1:]]
    assert len(runs["port"]) == 4


def test_mesh_line_names_the_ports_world(runs):
    assert runs["port"][0] == "mesh: None over 1 cpu device(s)"
    assert runs["jax"][0].endswith("over 8 cpu device(s)")


def test_sharded_mapping_score(runs):
    (got,), (want,) = (numbers(line_starting(runs[side], "sharded mapping done"))
                       for side in ("port", "jax"))
    assert abs(got - want) <= 1e-4 + MARGIN


def test_preempted_and_resumed(runs):
    assert (line_starting(runs["port"], "...preempted") ==
            line_starting(runs["jax"], "...preempted") == "...preempted at epoch 20")
    (g_epoch, g_loss), (w_epoch, w_loss) = (numbers(line_starting(runs[side], "resumed"))
                                            for side in ("port", "jax"))
    assert g_epoch == w_epoch == 60
    assert abs(g_loss - w_loss) <= 1e-4 + MARGIN


def test_without_a_gpu_the_default_device_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_tutorial.main(quick=True)
