"""``tangram_tpu_torch/examples/tutorial_fault_tolerant_sweep.py`` against
``examples/tutorial_fault_tolerant_sweep.py`` on the CPU, in this process:
the JAX tutorial on a ``("fold", "cell")`` / ``("trial", "cell")`` mesh of
2 × 3 of the suite's 8 CPU devices, the port in one process (no mesh).

Both tutorials seed with ``random_state=0``, which (as in the reference)
leaves numpy's global stream unseeded for the fold inits, and both split
the CV folds by ``uns['training_genes']``' order. So the test seeds the
global stream alike before each run and makes the JAX package's
``pp_adatas`` keep the requested gene order, as the port does
(``_examples.py``).

Tolerances: the CV dict within 1e-5 (JAX's bound between its fold mesh
and one device, ``tests/test_cross_val.py``); the tuner's frame (4
decimals) with the same configurations, each metric within 2e-3 (JAX's
bound between its trial mesh and one device, ``tests/test_tuning.py``)
plus the last printed place; the best configuration and the journal's
line count equal; the resumed CV equal to the first (the tutorial checks
it itself).
"""

import ast
import sys

import numpy as np
import pytest

from _examples import (jax_tutorial, line_starting, masked, numbers, one_thread,  # noqa: F401
                       printed, training_genes_in_requested_order)
from tangram_tpu_torch.examples import tutorial_fault_tolerant_sweep as port_tutorial

CV_TOL, TUNER_TOL = 1e-5, 2e-3
SEED = 123  # of numpy's global stream before each run


@pytest.fixture(scope="module")
def runs(one_thread):  # noqa: F811
    np.random.seed(SEED)
    port = printed(lambda: port_tutorial.main(device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        training_genes_in_requested_order(mp)
        # the JAX tutorial reads sys.argv in main()
        mp.setattr(sys, "argv", ["tutorial_fault_tolerant_sweep.py", "--cpu"])
        np.random.seed(SEED)
        jax = printed(jax_tutorial("tutorial_fault_tolerant_sweep").main)
    return dict(port=port, jax=jax)


def frame(lines):
    """The tuner's printed frame: (header, rows of numbers)."""
    start = [i for i, x in enumerate(lines) if x.split()[:1] == ["cell_map_agreement"]][0]
    end = [i for i, x in enumerate(lines) if x.startswith("best config:")][0]
    return lines[start].split(), [numbers(x) for x in lines[start + 1:end]]


def test_prints_the_jax_tutorials_lines(runs):
    def shape(lines):
        return [masked(x) for x in lines if not x.startswith("journal:")]

    assert shape(runs["port"]) == shape(runs["jax"])


def test_cross_val_and_its_resume(runs):
    lines = {side: [x for x in runs[side] if x.startswith("cross_val:")]
             for side in ("port", "jax")}
    (got,), (want,) = ([ast.literal_eval(x[len("cross_val:"):].strip()) for x in lines[side]]
                       for side in ("port", "jax"))
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= CV_TOL, key
    resumed = [x for x in runs["port"] if x.endswith("resumed from journal")]
    assert len(resumed) == 3


def test_tuner_frame(runs):
    (g_head, g_rows), (w_head, w_rows) = frame(runs["port"]), frame(runs["jax"])
    assert g_head == w_head and len(g_rows) == len(w_rows) == 8
    configs = [i for i, name in enumerate(g_head) if name.startswith("config/")]
    for g, w in zip(g_rows, w_rows):
        assert g[0] == w[0]  # the row index
        for i in range(len(g_head)):
            a, b = g[i + 1], w[i + 1]
            if i in configs:
                assert a == b
            else:
                assert abs(a - b) <= TUNER_TOL + 1e-4, g_head[i]


def test_best_config_and_journal(runs):
    assert line_starting(runs["port"], "best config:") == line_starting(runs["jax"],
                                                                      "best config:")
    (got,), (want,) = (numbers(line_starting(runs[side], "journal:").rsplit("(", 1)[1])
                       for side in ("port", "jax"))
    assert got == want == 9
