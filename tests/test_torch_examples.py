"""``tangram_tpu_torch/examples/tutorial_mapping.py`` against
``examples/tutorial_mapping.py``, both with ``--quick`` on the CPU in this
process, from the same synthetic pair (``make_synthetic_pair``, drawn bit
for bit alike) and seed.

The port runs with ``device="cpu"`` (the plain PyTorch path: the
reference loop, the batched LOO) and writes its plots to a temporary
``--outdir``; the JAX tutorial writes its plots next to its module's
``__file__``, which the test points into a temporary directory. Both
print the same lines. Tolerances, on the printed numbers:

* numbers printed to 3 decimals (train score, tuned schedule's score, the
  AUC metrics) within one unit of that last place, with a rounding margin
  (two f32 implementations land within ~1e-6 of each other; one may round
  up where the other rounds down); the tuned schedule's epoch count, the
  marker count and the prediction's shape equal;
* the gene report's scores (6 decimals) and the CV dict (printed in full)
  within 1e-5 (JAX's own bound between two of its loops,
  ``tests/test_cross_val.py``; the report's cosines of the two 100-epoch
  mappings were 2e-6 apart when this was written).

The port's batched LOO (120 folds × 500 × 200, 50 epochs) takes most of
the file's time: on an 8-core host four torch threads run it in 18 s
where one takes 43.

The other tutorials: ``test_torch_examples_{deconvolution,atlas,sweep}.py``.
"""

import ast
import math
import re

import numpy as np
import pytest
import torch

from _examples import REPO, jax_tutorial, line_starting, masked, numbers, printed
from tangram_tpu_torch.examples import tutorial_mapping as port_tutorial

#: the printed decimals' margin beyond one unit of the last place
MARGIN = 1e-9
CV_TOL = 1e-5
PORT_THREADS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    port_dir = tmp_path_factory.mktemp("port_plots")
    jax_dir = tmp_path_factory.mktemp("jax_plots")
    try:
        port = printed(lambda: port_tutorial.main(quick=True, device="cpu",
                                                  outdir=str(port_dir)))
    finally:
        torch.set_num_threads(threads)
    jax_mod = jax_tutorial("tutorial_mapping")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mod, "__file__", str(jax_dir / "tutorial_mapping.py"))
        jax = printed(lambda: jax_mod.main(quick=True))
    return dict(port=port, jax=jax, port_dir=port_dir, jax_dir=jax_dir)


def within_last_place(got: float, want: float, decimals: int):
    assert abs(got - want) <= 10.0 ** -decimals + MARGIN, (got, want)


def test_synthetic_pair_is_the_jax_tutorials():
    ad_sc, ad_sp = port_tutorial.make_synthetic_pair(60, 30, 20, n_types=3, seed=4)
    j_sc, j_sp = jax_tutorial("tutorial_mapping").make_synthetic_pair(60, 30, 20, n_types=3,
                                                                      seed=4)
    for a, b in ((ad_sc, j_sc), (ad_sp, j_sp)):
        assert np.array_equal(np.asarray(a.X), np.asarray(b.X))
        assert list(a.obs.index) == list(b.obs.index)
        assert list(a.var.index) == list(b.var.index)
    assert list(ad_sc.obs["subclass_label"]) == list(j_sc.obs["subclass_label"])
    assert np.array_equal(ad_sp.obsm["spatial"], j_sp.obsm["spatial"])


def test_prints_the_jax_tutorials_lines(runs):
    port = [x for x in runs["port"] if not x.startswith("plots saved to")]
    jax = [x for x in runs["jax"] if not x.startswith("plots saved to")]
    assert [masked(x) for x in port] == [masked(x) for x in jax]


def test_marker_count_and_prediction_shape(runs):
    for prefix in ("ct prediction:",):
        assert line_starting(runs["port"], prefix) == line_starting(runs["jax"], prefix)
    assert runs["port"][0] == runs["jax"][0]
    assert re.fullmatch(r"\d+ marker genes selected", runs["port"][0])


@pytest.mark.parametrize("prefix", ["train score:", "Gene-voxel score:"])
def test_train_score(runs, prefix):
    got, want = (numbers(line_starting(runs[side], prefix)) for side in ("port", "jax"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        within_last_place(g, w, 3)


def test_tuned_schedule(runs):
    (g_score, g_epochs), (w_score, w_epochs) = (
        numbers(line_starting(runs[side], "tuned schedule:")) for side in ("port", "jax"))
    within_last_place(g_score, w_score, 3)
    assert g_epochs == w_epochs


def test_gene_report_head(runs):
    def rows(lines):
        start = [i for i, x in enumerate(lines) if x.split() and x.split()[0] == "score"][0]
        return [x.split() for x in lines[start + 1:start + 6]]

    for g, w in zip(rows(runs["port"]), rows(runs["jax"])):
        assert g[0] == w[0] and g[2] == w[2]  # gene, is_training
        assert abs(float(g[1]) - float(w[1])) <= CV_TOL
        for a, b in zip(g[3:], w[3:]):  # sparsities: data, not training
            assert a == b


@pytest.mark.parametrize("prefix", ["cv avg test score", "cv avg train score"])
def test_cv_lines(runs, prefix):
    (g,), (w,) = (numbers(line_starting(runs[side], prefix)) for side in ("port", "jax"))
    within_last_place(g, w, 3)


def test_cv_dict(runs):
    got, want = (ast.literal_eval(line_starting(runs[side], "cv:")[len("cv:"):].strip())
                 for side in ("port", "jax"))
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= CV_TOL, key


def test_auc_metrics(runs):
    def parse(line):
        return {k: float(v) for k, v in re.findall(r"'(\w+)': (nan|-?[\d.]+)", line)}

    got, want = (parse(line_starting(runs[side], "metrics:")) for side in ("port", "jax"))
    assert got.keys() == want.keys() and len(want) == 4
    for key in want:
        if math.isnan(want[key]):
            assert math.isnan(got[key]), key
        else:
            within_last_place(got[key], want[key], 3)


def test_plots_go_to_outdir_and_not_into_the_repo(runs):
    for side in ("port_dir", "jax_dir"):
        for name in ("training_scores.png", "auc.png"):
            assert (runs[side] / name).stat().st_size > 0
    assert line_starting(runs["port"], "plots saved to") == f"plots saved to {runs['port_dir']}"
    for where in ("examples", "tangram_tpu_torch/examples", "."):
        for name in ("training_scores.png", "auc.png"):
            assert not (REPO / where / name).exists()


def test_parse_args_defaults():
    args = port_tutorial.parse_args([])
    assert (args.quick, args.device, args.outdir) == (False, None, ".")
