"""``tangram_tpu_torch/examples/tutorial_deconvolution.py`` against
``examples/tutorial_deconvolution.py`` on the CPU, in this process: the
same pair and segmentation (the port's own ``make_synthetic_pair``, drawn
bit for bit as JAX's), constrained mapping for 300 epochs at seed 42, then
the deconvolution chain. The JAX package's ``pp_adatas`` is made to keep
the requested gene order, as the port does (``_examples.py``).

Tolerances: the target count and the filter's kept cells are equal; the
segmentation objects annotated and each cell type's count within 1% of
the segmentation's objects. The chain assigns each kept cell to its argmax
spot, and after 300 constrained epochs two f32 implementations differ by
up to 6e-3 in the mapping (measured when this was written), which moved
the argmax of 3 of 800 cells whose two best spots lay within 3e-4: each
such cell moves one object and one type's count by one.
"""

import pytest

from _examples import (jax_tutorial, line_starting, masked, numbers, one_thread,  # noqa: F401
                       printed, training_genes_in_requested_order)
from tangram_tpu_torch.examples import tutorial_deconvolution as port_tutorial

#: the share of the segmentation's objects a count may move
SHARE = 0.01


@pytest.fixture(scope="module")
def runs(one_thread):  # noqa: F811
    port = printed(lambda: port_tutorial.main(device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        training_genes_in_requested_order(mp)
        jax = printed(jax_tutorial("tutorial_deconvolution").main)
    return dict(port=port, jax=jax)


def cluster_counts(lines):
    start = lines.index("cluster")
    rows = [line.split() for line in lines[start + 1:] if not line.startswith("Name:")]
    return {label: int(n) for label, n in rows}


def test_prints_the_jax_tutorials_lines(runs):
    head = 3  # target count, filter, objects annotated; then the counts by type
    assert [masked(x) for x in runs["port"][:head + 1]] == [
        masked(x) for x in runs["jax"][:head + 1]]
    assert runs["port"][-1] == runs["jax"][-1] == "Name: count, dtype: int64"


@pytest.mark.parametrize("prefix", ["target_count:", "filter keeps"])
def test_target_count_and_filter(runs, prefix):
    assert line_starting(runs["port"], prefix) == line_starting(runs["jax"], prefix)


def test_objects_annotated(runs):
    (total,) = numbers(line_starting(runs["jax"], "target_count:"))
    (got,), (want,) = (numbers(line_starting(runs[side], "segmentation objects annotated:"))
                       for side in ("port", "jax"))
    assert abs(got - want) <= SHARE * total


def test_counts_by_cell_type(runs):
    (total,) = numbers(line_starting(runs["jax"], "target_count:"))
    got, want = cluster_counts(runs["port"]), cluster_counts(runs["jax"])
    assert got.keys() == want.keys() and len(want) == 8
    for label in want:
        assert abs(got[label] - want[label]) <= SHARE * total, label


def test_segmentation_features_are_the_jax_tutorials():
    import numpy as np

    from tangram_tpu_torch.examples.tutorial_mapping import make_synthetic_pair

    jax_mod = jax_tutorial("tutorial_deconvolution")
    _, ad_sp = make_synthetic_pair(40, 30, 10)
    _, j_sp = jax_tutorial("tutorial_mapping").make_synthetic_pair(40, 30, 10)
    port_tutorial.add_segmentation_features(ad_sp)
    jax_mod.add_segmentation_features(j_sp)
    got, want = ad_sp.obsm["image_features"], j_sp.obsm["image_features"]
    assert np.array_equal(got["segmentation_label"], want["segmentation_label"])
    assert list(got["segmentation_centroid"]) == list(want["segmentation_centroid"])
