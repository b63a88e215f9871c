"""``map_cells_to_space`` with the graph terms, the port against the JAX
package.

A small ``synthetic_mapping_pair`` (``tests/test_torch_mapping.py::pairs``)
with its hex-lattice spot coordinates: both packages get **the same
spot graph** (the JAX package's ``obsp``, copied onto the port's AnnData),
since the two ``spatial_neighbors`` may break ties at the k-th distance
differently (``tests/test_torch_spatial.py``). Each graph term alone and
all five together, on dense and on k-NN graphs, in cells mode through the
port's default CPU loop (the materialized reference loop), the stack also
on the fused loop and in clusters mode; the JAX package runs its default
(XLA on the CPU).

Tolerances, as ``tests/test_torch_mapping.py``: the loss histories at rtol
3e-4 / atol 3e-5, the mapping at rtol 3e-3 (exp of a logit atol 3e-3),
the train-gene scores at atol 1e-4, the sparsity columns exactly.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import tangram_tpu as tg
import tangram_tpu.mapping as jmapping
import tangram_tpu_torch as tgt
import tangram_tpu_torch.mapping as tmapping

from test_torch_graph_terms import GRAPH_LAMBDAS, TERMS
from test_torch_mapping import pairs

EPOCHS = 30
GRAPH_KEYS = ("spatial_connectivities", "spatial_distances")


@functools.lru_cache(maxsize=None)
def shared_pairs():
    """The JAX pair and the port's, the port's spot graph replaced by the
    JAX package's."""
    (sc_j, sp_j), (sc_t, sp_t) = pairs()
    for key in GRAPH_KEYS:
        sp_t.obsp[key] = sp_j.obsp[key].copy()
    return (sc_j, sp_j), (sc_t, sp_t)


def options(term, graph_format, mode="cells"):
    lam = {k: v for k, v in TERMS[term].items() if k in GRAPH_LAMBDAS}
    kw = dict(mode=mode, num_epochs=EPOCHS, random_state=7, verbose=False,
              density_prior="rna_count_based", cluster_label="subclass_label",
              graph_format=graph_format, **lam)
    return kw


def mapper_arguments(module, run):
    """(what ``run()`` returns, the keywords ``module.map_cells_to_space``
    handed its ``Mapper``)."""
    seen = {}
    real = module.Mapper

    def capture(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    with mock.patch.object(module, "Mapper", capture):
        return run(), seen


@functools.lru_cache(maxsize=None)
def jax_map(term, graph_format, mode="cells"):
    (sc_j, sp_j), _ = shared_pairs()
    return mapper_arguments(jmapping, lambda: tg.map_cells_to_space(
        sc_j, sp_j, **options(term, graph_format, mode)))


def torch_map(term, graph_format, mode="cells", **extra):
    _, (sc_t, sp_t) = shared_pairs()
    kw = dict(options(term, graph_format, mode), **extra)
    return mapper_arguments(tmapping, lambda: tgt.map_cells_to_space(
        sc_t, sp_t, device="cpu", **kw))


def assert_same_graph_inputs(got, want):
    """The port's Mapper got the JAX package's spot graphs (dense float64
    arrays or NeighborGraphs) and cell-type encoding."""
    for slot in ("voxel_weights", "neighborhood_filter", "spatial_weights"):
        a, b = got[slot], want[slot]
        assert (a is None) == (b is None), slot
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=slot)
        elif b is not None:
            assert isinstance(a, tgt.NeighborGraph), slot
            for name in ("indices", "weights", "t_indices", "t_weights"):
                np.testing.assert_array_equal(getattr(a, name).numpy(),
                                              np.asarray(getattr(b, name)))
    if want["ct_encode"] is None:
        assert got["ct_encode"] is None
    else:
        np.testing.assert_array_equal(got["ct_encode"], want["ct_encode"])


def assert_maps_close(map_t, map_j):
    assert map_t.X.shape == map_j.X.shape
    np.testing.assert_allclose(map_t.X, map_j.X, rtol=3e-3, atol=1e-7)
    np.testing.assert_allclose(map_t.X.sum(axis=1), 1.0, atol=1e-5)
    h_j, h_t = map_j.uns["training_history"], map_t.uns["training_history"]
    assert set(h_t) == set(h_j)
    for key in ("total_loss", "main_loss", "kl_reg"):
        assert len(h_t[key]) == EPOCHS
        np.testing.assert_allclose(h_t[key], h_j[key], rtol=3e-4, atol=3e-5)
    df_j = map_j.uns["train_genes_df"]
    df_t = map_t.uns["train_genes_df"].loc[df_j.index]
    assert list(df_t.columns) == list(df_j.columns)
    np.testing.assert_allclose(df_t["train_score"], df_j["train_score"], atol=1e-4)
    for col in ("sparsity_sc", "sparsity_sp", "sparsity_diff"):
        np.testing.assert_array_equal(df_t[col], df_j[col])


@pytest.mark.parametrize("graph_format", ["dense", "knn"])
@pytest.mark.parametrize("term", list(TERMS))
def test_map_cells_to_space_with_graph_terms_matches_jax(term, graph_format):
    (map_t, args_t), (map_j, args_j) = (torch_map(term, graph_format),
                                        jax_map(term, graph_format))
    assert_same_graph_inputs(args_t, args_j)
    assert_maps_close(map_t, map_j)


def test_the_stack_on_the_fused_loop_matches_jax():
    assert_maps_close(torch_map("all five", "knn", impl="fused")[0],
                      jax_map("all five", "knn")[0])


def test_the_stack_in_clusters_mode_matches_jax():
    """Clusters mode: the island term's encoding is the identity of the
    aggregated AnnData (one row per cluster)."""
    (map_t, args_t), (map_j, args_j) = (torch_map("all five", "knn", "clusters"),
                                        jax_map("all five", "knn", "clusters"))
    assert map_j.X.shape[0] == 5
    np.testing.assert_array_equal(args_t["ct_encode"], np.eye(5))
    assert_same_graph_inputs(args_t, args_j)
    assert_maps_close(map_t, map_j)


def test_graph_terms_move_the_mapping():
    """The terms are on: the stack's mapping is not the plain one."""
    _, (sc_t, sp_t) = shared_pairs()
    plain = tgt.map_cells_to_space(sc_t, sp_t, device="cpu", num_epochs=EPOCHS,
                                   random_state=7, verbose=False)
    assert np.abs(torch_map("all five", "knn")[0].X - plain.X).max() > 1e-3


def test_any_other_graph_format_is_dense():
    want, _ = torch_map("all five", "dense")
    got, args = torch_map("all five", "csr")
    assert isinstance(args["spatial_weights"], np.ndarray)
    np.testing.assert_array_equal(got.X, want.X)


def test_getis_ord_wins_the_shared_slot():
    """With the Moran/Geary and the Getis-Ord families on, the Getis-Ord
    variant (binary, self-inclusion) fills the shared spatial_weights slot:
    the reference's order, kept."""
    _, args = torch_map("all five", "dense")
    _, (_, sp_t) = shared_pairs()
    np.testing.assert_array_equal(args["spatial_weights"],
                                  tgt.spatial_weights(sp_t, False, True))
    assert torch.is_tensor(torch_map("all five", "knn")[1]["spatial_weights"].weights)


def test_islands_need_a_cluster_label():
    _, (sc_t, sp_t) = shared_pairs()
    with pytest.raises(ValueError, match="cluster_label must be specified"):
        tgt.map_cells_to_space(sc_t, sp_t, device="cpu", num_epochs=2, verbose=False,
                               lambda_ct_islands=0.3)
    (sc_j, sp_j), _ = shared_pairs()
    with pytest.raises(ValueError, match="cluster_label must be specified"):
        tg.map_cells_to_space(sc_j, sp_j, num_epochs=2, verbose=False,
                              lambda_ct_islands=0.3)


def test_graph_terms_need_the_spot_graph():
    _, (sc_t, sp_t) = shared_pairs()
    sp_t = sp_t.copy()
    for key in GRAPH_KEYS:
        del sp_t.obsp[key]
    with pytest.raises(ValueError, match="Missing spatial neighborhood"):
        tgt.map_cells_to_space(sc_t, sp_t, device="cpu", num_epochs=2, verbose=False,
                               lambda_moran=0.3)


def test_constrained_mode_ignores_the_graph_terms():
    """As the JAX package: constrained mode takes no graph term, and the
    five lambdas leave its result as it is."""
    _, (sc_t, sp_t) = shared_pairs()
    kw = dict(mode="constrained", target_count=50, num_epochs=10, random_state=7,
              verbose=False, device="cpu")
    plain = tgt.map_cells_to_space(sc_t, sp_t, **kw)
    with_terms = tgt.map_cells_to_space(sc_t, sp_t, cluster_label="subclass_label",
                                        graph_format="knn", **GRAPH_LAMBDAS, **kw)
    np.testing.assert_array_equal(with_terms.X, plain.X)
    np.testing.assert_array_equal(with_terms.obs["F_out"], plain.obs["F_out"])
