"""``tests/test_api.py`` and ``tests/test_datasets.py`` on the port's public
API (``device="cpu"``).

Every case of ``tests/test_api.py`` runs here on ``tangram_tpu_torch``
with the JAX test's own assertions and tolerances, but
``test_public_namespace_covers_reference_surface``, which needs the
reference checkout (``tests/test_torch_namespace.py`` walks the port's
namespace against the JAX package's instead). JAX's ``impl="xla"`` is the
port's reference loop (``impl="reference"``), ``impl="pallas"`` its fused
loop (``impl="fused"``, the kernels' plain twins on the CPU). Where a case
computes a value from the inputs alone (gene sparsity, cluster means),
the port's value is also held to the JAX package's, exactly. From
``tests/test_datasets.py``: the fixture's statistics and the learnability
of its spatial signal on the port's ``synthetic_mapping_pair``.
"""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu_torch import adlite

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Dozens of small fits: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def ad_sc_mock():
    return tgt.AnnData(X=np.array([[0, 1, 1], [0, 1, 1]]),
                       obs=pd.DataFrame(index=["cell_1", "cell_2"]),
                       var=pd.DataFrame(index=["gene_a", "gene_b", "gene_d"]))


@pytest.fixture
def ad_sp_mock():
    return tgt.AnnData(X=np.array([[1, 1, 1, 1], [1, 1, 1, 1]]),
                       obs=pd.DataFrame(index=["voxel_1", "voxel_2"]),
                       var=pd.DataFrame(index=["gene_c", "gene_b", "gene_a", "gene_d"]))


@pytest.fixture
def adatas(rng):
    """``tests/test_api.py``'s synthetic pair (60 cells × 40 spots × 25
    genes, 4 clusters, spatial coordinates) through the port's AnnData."""
    n_cells, n_spots, n_genes = 60, 40, 25
    centers = rng.normal(0, 1, (4, n_genes)) * 2
    labels = rng.integers(0, 4, n_cells)
    S = np.clip(rng.poisson(np.exp(centers[labels] * 0.5) + 0.5), 0, None).astype(np.float32)
    spot_labels = rng.integers(0, 4, n_spots)
    G = np.clip(rng.poisson(np.exp(centers[spot_labels] * 0.5) + 0.5), 0,
                None).astype(np.float32)
    ad_sc = tgt.AnnData(
        X=S,
        obs=pd.DataFrame({"subclass_label": pd.Categorical([f"c{l}" for l in labels])},
                         index=[f"cell{i}" for i in range(n_cells)]),
        var=pd.DataFrame(index=[f"Gene{i}" for i in range(n_genes)]))
    ad_sp = tgt.AnnData(X=G, obs=pd.DataFrame(index=[f"spot{i}" for i in range(n_spots)]),
                        var=pd.DataFrame(index=[f"Gene{i}" for i in range(n_genes)]))
    ad_sp.obsm["spatial"] = rng.random((n_spots, 2)).astype(np.float64)
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


def map_cells(adatas, **kw):
    return tgt.map_cells_to_space(adatas[0], adatas[1], verbose=False, **CPU, **kw)


# ---------------------------------------------------------------------------
# preprocessing and the error paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("genes", [None, ["gene_a", "gene_b"]])
def test_pp_data(ad_sc_mock, ad_sp_mock, genes):
    tgt.pp_adatas(ad_sc_mock, ad_sp_mock, genes)
    assert ad_sc_mock.uns["training_genes"] == ad_sp_mock.uns["training_genes"]
    assert ad_sc_mock.uns["overlap_genes"] == ad_sp_mock.uns["overlap_genes"]
    assert np.asarray(ad_sc_mock.X).any(axis=0).all()
    assert np.asarray(ad_sp_mock.X).any(axis=0).all()
    assert "rna_count_based_density" in ad_sp_mock.obs.keys()
    assert "uniform_density" in ad_sp_mock.obs.keys()


def test_pp_data_writes_spatial_graph(adatas):
    _, ad_sp = adatas
    assert "spatial_connectivities" in ad_sp.obsp
    assert "spatial_distances" in ad_sp.obsp


@pytest.mark.parametrize("mode, cluster_label, lambda_g1, e", [
    ("clusters", "subclass_label", 0, "lambda_g1 cannot be 0."),
    ("not_a_mode", None, 1, 'Argument "mode" must be'),
    ("clusters", None, 1, "cluster_label must be specified"),
])
def test_invalid_map_cells_to_space(adatas, mode, cluster_label, lambda_g1, e):
    with pytest.raises(ValueError) as exc_info:
        map_cells(adatas, mode=mode, cluster_label=cluster_label, lambda_g1=lambda_g1,
                  random_state=42, num_epochs=10)
    assert e in str(exc_info.value)


def test_invalid_density_prior(adatas):
    with pytest.raises(ValueError, match="Invalid input for density_prior"):
        map_cells(adatas, density_prior="bogus", num_epochs=5)


def test_constrained_requires_target_count(adatas):
    with pytest.raises(ValueError, match="target_count"):
        map_cells(adatas, mode="constrained", target_count=None, num_epochs=5)


# ---------------------------------------------------------------------------
# the mapping's output contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cells", "clusters"])
def test_map_cells_to_space_output(adatas, mode):
    ad_map = map_cells(adatas, mode=mode, cluster_label="subclass_label", num_epochs=40,
                       random_state=42)
    n_rows = 4 if mode == "clusters" else adatas[0].n_obs
    assert ad_map.shape == (n_rows, adatas[1].n_obs)
    np.testing.assert_allclose(ad_map.X.sum(axis=1), 1.0, atol=1e-4)
    df = ad_map.uns["train_genes_df"]
    assert {"train_score", "sparsity_sc", "sparsity_sp", "sparsity_diff"} <= set(df.columns)
    assert len(ad_map.uns["training_history"]["total_loss"]) == 40
    assert list(ad_map.var.index) == list(adatas[1].obs.index)


def test_train_gene_report_device_logits_matches_host(adatas):
    """The report's scores, projected from the trained logits, equal the
    host projection of the returned mapping."""
    from tangram_tpu_torch.evaluation import _column_cosine, projected_expression

    ad_map = map_cells(adatas, num_epochs=30, random_state=42)
    genes = list(ad_map.uns["train_genes_df"].index)
    S = np.asarray(adatas[0][:, genes].X, np.float32)
    G = np.asarray(adatas[1][:, genes].X, np.float32)
    host_scores = _column_cosine(projected_expression(ad_map.X, S), G)
    reported = ad_map.uns["train_genes_df"].loc[genes, "train_score"].values
    np.testing.assert_allclose(reported, host_scores, rtol=1e-5, atol=1e-6)


def test_map_constrained_output(adatas):
    ad_map = map_cells(adatas, mode="constrained", target_count=30, num_epochs=40,
                       random_state=42, density_prior="uniform")
    assert "F_out" in ad_map.obs
    assert ((ad_map.obs["F_out"] >= 0) & (ad_map.obs["F_out"] <= 1)).all()
    assert "count_reg" in ad_map.uns["training_history"]


def test_deterministic_with_random_state(adatas):
    kwargs = dict(mode="cells", num_epochs=20, random_state=42)
    np.testing.assert_array_equal(map_cells(adatas, **kwargs).X, map_cells(adatas, **kwargs).X)


@pytest.mark.parametrize("lambda_g2, lambda_d, density_prior, scale", [
    (0, 0, None, True),
    (0, 0, None, False),
    (1, 0, None, True),
    (0, 1, "uniform", True),
    (0, 1, "rna_count_based", False),
])
def test_train_score_match(adatas, lambda_g2, lambda_d, density_prior, scale):
    ad_map = map_cells(adatas, mode="clusters", cluster_label="subclass_label",
                       lambda_g2=lambda_g2, lambda_d=lambda_d, density_prior=density_prior,
                       scale=scale, random_state=42, num_epochs=100)
    ad_ge = tgt.project_genes(adata_map=ad_map, adata_sc=adatas[0],
                              cluster_label="subclass_label", scale=scale)
    df = tgt.compare_spatial_geneexp(ad_ge, adatas[1])
    avg_score_df = round(df[df["is_training"] == True]["score"].mean(), 3)  # noqa: E712
    avg_score_hist = round(float(list(ad_map.uns["training_history"]["main_loss"])[-1]), 3)
    assert avg_score_df == pytest.approx(avg_score_hist, abs=2e-3)


@pytest.fixture
def sparse_adatas(adatas):
    """The synthetic pair with CSR counts on both sides."""
    for ad in adatas:
        ad.X = sp.csr_matrix(ad.X)
    return adatas


def test_cells_job_picks_columns_without_a_row_copy(sparse_adatas):
    """A cells-mode job slices its sparse inputs twice (S and G), each a
    column pick over every row: no slice copies rows."""
    adlite.SPARSE_SLICES.clear()
    map_cells(sparse_adatas, mode="cells", num_epochs=5, random_state=42)
    assert adlite.SPARSE_SLICES == {"columns": 2}


MODE_ARGS = {
    "cells": dict(mode="cells"),
    "clusters": dict(mode="clusters", cluster_label="subclass_label"),
    "constrained": dict(mode="constrained", target_count=30, density_prior="uniform"),
}


@pytest.mark.parametrize("mode", list(MODE_ARGS))
def test_result_frames_equal_the_sliced_forms(sparse_adatas, mode):
    """The result's ``obs`` and ``var`` and every column of its
    ``train_genes_df`` equal the frames that slicing the inputs builds
    (``adata[:, genes].obs``, ``adata[:, genes].var.sparsity``): index,
    order, dtypes and values. It trains on every other gene in reverse, so
    no frame lines up with the inputs' gene order by chance."""
    ad_sc, ad_sp = sparse_adatas
    genes = ad_sc.uns["training_genes"][::-2]
    ad_map = map_cells(sparse_adatas, cv_train_genes=genes, num_epochs=10, random_state=42,
                       **MODE_ARGS[mode])
    if mode == "clusters":
        ad_sc = tgt.adata_to_cluster_expression(ad_sc, "subclass_label", add_density=True)
        tgt.annotate_gene_sparsity(ad_sc)
    want = tgt.AnnData(X=ad_map.X, obs=ad_sc[:, genes].obs.copy(),
                       var=ad_sp[:, genes].obs.copy())
    if mode == "constrained":
        want.obs["F_out"] = ad_map.obs["F_out"]
    pd.testing.assert_frame_equal(ad_map.obs, want.obs, check_exact=True)
    pd.testing.assert_frame_equal(ad_map.var, want.var, check_exact=True)
    report = ad_map.uns["train_genes_df"]
    want_report = report[["train_score"]].copy()
    want_report["sparsity_sc"] = ad_sc[:, genes].var.sparsity
    want_report["sparsity_sp"] = ad_sp[:, genes].var.sparsity
    want_report["sparsity_diff"] = want_report["sparsity_sp"] - want_report["sparsity_sc"]
    pd.testing.assert_frame_equal(report, want_report, check_exact=True)


# ---------------------------------------------------------------------------
# annotation transfer and the utilities
# ---------------------------------------------------------------------------


def test_project_cell_annotations(adatas):
    ad_map = map_cells(adatas, mode="cells", num_epochs=20, random_state=42)
    tgt.project_cell_annotations(ad_map, adatas[1], annotation="subclass_label")
    pred = adatas[1].obsm["tangram_ct_pred"]
    assert pred.shape == (adatas[1].n_obs, 4)
    assert list(pred.index) == list(adatas[1].obs.index)


def test_cell_type_mapping(adatas):
    ad_map = map_cells(adatas, mode="cells", num_epochs=20, random_state=42)
    tgt.cell_type_mapping(ad_map, cell_types_key="subclass_label")
    ct_map = ad_map.varm["ct_map"]
    assert ct_map.shape == (adatas[1].n_obs, 4)
    assert float(ct_map.min().min()) == pytest.approx(0.0, abs=1e-6)
    assert float(ct_map.max().max()) == pytest.approx(1.0, abs=1e-6)


def test_one_hot_encoding():
    df = tgt.one_hot_encoding(pd.Series(pd.Categorical(["x", "y", "x", "z"])))
    assert set(df.columns) == {"x", "y", "z"}
    assert df["x"].tolist() == [1, 0, 1, 0]


def test_get_matched_genes():
    prior, sn = ["a", "b", "c", "d"], ["b", "e", "d"]
    pi, si, genes = tgt.get_matched_genes(prior, sn)
    assert genes == ["b", "d"]
    assert pi == [1, 3]
    assert si == [0, 2]


def test_annotate_gene_sparsity():
    X = np.array([[0, 1.0], [0, 2.0], [3.0, 0]])
    ad = tgt.AnnData(X=X)
    tgt.annotate_gene_sparsity(ad)
    np.testing.assert_allclose(ad.var["sparsity"], [2 / 3, 1 / 3])
    rng = np.random.default_rng(4)
    X = rng.poisson(0.7, (40, 12)).astype(np.float32)
    ours, theirs = tgt.AnnData(X=X.copy()), tg.AnnData(X=X.copy())
    tgt.annotate_gene_sparsity(ours)
    tg.annotate_gene_sparsity(theirs)
    np.testing.assert_array_equal(ours.var["sparsity"].to_numpy(),
                                  theirs.var["sparsity"].to_numpy())


def test_eval_metric_golden():
    df_all_genes = pd.read_csv(os.path.join(DATA_DIR, "test_df.csv"), index_col=0)
    assert tgt.eval_metric(df_all_genes)[0]["auc_score"] == pytest.approx(0.750597829464878)


def test_projected_expression_device_matches_host(rng):
    """The chunked path (``backend="device"`` on the CPU) equals the host
    product, chunk edges included."""
    from tangram_tpu_torch.evaluation import projected_expression

    M = rng.random((37, 53)).astype(np.float32)
    X = rng.random((37, 11)).astype(np.float32)
    host = projected_expression(M, X, backend="host")
    device = projected_expression(M, X, backend="device", spot_chunk=16, device="cpu")
    np.testing.assert_allclose(device, host, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(host, M.T @ X, rtol=1e-6)


def test_precision_knobs_through_public_api(adatas):
    """The bf16 storage options reach the fused loop from
    map_cells_to_space and give a score close to the f32 default."""
    ad_map32 = map_cells(adatas, num_epochs=40, random_state=42)
    ad_map16 = map_cells(adatas, num_epochs=40, random_state=42, impl="fused",
                         moment_dtype="bfloat16", compute_dtype="bfloat16",
                         param_dtype="bfloat16")
    s32 = float(list(ad_map32.uns["training_history"]["main_loss"])[-1])
    s16 = float(list(ad_map16.uns["training_history"]["main_loss"])[-1])
    assert s16 == pytest.approx(s32, abs=3e-2)
    np.testing.assert_allclose(np.asarray(ad_map16.X).sum(axis=1), 1.0, rtol=1e-2)


@pytest.mark.parametrize("api", [tg, tgt], ids=["tangram_tpu", "tangram_tpu_torch"])
def test_adata_to_cluster_expression_skips_unlabeled_cells(api):
    """Cells with NaN cluster labels are left out of every aggregate (the
    reference's boolean-selection loop, ``mapping_utils.py:126-131``); the
    two packages give the same AnnData."""
    X = np.arange(20, dtype=np.float32).reshape(5, 4)
    obs = pd.DataFrame({"ct": ["a", np.nan, "b", "a", np.nan]})
    ad = api.AnnData(X=X, obs=obs, var=pd.DataFrame(index=[f"g{i}" for i in range(4)]))
    agg = api.mapping.adata_to_cluster_expression(ad, "ct", scale=False, add_density=True)
    got = {row: agg.X[i] for i, row in enumerate(agg.obs["ct"])}
    np.testing.assert_allclose(got["a"], X[[0, 3]].mean(axis=0))
    np.testing.assert_allclose(got["b"], X[2])
    dens = dict(zip(agg.obs["ct"], agg.obs["cluster_density"]))
    assert dens["a"] == pytest.approx(2 / 3)
    assert dens["b"] == pytest.approx(1 / 3)
    if api is tgt:
        ad_j = tg.AnnData(X=X, obs=obs, var=pd.DataFrame(index=[f"g{i}" for i in range(4)]))
        want = tg.mapping.adata_to_cluster_expression(ad_j, "ct", scale=False,
                                                      add_density=True)
        np.testing.assert_array_equal(np.asarray(agg.X), np.asarray(want.X))
        pd.testing.assert_frame_equal(agg.obs, want.obs)


# ---------------------------------------------------------------------------
# the init methods and the feature matrix
# ---------------------------------------------------------------------------


def test_expression_init_improves_structured_mapping():
    """``init_method="expression"`` starts near the similarity optimum on
    structured data and ends at least as high as the N(0, 1) init."""
    from tangram_tpu_torch.models.mapper import Mapper, init_logits

    rng = np.random.default_rng(7)
    n_types, g, spots_per_type = 4, 30, 6
    programs = rng.lognormal(0.0, 1.0, (n_types, g)).astype(np.float32)
    spot_types = np.repeat(np.arange(n_types), spots_per_type)
    G = (programs[spot_types] * rng.gamma(5.0, 0.2, (len(spot_types), 1))).astype(np.float32)
    cell_types = rng.integers(0, n_types, 60)
    S = (programs[cell_types] * rng.gamma(5.0, 0.2, (len(cell_types), 1))).astype(np.float32)

    _, h_expr = Mapper(S=S, G=G, init_method="expression", **CPU).train(
        num_epochs=60, learning_rate=0.1, print_each=None)
    _, h_rand = Mapper(S=S, G=G, random_state=42, **CPU).train(
        num_epochs=60, learning_rate=0.1, print_each=None)
    assert h_expr["main_loss"][0] > h_rand["main_loss"][0] + 0.05
    assert h_expr["main_loss"][-1] >= h_rand["main_loss"][-1] - 1e-3
    with pytest.raises(ValueError, match="unknown init method"):
        init_logits(4, 4, method="bogus")


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_expression_init_constrained_mode(impl):
    """M from the cosine init, F from the reference's N(0, 1) stream."""
    from tangram_tpu_torch.models.mapper import MapperConstrained

    rng = np.random.default_rng(3)
    S = (rng.poisson(2.0, (20, 10)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (12, 10)) + 0.5).astype(np.float32)
    m = MapperConstrained(S=S, G=G, d=np.full(12, 1 / 12, np.float32), target_count=12,
                          init_method="expression", impl=impl, **CPU)
    out, F, _ = m.train(num_epochs=15, learning_rate=0.1, print_each=None)
    assert np.isfinite(out).all() and np.isfinite(F).all()
    np.testing.assert_allclose(np.asarray(out).sum(1), 1.0, atol=1e-4)


@pytest.mark.parametrize("mode,extra", [
    ("cells", {}),
    ("clusters", {"cluster_label": "subclass"}),
    ("constrained", {"target_count": 12, "density_prior": "uniform"}),
])
@pytest.mark.parametrize("knobs", [
    dict(impl="reference"),
    dict(impl="fused"),
    dict(init_method="expression"),
    dict(graph_format="knn", lambda_neighborhood_g1=0.5),
], ids=["reference", "fused", "expression", "knn"])
def test_feature_interaction_matrix(mode, extra, knobs):
    """Every mode × (loop / expression init / k-NN graphs), with a cosine
    schedule: a row-stochastic mapping and a finite history."""
    rng = np.random.default_rng(5)
    c, s, g = 24, 16, 12
    genes = [f"g{i}" for i in range(g)]
    ad_sc = tgt.AnnData(X=(rng.poisson(2.0, (c, g)) + 0.5).astype(np.float32),
                        obs=pd.DataFrame({"subclass": rng.choice(["a", "b"], c)},
                                         index=[f"c{i}" for i in range(c)]),
                        var=pd.DataFrame(index=genes))
    ad_sp = tgt.AnnData(X=(rng.poisson(3.0, (s, g)) + 0.5).astype(np.float32),
                        var=pd.DataFrame(index=genes))
    ad_sp.obsm["spatial"] = rng.random((s, 2)) * 10
    tgt.pp_adatas(ad_sc, ad_sp)
    ad_map = tgt.map_cells_to_space(ad_sc, ad_sp, mode=mode, num_epochs=20,
                                    learning_rate=tgt.cosine_lr(0.3, 20, end=0.03),
                                    random_state=1, verbose=False, **CPU, **extra, **knobs)
    np.testing.assert_allclose(np.asarray(ad_map.X).sum(1), 1.0, atol=1e-4)
    hist = np.asarray(ad_map.uns["training_history"]["main_loss"])
    assert np.isfinite(hist).all() and len(hist) == 20


def test_version_consistency():
    """pyproject and the port report the same version."""
    import re

    text = open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml")).read()
    assert tgt.__version__ == re.search(r'^version = "([^"]+)"', text, re.M).group(1)


# ---------------------------------------------------------------------------
# tests/test_datasets.py on the port's synthetic pair
# ---------------------------------------------------------------------------


def test_fixture_statistics():
    from tangram_tpu_torch.datasets import synthetic_mapping_pair

    ad_sc, ad_sp = synthetic_mapping_pair(n_cells=2000, n_spots=500, n_genes=200,
                                          random_state=0)
    X_sc, X_sp = np.asarray(ad_sc.X), np.asarray(ad_sp.X)
    assert X_sc.shape == (2000, 200) and X_sp.shape == (500, 200)
    assert (X_sc >= 0).all() and (X_sc == np.round(X_sc)).all()
    sparsity = 1 - (X_sc != 0).mean(axis=0)
    assert 0.5 < sparsity.mean() < 0.9
    assert np.percentile(sparsity, 90) - np.percentile(sparsity, 10) > 0.3
    expressed = X_sc.mean(axis=0) > 0.5
    vm = X_sc[:, expressed].var(axis=0) / X_sc[:, expressed].mean(axis=0)
    assert np.median(vm) > 1.5
    fr = ad_sp.uns["true_type_fractions"].to_numpy()
    np.testing.assert_allclose(fr.sum(axis=1), 1.0, rtol=1e-6)
    coords = ad_sp.obsm["spatial"]
    order = np.argsort(coords[:, 0] + 1000 * coords[:, 1])
    adjacent = np.abs(np.diff(fr[order], axis=0)).mean()
    shuffled = np.abs(np.diff(fr[np.random.default_rng(0).permutation(500)], axis=0)).mean()
    assert adjacent < shuffled * 0.8


def test_mapping_recovers_spatial_signal():
    """The generated problem is learnable: the mapping transfers cell-type
    annotations that correlate with the true type fractions."""
    from tangram_tpu_torch.datasets import synthetic_mapping_pair

    ad_sc, ad_sp = synthetic_mapping_pair(n_cells=400, n_spots=144, n_genes=60, n_types=6,
                                          random_state=7)
    tgt.pp_adatas(ad_sc, ad_sp)
    ad_map = tgt.map_cells_to_space(ad_sc, ad_sp, num_epochs=300, random_state=42,
                                    verbose=False, density_prior="uniform", **CPU)
    tgt.project_cell_annotations(ad_map, ad_sp, annotation="subclass_label")
    pred, truth = ad_sp.obsm["tangram_ct_pred"], ad_sp.uns["true_type_fractions"]
    corrs = [np.corrcoef(pred[t], truth[t])[0, 1] for t in truth.columns]
    assert np.median(corrs) > 0.3
    assert np.mean(corrs) > 0.35
    df = ad_map.uns["train_genes_df"]
    assert 0.5 < df["train_score"].mean() <= 1.0
    assert df["sparsity_sc"].max() - df["sparsity_sc"].min() > 0.2
