"""The PyTorch port's AnnData shell against the JAX package's.

``map_cells_to_space`` in cells and clusters modes on a small
``synthetic_mapping_pair``: the JAX package with ``impl="pallas"`` (its
Pallas kernels in interpret mode) against the port with ``device="cpu"``,
both with its default loop (the materialized reference loop on the CPU) and
with the fused loop. Then the port alone against the 9 pinned torch-reference
goldens of ``tests/data/golden_mapping.json`` with ``tests/test_golden.py``'s
recipe and tolerances (3 decimals on X[0, 0], atol 1e-3).

Tolerances of the JAX comparison: loss histories rtol 3e-4 / atol 3e-5 and
logits-level agreement of the mapping (rtol 3e-3 on the probabilities,
which is exp of an M atol 3e-3), as ``tests/test_fused_step.py`` allows
for 25-100 Adam epochs; the train-gene scores, cosines of those mappings,
to atol 1e-4; the sparsity columns exactly. With ``optimizer="adafactor"``
the losses are held to ``tests/test_adafactor.py:177-191``'s rtol/atol
5e-3 and the mapping to rtol 1e-2 (exp of the logits' atol 5e-3): the
Adafactor update is linear in the gradient and passes f32 rounding
differences on undamped.
"""

import json

import numpy as np
import pandas as pd
import pytest

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu.datasets import synthetic_mapping_pair as jax_pair
from tangram_tpu_torch.datasets import synthetic_mapping_pair
from tangram_tpu_torch.spatial import spatial_neighbors

from test_golden import GOLDEN_PATH, PARAMS

EPOCHS = 60


def pairs(shape=(90, 70, 24), n_types=5):
    kw = dict(n_types=n_types, random_state=4)
    ad_sc_j, ad_sp_j = jax_pair(*shape, **kw)
    ad_sc_t, ad_sp_t = synthetic_mapping_pair(*shape, **kw)
    tg.pp_adatas(ad_sc_j, ad_sp_j)
    tgt.pp_adatas(ad_sc_t, ad_sp_t)
    return (ad_sc_j, ad_sp_j), (ad_sc_t, ad_sp_t)


def test_synthetic_pair_and_pp_adatas_match_jax():
    (sc_j, sp_j), (sc_t, sp_t) = pairs()
    np.testing.assert_array_equal(sc_t.X, sc_j.X)
    np.testing.assert_array_equal(sp_t.X, sp_j.X)
    assert sorted(sc_t.uns["training_genes"]) == sorted(sc_j.uns["training_genes"])
    assert sc_t.uns["overlap_genes"] == sc_j.uns["overlap_genes"]
    for key in ("uniform_density", "rna_count_based_density"):
        np.testing.assert_array_equal(sp_t.obs[key], sp_j.obs[key])
    pd.testing.assert_frame_equal(sp_t.uns["true_type_fractions"],
                                  sp_j.uns["true_type_fractions"])
    # hex lattice: on border spots several candidates tie at the 6th-nearest
    # distance and the two k-d trees may keep different ones, so compare
    # each spot's sorted neighbor distances, which ties leave unchanged
    d_j = sp_j.obsp["spatial_distances"].tolil().data
    d_t = sp_t.obsp["spatial_distances"].tolil().data
    for row_j, row_t in zip(d_j, d_t):
        np.testing.assert_allclose(sorted(row_t), sorted(row_j), rtol=1e-12)


@pytest.mark.parametrize("coord_type,extra", [
    ("generic", {}),
    ("generic", {"radius": 0.3}),
    ("generic", {"percentile": 80.0}),
    ("delaunay", {}),
    ("grid", {"n_rings": 2}),
])
def test_spatial_neighbors_matches_jax(coord_type, extra):
    """Random coordinates (no distance ties) except for the grid case,
    which uses a uniform square lattice where both keep the same ring."""
    rng = np.random.default_rng(8)
    if coord_type == "grid":
        xy = np.stack(np.meshgrid(np.arange(9.0), np.arange(7.0)), -1).reshape(-1, 2)
    else:
        xy = rng.random((120, 2))
    ads = []
    for AnnData in (tg.AnnData, tgt.AnnData):
        ad = AnnData(X=np.ones((len(xy), 2), np.float32))
        ad.obsm["spatial"] = xy
        ads.append(ad)
    tg.spatial_neighbors(ads[0], coord_type=coord_type, **extra)
    spatial_neighbors(ads[1], coord_type=coord_type, **extra)
    for key in ("spatial_connectivities", "spatial_distances"):
        want, got = ads[0].obsp[key], ads[1].obsp[key]
        assert (want != got).nnz == 0 or np.allclose(want.toarray(), got.toarray())


@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("mode", ["cells", "clusters"])
def test_map_cells_to_space_matches_jax(mode, impl):
    (sc_j, sp_j), (sc_t, sp_t) = pairs()
    kw = dict(mode=mode, num_epochs=EPOCHS, random_state=7, verbose=False,
              density_prior="rna_count_based")
    if mode == "clusters":
        kw["cluster_label"] = "subclass_label"
    map_j = tg.map_cells_to_space(sc_j, sp_j, impl="pallas", **kw)
    map_t = tgt.map_cells_to_space(sc_t, sp_t, device="cpu", impl=impl, **kw)

    assert map_t.X.shape == map_j.X.shape
    np.testing.assert_allclose(map_t.X, map_j.X, rtol=3e-3, atol=1e-7)
    np.testing.assert_allclose(map_t.X.sum(axis=1), 1.0, atol=1e-5)
    assert map_t.obs.index.equals(map_j.obs.index)
    assert map_t.var.index.equals(map_j.var.index)

    h_j, h_t = map_j.uns["training_history"], map_t.uns["training_history"]
    assert set(h_t) == set(h_j)
    for key in ("total_loss", "main_loss", "kl_reg"):
        np.testing.assert_allclose(h_t[key], h_j[key], rtol=3e-4, atol=3e-5)

    df_j = map_j.uns["train_genes_df"]
    df_t = map_t.uns["train_genes_df"].loc[df_j.index]
    assert list(df_t.columns) == list(df_j.columns)
    np.testing.assert_allclose(df_t["train_score"], df_j["train_score"], atol=1e-4)
    for col in ("sparsity_sc", "sparsity_sp", "sparsity_diff"):
        np.testing.assert_array_equal(df_t[col], df_j[col])

    ge_j = tg.project_genes(map_j, sc_j, cluster_label=kw.get("cluster_label"))
    ge_t = tgt.project_genes(map_t, sc_t, cluster_label=kw.get("cluster_label"))
    np.testing.assert_allclose(ge_t.X, ge_j.X, rtol=3e-3, atol=1e-5)
    cmp_j = tg.compare_spatial_geneexp(ge_j, sp_j, sc_j)
    cmp_t = tgt.compare_spatial_geneexp(ge_t, sp_t, sc_t).loc[cmp_j.index]
    assert list(cmp_t.columns) == list(cmp_j.columns)
    np.testing.assert_allclose(cmp_t["score"], cmp_j["score"], atol=1e-4)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_map_cells_to_space_constrained_matches_jax(optimizer):
    """Constrained mode through the public entry point: the mapping, the
    filter ``obs['F_out']``, the history and the gene report against the
    JAX package's, on the port's fused constrained step (Adam) or its
    autograd loop through MapperCore (Adafactor), both on the kernels'
    twins; Adam or Adafactor tolerances. Adafactor runs 8 epochs, not 30:
    on this problem it amplifies rounding so fast that the JAX package's own
    XLA and Pallas paths part by more than these tolerances within 30
    epochs."""
    (sc_j, sp_j), (sc_t, sp_t) = pairs()
    adafactor = optimizer == "adafactor"
    kw = dict(mode="constrained", target_count=50, num_epochs=8 if adafactor else 30,
              random_state=7, verbose=False, density_prior="rna_count_based",
              optimizer=optimizer)
    map_j = tg.map_cells_to_space(sc_j, sp_j, impl="pallas", **kw)
    map_t = tgt.map_cells_to_space(sc_t, sp_t, device="cpu", impl="fused", **kw)

    tol = 5e-3 if adafactor else 3e-4
    np.testing.assert_allclose(map_t.X, map_j.X, rtol=1e-2 if adafactor else 3e-3,
                               atol=1e-7)
    np.testing.assert_allclose(map_t.X.sum(axis=1), 1.0, atol=1e-5)
    F_t = map_t.obs["F_out"].to_numpy()
    assert ((F_t > 0) & (F_t < 1)).all()
    np.testing.assert_allclose(F_t, map_j.obs["F_out"].to_numpy(), atol=tol)
    h_j, h_t = map_j.uns["training_history"], map_t.uns["training_history"]
    assert set(h_t) == set(h_j)
    for key in ("total_loss", "main_loss", "kl_reg", "count_reg", "lambda_f_reg"):
        np.testing.assert_allclose(h_t[key], h_j[key], rtol=tol, atol=tol / 10)
    df_j = map_j.uns["train_genes_df"]
    df_t = map_t.uns["train_genes_df"].loc[df_j.index]
    np.testing.assert_allclose(df_t["train_score"], df_j["train_score"],
                               atol=1e-3 if adafactor else 1e-4)


@pytest.mark.parametrize("mode,options", [
    ("cells", dict(optimizer="adafactor", lambda_l1=1e-3, lambda_l2=1e-3)),
    ("clusters", dict(optimizer="adafactor")),
    ("cells", dict(lambda_l1=1e-3, lambda_l2=2e-3)),
    ("clusters", dict(lambda_l1=1e-3)),
])
def test_map_cells_to_space_adafactor_and_norms_match_jax(mode, options):
    """The options of this slice through the public entry point, on the
    port's fused loop (the kernels' twins on the CPU): cells mode has more
    cells than spots and clusters mode fewer, so both orientations of the
    Adafactor statistics run."""
    (sc_j, sp_j), (sc_t, sp_t) = pairs()
    kw = dict(mode=mode, num_epochs=30, random_state=7, verbose=False,
              density_prior="rna_count_based", **options)
    if mode == "clusters":
        kw["cluster_label"] = "subclass_label"
    map_j = tg.map_cells_to_space(sc_j, sp_j, impl="pallas", **kw)
    map_t = tgt.map_cells_to_space(sc_t, sp_t, device="cpu", impl="fused", **kw)

    adafactor = options.get("optimizer") == "adafactor"
    tol = 5e-3 if adafactor else 3e-4
    np.testing.assert_allclose(map_t.X, map_j.X, rtol=1e-2 if adafactor else 3e-3,
                               atol=1e-7)
    np.testing.assert_allclose(map_t.X.sum(axis=1), 1.0, atol=1e-5)
    h_j, h_t = map_j.uns["training_history"], map_t.uns["training_history"]
    assert set(h_t) == set(h_j)
    for key in ("total_loss", "main_loss", "kl_reg"):
        np.testing.assert_allclose(h_t[key], h_j[key], rtol=tol, atol=tol / 10)
    df_j = map_j.uns["train_genes_df"]
    df_t = map_t.uns["train_genes_df"].loc[df_j.index]
    np.testing.assert_allclose(df_t["train_score"], df_j["train_score"],
                               atol=1e-3 if adafactor else 1e-4)


def golden_fixture():
    """``tests/test_golden.py::build_fixture`` rebuilt with the port's own
    AnnData and pp_adatas (the same seeded arrays)."""
    rng = np.random.default_rng(2026)
    n_cells, n_spots, n_genes = 60, 40, 35
    S = (rng.negative_binomial(2, 0.3, (n_cells, n_genes)) + 0).astype(np.float32)
    G = (rng.negative_binomial(2, 0.3, (n_spots, n_genes)) + 0).astype(np.float32)
    S[0] += 1
    G[0] += 1
    labels = pd.Categorical(
        np.asarray(["exc", "inh", "glia", "endo"])[np.arange(n_cells) % 4]
    )
    ad_sc = tgt.AnnData(
        X=S,
        obs=pd.DataFrame({"subclass_label": labels},
                         index=[f"c{i}" for i in range(n_cells)]),
        var=pd.DataFrame(index=[f"gene{i}" for i in range(n_genes)]),
    )
    ad_sp = tgt.AnnData(
        X=G,
        obs=pd.DataFrame(index=[f"s{i}" for i in range(n_spots)]),
        var=pd.DataFrame(index=[f"gene{i}" for i in range(n_genes)]),
    )
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


@pytest.fixture(scope="module")
def golden_pair():
    return golden_fixture()


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDEN_PATH) as f:
        return {tuple(g["params"]): g for g in json.load(f)}


@pytest.mark.parametrize("lambda_g1, lambda_g2, lambda_d, prior, scale", PARAMS)
def test_torch_golden_mapping_values(golden_pair, goldens, lambda_g1, lambda_g2,
                                     lambda_d, prior, scale):
    ad_sc, ad_sp = golden_pair
    gold = goldens[(lambda_g1, lambda_g2, lambda_d, prior, scale)]
    ad_map = tgt.map_cells_to_space(
        adata_sc=ad_sc, adata_sp=ad_sp, mode="clusters",
        cluster_label="subclass_label", lambda_g1=lambda_g1,
        lambda_g2=lambda_g2, lambda_d=lambda_d, density_prior=prior,
        scale=scale, random_state=42, num_epochs=500, verbose=False,
        device="cpu",
    )
    assert round(float(ad_map.X[0, 0]), 3) == round(gold["x00"], 3)
    np.testing.assert_allclose(np.asarray(ad_map.X[0, :3], dtype=np.float64),
                               np.asarray(gold["row0_head"], dtype=np.float64),
                               atol=1e-3)
    final = float(ad_map.uns["training_history"]["main_loss"][-1])
    assert final == pytest.approx(gold["final_main_loss"], abs=1e-3)


@pytest.mark.parametrize("kwargs,match", [
    (dict(lambda_g1=0), "lambda_g1 cannot be 0."),
    (dict(density_prior="bogus"), "Invalid input for density_prior."),
    (dict(lambda_d=1, density_prior=None),
     "When lambda_d is set, please define the density_prior."),
    (dict(mode="nope"), 'Argument "mode" must be "cells", "clusters" or "constrained'),
    (dict(mode="clusters"), "A cluster_label must be specified if mode is 'clusters'."),
    (dict(mode="constrained", target_count=10, early_stop_tol=1e-3),
     "early_stop_tol is not supported in constrained mode (the count/filter "
     "penalties keep moving the score target)"),
])
def test_mapping_argument_errors_match_jax(golden_pair, kwargs, match):
    ad_sc, ad_sp = golden_pair
    for api in (tg, tgt):
        with pytest.raises(ValueError) as err:
            api.map_cells_to_space(ad_sc, ad_sp, num_epochs=1, verbose=False, **kwargs)
        assert str(err.value) == match


def test_missing_pp_adatas_raises():
    ad = tgt.AnnData(X=np.ones((3, 2), np.float32))
    with pytest.raises(ValueError, match="Run `pp_adatas\\(\\)`"):
        tgt.map_cells_to_space(ad, ad, device="cpu", num_epochs=1)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mode="constrained", target_count=10, mesh=object()), "A11"),
    (dict(mesh=object()), "A11"),
])
def test_unported_options_raise_naming_the_roadmap(golden_pair, kwargs, item):
    ad_sc, ad_sp = golden_pair
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue {item}"):
        tgt.map_cells_to_space(ad_sc, ad_sp, device="cpu", num_epochs=2,
                               verbose=False, **kwargs)
