"""Functional recovery through the port: ``map_cells_to_space``,
``project_cell_annotations`` (``deconv.py``), ``project_genes`` and
``compare_spatial_geneexp`` (``evaluation.py``) must solve the placement
problem, as ``tests/test_recovery.py`` demands of the JAX package, and give
the JAX package's answers on the same fixture and seed.

The fixture is ``tests/test_recovery.py``'s, built with the port's
``AnnData``: 300 cells × 150 spots × 120 genes, 5 cell types with
lognormal expression programs, a spatially smooth composition per spot
(each type a Gaussian bump around its own center), Poisson counts, from
``default_rng(1)``. Every fit runs 400 epochs in cells mode with the
``rna_count_based`` prior and ``random_state=0``, which leaves numpy's
global stream as it is (the reference's ``if random_state:``, ROADMAP
queue C): each fit here seeds that stream with 0 first, so both packages
start from the same logits.

Thresholds, JAX's: per-type correlation of the predicted annotation with
the true composition, min > 0.6 and mean > 0.8; mean held-out score
> 0.8 (every 10th training gene left out, in the order of the genes of
the single-cell data). Agreement with JAX: the
per-spot annotation and the held-out scores within ``SPREAD`` = 4 times a
witness measured here, the larger of the two packages' distance from
themselves with the 300 cells trained in reverse order, each from its
own start (max-abs over the annotation table, and over the scores).
"""

import contextlib
import importlib
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

PACKAGES = ("tangram_tpu", "tangram_tpu_torch")
N_TYPES, N_GENES, N_CELLS, N_SPOTS = 5, 120, 300, 150
EPOCHS = 400
SPREAD = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ground_truth(api):
    """``tests/test_recovery.py``'s fixture through ``api``'s AnnData."""
    rng = np.random.default_rng(1)
    programs = rng.lognormal(0.0, 1.2, (N_TYPES, N_GENES))
    cell_types = rng.integers(0, N_TYPES, N_CELLS)
    S = rng.poisson(programs[cell_types] * 2.0).astype(np.float32)
    coords = rng.random((N_SPOTS, 2))
    centers = rng.random((N_TYPES, 2))
    dist2 = ((coords[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    composition = np.exp(-dist2 / 0.05)
    composition /= composition.sum(1, keepdims=True)
    G = rng.poisson(composition @ programs * 6.0).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(N_GENES)])
    ad_sc = api.AnnData(
        X=S,
        obs=pd.DataFrame({"cell_type": pd.Categorical([f"t{t}" for t in cell_types])},
                         index=[f"c{i}" for i in range(N_CELLS)]),
        var=genes.copy())
    ad_sp = api.AnnData(X=G, obs=pd.DataFrame(index=[f"s{i}" for i in range(N_SPOTS)]),
                        var=genes.copy())
    ad_sp.obsm["spatial"] = coords
    api.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp, composition


def cells_in_order(module, perm):
    """``module.Mapper`` (the JAX package's or the port's) with the cells in
    the order ``perm`` (the rows of S and of the one-hot cell types), each
    starting from the logits the unpermuted run gives it."""
    real = module.Mapper

    def build(**kw):
        ct = kw.get("ct_encode")
        mapper = real(**dict(kw, S=kw["S"][perm], ct_encode=None if ct is None else ct[perm]))
        mapper.M = mapper.M[torch.as_tensor(perm) if torch.is_tensor(mapper.M) else perm]
        return mapper

    return mock.patch.object(module, "Mapper", build)


def fit(package, perm=None, held_out=False):
    """(the annotation table (spots × types), the held-out genes' scores or
    None) of ``package``'s mapping of the fixture."""
    api = importlib.import_module(package)
    ad_sc, ad_sp, _ = ground_truth(api)
    kw = dict(device="cpu") if package == "tangram_tpu_torch" else {}
    # the JAX package keeps the training genes in set order, which changes
    # from one process to the next: hold out by the single-cell var order
    training = set(ad_sc.uns["training_genes"])
    genes = [g for g in ad_sc.var_names if g in training]
    held = genes[::10]
    if held_out:
        kw["cv_train_genes"] = [g for g in genes if g not in held]
    module = importlib.import_module(f"{package}.mapping")
    np.random.seed(0)
    with cells_in_order(module, perm) if perm is not None else contextlib.nullcontext():
        ad_map = api.map_cells_to_space(ad_sc, ad_sp, mode="cells",
                                        density_prior="rna_count_based", num_epochs=EPOCHS,
                                        random_state=0, verbose=False, **kw)
    if perm is not None:
        ad_map.X = np.asarray(ad_map.X)[np.argsort(perm)]
    if held_out:
        ad_ge = api.project_genes(ad_map, ad_sc)
        df = api.compare_spatial_geneexp(ad_ge, ad_sp, ad_sc)
        return None, df.loc[held, "score"].to_numpy(np.float64)
    api.project_cell_annotations(ad_map, ad_sp, annotation="cell_type")
    pred = ad_sp.obsm["tangram_ct_pred"][[f"t{t}" for t in range(N_TYPES)]]
    return pred.to_numpy(np.float64), None


@pytest.fixture(scope="module")
def runs():
    """Every fit, by (package, permuted, held out)."""
    perm = np.arange(N_CELLS)[::-1].copy()
    return {(pkg, permuted, held): fit(pkg, perm if permuted else None, held)
            for pkg in PACKAGES for permuted in (False, True) for held in (False, True)}


def composition():
    return ground_truth(importlib.import_module("tangram_tpu_torch"))[2]


def test_mapping_recovers_spot_composition(runs):
    pred, _ = runs["tangram_tpu_torch", False, False]
    truth = composition()
    corrs = [np.corrcoef(pred[:, t], truth[:, t])[0, 1] for t in range(N_TYPES)]
    assert min(corrs) > 0.6, corrs
    assert float(np.mean(corrs)) > 0.8, corrs


def test_held_out_genes_predicted(runs):
    _, scores = runs["tangram_tpu_torch", False, True]
    assert len(scores) == len(range(0, N_GENES, 10))
    assert float(scores.mean()) > 0.8, scores


@pytest.mark.parametrize("held", [False, True], ids=["annotation", "held-out scores"])
def test_recovery_matches_jax_within_spread(runs, held):
    """The port's annotation table and held-out scores against JAX's, within
    SPREAD times the larger of each package's distance from itself with its
    cells in reverse order."""
    part = 1 if held else 0
    got = runs["tangram_tpu_torch", False, held][part]
    want = runs["tangram_tpu", False, held][part]
    witness = max(np.abs(runs[pkg, True, held][part] - runs[pkg, False, held][part]).max()
                  for pkg in PACKAGES)
    assert witness > 0
    assert np.abs(got - want).max() <= SPREAD * witness
