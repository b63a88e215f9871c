"""Cross-validation and ``eval_metric`` of the PyTorch port against the JAX
package's, on the CPU (``device="cpu"``), on ``tests/test_cross_val.py``'s
30 cells × 20 spots × 12 genes fixture.

Tolerances. ``cv_data_gen`` yields sklearn's folds in sklearn's order:
exactly. ``cross_val`` against JAX's batched ``cross_val`` on the same
inputs and seed takes JAX's own batched-vs-loop bounds
(``tests/test_cross_val.py:37-59``): the train score within 2e-3, the test
score within 2e-2 (5e-2 constrained), and the LOO per-gene held-out scores
within 2e-2 after 250 epochs (``tests/test_cross_val.py:61-83``); the
same seed starts every fold from JAX's numpy init. A resumed sweep
equals the unbroken one exactly, as does ``fold_batch_size="auto"`` an
explicit size that trains the same batches. ``eval_metric`` meets the
golden 0.750597829464878 (``tests/test_api.py:280-284``) to pytest's
default 1e-6 relative, and JAX's (sklearn's ``auc``) to 1e-12 on random
tables.
"""

import inspect
import os

import numpy as np
import pandas as pd
import pytest
import torch

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu_torch import evaluation as tev
from tangram_tpu_torch import utils as tutils

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fixtures are tiny: one intra-op thread keeps these tests from
    contending for every core with the suite's other workers (the loop
    path ran 8× slower with the default threads under such load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data")
MODES = {
    "cells": {},
    "clusters": {"cluster_label": "subclass_label"},
    "constrained": {"target_count": 15, "density_prior": "uniform"},
}


def fixture_arrays(seed=0, n_cells=30, n_spots=20, n_genes=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (3, n_genes)) * 2
    labels = rng.integers(0, 3, n_cells)
    S = rng.poisson(np.exp(centers[labels] * 0.5) + 0.5).astype(np.float32)
    G = rng.poisson(
        np.exp(centers[rng.integers(0, 3, n_spots)] * 0.5) + 0.5
    ).astype(np.float32)
    return S, G, labels


def adatas(api, seed=0):
    """``tests/test_cross_val.py``'s fixture, through ``api``'s AnnData."""
    S, G, labels = fixture_arrays(seed)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(S.shape[1])])
    ad_sc = api.AnnData(
        X=S,
        obs=pd.DataFrame(
            {"subclass_label": pd.Categorical([f"c{lab}" for lab in labels])},
            index=[f"cell{i}" for i in range(S.shape[0])],
        ),
        var=genes.copy(),
    )
    ad_sp = api.AnnData(X=G, obs=pd.DataFrame(index=[f"s{i}" for i in range(G.shape[0])]),
                        var=genes.copy())
    api.pp_adatas(ad_sc, ad_sp)
    # one fold composition for both packages: cv_data_gen folds the training
    # genes in their order, which the port's pp_adatas takes as requested and
    # the JAX package's as a set iterates (it moves with PYTHONHASHSEED)
    for ad in (ad_sc, ad_sp):
        ad.uns["training_genes"] = sorted(ad.uns["training_genes"])
    return ad_sc, ad_sp


def gene_pair(api, n_genes):
    genes = [f"gene{i}" for i in range(n_genes)]
    ad = api.AnnData(X=np.ones((3, n_genes), np.float32), var=pd.DataFrame(index=genes))
    ad.uns["training_genes"] = genes
    return ad, ad


# ---------------------------------------------------------------------------
# cv_data_gen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_genes", [12, 23, 249])
@pytest.mark.parametrize("cv_mode", ["loo", "10fold"])
def test_cv_data_gen_matches_jax(n_genes, cv_mode):
    got = list(tgt.cv_data_gen(*gene_pair(tgt, n_genes), cv_mode))
    want = list(tg.cv_data_gen(*gene_pair(tg, n_genes), cv_mode))
    assert got == want
    assert len(got) == (n_genes if cv_mode == "loo" else 10)


@pytest.mark.parametrize("n_genes,cv_mode", [(5, "10fold"), (1, "loo"), (12, "bogus")])
def test_cv_data_gen_errors_match_jax(n_genes, cv_mode):
    messages = []
    for api in (tgt, tg):
        with pytest.raises(ValueError) as err:
            list(api.cv_data_gen(*gene_pair(api, n_genes), cv_mode))
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    ad_a, _ = gene_pair(tgt, 12)
    ad_b, _ = gene_pair(tgt, 12)
    ad_b.uns["training_genes"] = ad_b.uns["training_genes"][::-1]
    with pytest.raises(ValueError, match="Unmatched training_genes"):
        list(tgt.cv_data_gen(ad_a, ad_b))


# ---------------------------------------------------------------------------
# cross_val against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cv():
    """JAX's batched 10-fold results per mode, computed once."""
    out = {}
    for mode, extra in MODES.items():
        out[mode] = tg.cross_val(*adatas(tg), mode=mode, cv_mode="10fold", num_epochs=40,
                                 random_state=42, verbose=False, **extra)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("batched", [True, False])
def test_cross_val_matches_jax(jax_cv, mode, batched):
    got = tgt.cross_val(*adatas(tgt), mode=mode, cv_mode="10fold", num_epochs=40,
                        random_state=42, verbose=False, device="cpu", batched=batched,
                        **MODES[mode])
    want = jax_cv[mode]
    assert set(got) == set(want)
    assert got["avg_train_score"] == pytest.approx(want["avg_train_score"], abs=2e-3)
    tol = 5e-2 if mode == "constrained" else 2e-2
    assert got["avg_test_score"] == pytest.approx(want["avg_test_score"], abs=tol)


def test_loo_per_gene_matches_jax():
    """Per-gene LOO held-out scores after 250 epochs: the batched and loop
    paths against JAX's batched path (the wrong softmax axis cost −0.078
    per gene), with the LOO prediction AnnData and test-gene frame."""
    kw = dict(mode="clusters", cluster_label="subclass_label", cv_mode="loo",
              num_epochs=250, random_state=42, verbose=False, return_gene_pred=True)
    _, ge_j, df_j = tg.cross_val(*adatas(tg), **kw)
    for batched in (True, False):
        _, ge_t, df_t = tgt.cross_val(*adatas(tgt), device="cpu", batched=batched, **kw)
        np.testing.assert_allclose(df_t["score"].sort_index().to_numpy(),
                                   df_j["score"].sort_index().to_numpy(), atol=2e-2)
        assert ge_t.shape == ge_j.shape
        assert list(ge_t.var.index) == list(ge_j.var.index)
        assert (df_t["is_training"] == False).all()  # noqa: E712
        if batched:
            assert list(df_t.columns) == list(df_j.columns)
            np.testing.assert_allclose(np.asarray(ge_t.X), np.asarray(ge_j.X),
                                       rtol=2e-2, atol=1e-3)


def test_cross_val_with_lr_schedule_matches_jax():
    lrs = tgt.cosine_lr(peak=0.4, num_epochs=30, end=0.05)
    kw = dict(mode="cells", cv_mode="10fold", num_epochs=30, random_state=42,
              verbose=False, learning_rate=lrs)
    want = tg.cross_val(*adatas(tg), **kw)
    got = tgt.cross_val(*adatas(tgt), device="cpu", **kw)
    assert got["avg_train_score"] == pytest.approx(want["avg_train_score"], abs=2e-3)
    assert got["avg_test_score"] == pytest.approx(want["avg_test_score"], abs=2e-2)


def test_cross_val_resume(tmp_path):
    """resume_path journals each fold batch: a sweep cut after its first
    batch resumes there and reproduces the unbroken result exactly, LOO
    predictions included; a journal of another sweep and the loop path are
    refused, as in JAX (``tests/test_cross_val.py:152-197``)."""
    ad_sc, ad_sp = adatas(tgt)
    kwargs = dict(mode="cells", cv_mode="loo", num_epochs=15, random_state=3,
                  verbose=False, fold_batch_size=4, return_gene_pred=True, device="cpu")
    base, base_ge, base_df = tgt.cross_val(ad_sc, ad_sp, **kwargs)

    path = str(tmp_path / "cv.jsonl")
    full, full_ge, _ = tgt.cross_val(ad_sc, ad_sp, resume_path=path, **kwargs)
    assert full == base
    np.testing.assert_array_equal(np.asarray(full_ge.X), np.asarray(base_ge.X))

    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:5]) + "\n")
    resumed, res_ge, res_df = tgt.cross_val(ad_sc, ad_sp, resume_path=path, **kwargs)
    assert resumed == base
    np.testing.assert_array_equal(np.asarray(res_ge.X), np.asarray(base_ge.X))
    pd.testing.assert_frame_equal(res_df, base_df)

    again, again_ge, _ = tgt.cross_val(ad_sc, ad_sp, resume_path=path, **kwargs)
    assert again == base
    np.testing.assert_array_equal(np.asarray(again_ge.X), np.asarray(base_ge.X))

    with pytest.raises(ValueError, match="different sweep"):
        tgt.cross_val(ad_sc, ad_sp, resume_path=path, **{**kwargs, "random_state": 4})
    with pytest.raises(ValueError, match="batched"):
        tgt.cross_val(ad_sc, ad_sp, resume_path=path, batched=False, **kwargs)


def test_fold_batch_auto_sizing(monkeypatch):
    """``"auto"`` divides the memory budget by the port's bytes per fold,
    capped at 256: a small budget gives batch 1, the CPU's 2e9 the cap;
    either way the result equals an explicit batch size's."""
    ad_sc, ad_sp = adatas(tgt)
    kw = dict(mode="cells", cv_mode="10fold", num_epochs=20, random_state=5,
              verbose=False, device="cpu")
    per_fold = tev._fold_bytes(30, 20, 12)
    assert per_fold == 40 * 30 * 20 + 24 * 20 * 12 + 16 * 30 * 12
    assert tev.auto_fold_batch_size(30, 20, 12, "cpu") == 256
    assert tutils.device_memory_budget("cpu") == 2e9
    base = tgt.cross_val(ad_sc, ad_sp, fold_batch_size=10, **kw)
    assert tgt.cross_val(ad_sc, ad_sp, fold_batch_size="auto", **kw) == base

    monkeypatch.setattr(tutils, "device_memory_budget", lambda device: per_fold + 1)
    assert tev.auto_fold_batch_size(30, 20, 12, "cpu") == 1
    one = tgt.cross_val(ad_sc, ad_sp, fold_batch_size=1, **kw)
    assert tgt.cross_val(ad_sc, ad_sp, fold_batch_size="auto", **kw) == one
    assert one["avg_test_score"] == pytest.approx(base["avg_test_score"], abs=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mode="cells", lambda_d=1, density_prior=None), "density_prior"),
    (dict(mode="cells", lambda_d=1, density_prior="rna_count"),
     "Invalid input for density_prior"),
    (dict(mode="cells", lambda_g1=0), "lambda_g1 cannot be 0"),
    (dict(mode="nope"), 'Argument "mode" must be'),
    (dict(mode="constrained", target_count=None), "target_count"),
])
def test_cross_val_argument_errors_match_jax(kwargs, match):
    """Both port paths reject what JAX's batched path rejects, with its
    message, before any fold trains."""
    want = None
    with pytest.raises(ValueError, match=match) as err:
        tg.cross_val(*adatas(tg), num_epochs=2, verbose=False, cv_mode="10fold",
                     batched=True, **kwargs)
    want = str(err.value)
    for batched in (True, False):
        with pytest.raises(ValueError) as err:
            tgt.cross_val(*adatas(tgt), num_epochs=2, verbose=False, cv_mode="10fold",
                          batched=batched, device="cpu", **kwargs)
        assert str(err.value) == want


def test_cross_val_device_and_mesh():
    """A mesh that is no DeviceMesh is refused as the mapper refuses it
    (``tests/test_torch_population_mesh.py`` runs the meshes); the card is
    the default device, and without one neither path runs."""
    ad_sc, ad_sp = adatas(tgt)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tgt.cross_val(ad_sc, ad_sp, mode="cells", device="cpu", mesh=object())
    if not torch.cuda.is_available():
        for batched in (True, False):
            with pytest.raises(RuntimeError, match="CUDA"):
                tgt.cross_val(ad_sc, ad_sp, mode="cells", num_epochs=1, batched=batched)


def test_cv_fold_scores_softmax_over_spots():
    """The batched scorer normalizes each fold's rows over spots (the last
    axis): its scores equal a per-fold projection's cosines."""
    rng = np.random.default_rng(1)
    M = torch.from_numpy(rng.normal(0, 1, (3, 5, 7)).astype(np.float32))
    S = torch.from_numpy(rng.random((5, 4)).astype(np.float32))
    G = torch.from_numpy(rng.random((7, 4)).astype(np.float32))
    scores, preds = tev._fold_scores(M, S, G, (torch.tensor([0, 2]), torch.tensor([1, 3])))
    for f in range(3):
        Y = (torch.softmax(M[f].double(), dim=1).T @ S.double()).numpy()
        np.testing.assert_allclose(scores[f].numpy(), tev._column_cosine(Y, G.numpy()),
                                   rtol=1e-5)
        if f in (0, 2):
            k = 0 if f == 0 else 1
            np.testing.assert_allclose(preds[k].numpy(), Y[:, [1, 3][k]], rtol=1e-5)


# ---------------------------------------------------------------------------
# eval_metric
# ---------------------------------------------------------------------------

def test_eval_metric_golden():
    df = pd.read_csv(os.path.join(DATA_DIR, "test_df.csv"), index_col=0)
    metrics, ((curve_x, curve_y), (scores, sparsities)) = tgt.eval_metric(df)
    assert metrics["auc_score"] == pytest.approx(0.750597829464878)
    want, (want_curve, _) = tg.eval_metric(df)
    for key in want:
        assert metrics[key] == pytest.approx(want[key], rel=1e-12)
    assert curve_x == want_curve[0] and curve_y == want_curve[1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_eval_metric_matches_jax_on_random_tables(seed):
    rng = np.random.default_rng(seed)
    n = 60
    df = pd.DataFrame(
        {"score": rng.random(n), "sparsity_sp": rng.random(n) ** 2,
         "is_training": rng.random(n) < 0.3},
        index=[f"g{i}" for i in range(n)],
    )
    for test_genes in (None, list(df.index[:25])):
        got, (curve, _) = tgt.eval_metric(df, test_genes)
        want, (want_curve, _) = tg.eval_metric(df, test_genes)
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-12), key
        assert curve == want_curve
    for api in (tgt, tg):
        with pytest.raises(ValueError, match="subset"):
            api.eval_metric(df, ["nope"])


def test_auc_matches_sklearn_and_its_errors():
    from sklearn.metrics import auc

    rng = np.random.default_rng(3)
    x = np.sort(rng.random(11))
    y = rng.random(11)
    assert tev._auc(x, y) == auc(x, y)
    assert tev._auc(x[::-1], y[::-1]) == auc(x[::-1], y[::-1])  # decreasing x
    for bad_x, bad_y in (([0.0, 1.0, 0.5], [1.0, 2.0, 3.0]), ([0.0], [1.0])):
        with pytest.raises(ValueError) as err:
            tev._auc(bad_x, bad_y)
        with pytest.raises(ValueError) as want:
            auc(bad_x, bad_y)
        assert str(err.value) == str(want.value)


# ---------------------------------------------------------------------------
# the exported surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cosine_lr", "cross_val", "cv_data_gen",
                                  "eval_metric", "init_logits"])
def test_exported_signatures_match_jax(name):
    """Each newly exported name takes JAX's parameters with JAX's defaults
    (dtypes by name); the port adds only ``device`` to ``init_logits``."""
    got = inspect.signature(getattr(tgt, name)).parameters
    want = inspect.signature(getattr(tg, name)).parameters
    extra = ["device"] if name == "init_logits" else []
    assert list(got) == list(want) + extra
    for key, p in want.items():
        d_got, d_want = got[key].default, p.default
        if key == "dtype":
            d_got, d_want = str(d_got).removeprefix("torch."), np.dtype(d_want).name
        assert d_got == d_want, key
    assert callable(tgt.checkpoint.train_checkpointed)
