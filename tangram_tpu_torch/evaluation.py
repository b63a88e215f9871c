"""Projection and scoring: ``project_genes`` and ``compare_spatial_geneexp``.

Counterpart of the main-path half of ``tangram_tpu/evaluation.py``
(``project_genes`` ref utils.py:338, ``compare_spatial_geneexp`` ref
utils.py:377). Gene scoring is one vectorized column cosine. The
cross-validation workflows and ``eval_metric`` are a later slice
(ROADMAP queue A7).
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from . import adlite
from .ops.core import softmax_row_chunks
from .utils import annotate_gene_sparsity

__all__ = [
    "projected_expression",
    "projected_expression_from_logits",
    "project_genes",
    "compare_spatial_geneexp",
]


def _as_dense(X):
    return X.toarray() if hasattr(X, "toarray") else np.asarray(X)


def projected_expression(M, X):
    """``Mᵀ @ X`` (spots × genes) on the host, in f32."""
    return np.asarray(M, dtype=np.float32).T @ np.asarray(X, dtype=np.float32)


def projected_expression_from_logits(M_logits: torch.Tensor, X) -> np.ndarray:
    """``softmax(M)ᵀ @ X`` computed where the trained logits live.

    The softmax and the product run on ``M_logits``' device (``torch.matmul``
    in full f32; logits stored in bf16 are normalized in f32), a chunk of
    cells at a time so that softmax(M) is never whole on the device, and
    only the (spots × genes) result is fetched, once.
    """
    X_dev = torch.tensor(np.asarray(X, dtype=np.float32), device=M_logits.device)
    out = torch.zeros((M_logits.shape[1], X_dev.shape[1]), dtype=torch.float32,
                      device=M_logits.device)
    with torch.no_grad():
        for r0, P in softmax_row_chunks(M_logits):
            out += P.T @ X_dev[r0:r0 + P.shape[0]]
    return out.cpu().numpy()


def _column_cosine(A, B):
    """Per-column cosine similarity of two (n, g) matrices → (g,)."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    dots = np.einsum("ng,ng->g", A, B)
    return dots / (np.linalg.norm(A, axis=0) * np.linalg.norm(B, axis=0))


def _require_pp(adata, hint="Run `pp_adatas()`."):
    if not {"training_genes", "overlap_genes"} <= set(adata.uns.keys()):
        raise ValueError(f"Missing tangram parameters. {hint}")


def project_genes(adata_map, adata_sc, cluster_label=None, scale=True):
    """Project the full single-cell transcriptome onto space: one matmul
    ``Mᵀ @ S`` over every gene (ref utils.py:338-374). Lowercases and
    deduplicates ``adata_sc`` gene names in place, like the reference.
    """
    from .mapping import adata_to_cluster_expression

    adata_sc.var.index = [g.lower() for g in adata_sc.var.index]
    adata_sc.var_names_make_unique()
    adlite.filter_genes(adata_sc, min_cells=1)

    if cluster_label:
        adata_sc = adata_to_cluster_expression(adata_sc, cluster_label, scale=scale)

    if not adata_map.obs.index.equals(adata_sc.obs.index):
        raise ValueError("The two AnnDatas need to have same `obs` index.")

    projected = adlite.AnnData(
        X=projected_expression(adata_map.X, _as_dense(adata_sc.X)),
        obs=adata_map.var.copy(),
        var=adata_sc.var.copy(),
        uns=dict(adata_sc.uns),
    )
    trained_on = adata_map.uns["train_genes_df"].index.values
    projected.var["is_training"] = projected.var.index.isin(trained_on)
    return projected


def compare_spatial_geneexp(adata_ge, adata_sp, adata_sc=None, genes=None):
    """Score projected vs measured spatial expression per gene
    (ref utils.py:377-463): cosine similarity over ``overlap_genes`` (or an
    explicit gene list), annotated with sparsity columns and sorted by score.
    """
    _require_pp(adata_sp)
    _require_pp(adata_ge, hint="Use `project_genes()` to get adata_ge.")
    assert list(adata_sp.uns["overlap_genes"]) == list(adata_ge.uns["overlap_genes"])

    scored_genes = adata_ge.uns["overlap_genes"] if genes is None else genes

    annotate_gene_sparsity(adata_sp)
    scores = _column_cosine(
        _as_dense(adata_ge[:, scored_genes].X), _as_dense(adata_sp[:, scored_genes].X)
    )

    report = pd.DataFrame({"score": scores}, index=scored_genes)
    for source in (adata_ge, adata_sp):
        if "is_training" in source.var.keys():
            report["is_training"] = source.var.is_training
    report["sparsity_sp"] = adata_sp[:, scored_genes].var.sparsity

    if adata_sc is None:
        logging.info(
            "To create dataframe with column 'sparsity_sc' or 'sparsity_diff', "
            "please also pass adata_sc to the function."
        )
    else:
        _require_pp(adata_sc)
        assert list(adata_sc.uns["overlap_genes"]) == list(
            adata_sp.uns["overlap_genes"]
        )
        annotate_gene_sparsity(adata_sc)
        report["sparsity_sc"] = adata_sc[:, scored_genes].var["sparsity"]
        report["sparsity_diff"] = report["sparsity_sp"] - report["sparsity_sc"]

    if genes is not None:
        report = report.loc[genes]
    return report.sort_values(by="score", ascending=False)
