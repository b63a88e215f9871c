"""Projection, scoring and cross-validation workflows.

Counterpart of ``tangram_tpu/evaluation.py``: ``project_genes`` (ref
utils.py:338), ``compare_spatial_geneexp`` (ref utils.py:377),
``cv_data_gen`` and ``cross_val`` (ref utils.py:466/503) and
``eval_metric`` (ref utils.py:671). Gene scoring is one vectorized column
cosine. :func:`cross_val` trains all folds as one batch by default: a
(folds, cells, spots) M with per-fold Adam moments over one shared S and G
and a (folds, genes) gene mask, in plain PyTorch on the card
(``batched=False`` retrains fold by fold through ``map_cells_to_space`` and
its CUDA kernels, as the reference does). On a mesh of processes the
batches' folds spread over a fold axis and each fold's cells over the
other axes (``cross_val(mesh=)``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pandas as pd
import torch

from . import adlite
from .ops.core import softmax_row_chunks

__all__ = [
    "projected_expression",
    "projected_expression_from_logits",
    "project_genes",
    "compare_spatial_geneexp",
    "cv_data_gen",
    "cross_val",
    "eval_metric",
]


def _as_dense(X):
    return X.toarray() if hasattr(X, "toarray") else np.asarray(X)


# Above this many M entries host BLAS becomes the projection's bottleneck
# (the JAX package's threshold): stream the product through the card instead.
_DEVICE_MM_THRESHOLD = 1 << 28


def _projects_on_device(backend: str, n_entries: int, device) -> bool:
    """Which side :func:`projected_expression` takes: ``"auto"`` takes the
    device for at least 2^28 entries of M when CUDA is available and
    ``device`` is None or a CUDA device."""
    if backend not in ("auto", "host", "device"):
        raise ValueError(f"backend must be 'auto', 'host' or 'device', got {backend!r}")
    if backend != "auto":
        return backend == "device"
    on_card = device is None or torch.device(device).type == "cuda"
    return on_card and torch.cuda.is_available() and n_entries >= _DEVICE_MM_THRESHOLD


def projected_expression(M, X, backend="auto", spot_chunk=16384, device=None):
    """``Mᵀ @ X`` (spots × genes) in f32: the projection behind
    :func:`project_genes`.

    ``backend="auto"`` keeps small products on the host (no transfer) and
    streams those of at least 2^28 entries of M through the card when CUDA
    is available (and ``device``, if given, is a CUDA device); ``"host"``
    and ``"device"`` force a side. The device side moves ``spot_chunk``
    columns of M at a time, so neither M nor the output is ever whole on
    the card, and multiplies with ``torch.matmul`` in full f32 (TF32 off
    for the call, whatever the process set): the result feeds the
    reported gene scores. ``device=None`` means ``"cuda"``, and
    ``backend="device"`` without CUDA raises; ``device="cpu"`` runs the
    chunked path on the CPU.
    """
    from .models.mapper import resolve_device

    M = np.asarray(M, dtype=np.float32)
    X = np.asarray(X, dtype=np.float32)
    if not _projects_on_device(backend, M.size, device):
        return M.T @ X

    dev = resolve_device(device)
    X_dev = torch.from_numpy(X).to(dev)
    out = np.empty((M.shape[1], X.shape[1]), np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        step = int(spot_chunk)
        for start in range(0, M.shape[1], step):
            chunk = torch.from_numpy(np.ascontiguousarray(M[:, start:start + step]))
            out[start:start + chunk.shape[1]] = (chunk.to(dev).T @ X_dev).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


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
    from .utils import annotate_gene_sparsity

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


def _folds(n: int, cv_mode: str):
    """(train positions, test positions) of sklearn's ``LeaveOneOut`` or
    ``KFold(n_splits=10)`` (no shuffling: contiguous folds, the first
    ``n % 10`` one larger), in sklearn's order and with its errors."""
    if cv_mode == "loo":
        if n <= 1:
            raise ValueError(f"Cannot perform LeaveOneOut with n_samples={n}.")
        sizes = [1] * n
    elif cv_mode == "10fold":
        if n < 10:
            raise ValueError(
                "Cannot have number of splits n_splits=10 greater than the "
                f"number of samples: n_samples={n}.")
        sizes = [n // 10 + (i < n % 10) for i in range(10)]
    else:
        raise ValueError("Invalid cv_mode; use 'loo' or '10fold'.")
    idx = np.arange(n)
    start = 0
    for size in sizes:
        yield np.concatenate([idx[:start], idx[start + size:]]), idx[start:start + size]
        start += size


def cv_data_gen(adata_sc, adata_sp, cv_mode="loo"):
    """Yield (train_genes, test_genes) splits of the training genes
    (ref utils.py:466-500): leave-one-out or 10-fold."""
    for adata in (adata_sc, adata_sp):
        if "training_genes" not in adata.uns.keys():
            raise ValueError("Missing tangram parameters. Run `pp_adatas()`.")
    if list(adata_sp.uns["training_genes"]) != list(adata_sc.uns["training_genes"]):
        raise ValueError(
            "Unmatched training_genes field in two Anndatas. Run `pp_adatas()`."
        )

    genes = np.asarray(adata_sp.uns["training_genes"])
    for train_idx, test_idx in _folds(len(genes), cv_mode):
        yield list(genes[train_idx]), list(genes[test_idx])


def cross_val(
    adata_sc,
    adata_sp,
    cluster_label=None,
    mode="clusters",
    scale=True,
    lambda_d=0,
    lambda_g1=1,
    lambda_g2=0,
    lambda_r=0,
    lambda_count=1,
    lambda_f_reg=1,
    target_count=None,
    num_epochs=1000,
    device=None,
    learning_rate=0.1,
    cv_mode="loo",
    return_gene_pred=False,
    density_prior=None,
    random_state=None,
    verbose=False,
    batched="auto",
    fold_batch_size="auto",
    mesh=None,
    resume_path=None,
):
    """Gene-holdout cross-validation (ref utils.py:503-668).

    With ``batched`` (the default for every mode), the folds train as
    batches of ``fold_batch_size`` folds: each fold its own M and Adam
    moments, over one shared S and G, with the fold's held-out genes masked
    out of the loss; the same init and the same masked loss as the per-fold
    loop. ``fold_batch_size="auto"`` sizes the batch to half the card's
    memory (:func:`_fold_bytes`, at most 256 folds). ``batched=False`` is
    the reference-style loop, one ``map_cells_to_space`` per fold (the CUDA
    kernels on the card). ``device`` is honoured on both paths: ``None``
    means ``"cuda"`` and raises without a card.

    ``resume_path`` journals every completed fold batch to a JSONL file (a
    ``<path>.preds/`` sidecar holds per-fold predictions when
    ``return_gene_pred``): a killed sweep resumes where it stopped,
    recomputing at most one batch, assuming the same arguments (mode, folds,
    epochs and seed are checked; loss weights and the schedule are the
    caller's responsibility). Batched path only.

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` of the ``device``'s
    type; every rank of it calls ``cross_val`` alike) is data parallelism
    over folds with tensor parallelism inside each fold, as the JAX package
    lays it out: a fold batch whose size divides the mesh axis named
    ``"fold"`` (else the first axis) spreads over it, each rank training
    its block of the batch, and any other batch trains whole on every rank;
    the remaining axes shard each fold's cells in contiguous blocks when
    the cell count divides their product, and hold every cell, with a
    warning, otherwise (the Y = PᵀS and q = wP sums are summed over the
    cell group every step). ``fold_batch_size="auto"`` then divides the
    per-fold bytes of the (cells × spots) arrays by the cell shards and
    rounds the batch down to a multiple of the fold axis. Every rank
    returns the whole result; the lead rank alone writes ``resume_path``.
    The loop path (``batched=False``) ignores ``mesh``, as in JAX.
    """
    from .models.mapper import resolve_device

    device = resolve_device(device)
    kwargs = dict(
        cluster_label=cluster_label,
        mode=mode,
        scale=scale,
        lambda_d=lambda_d,
        lambda_g1=lambda_g1,
        lambda_g2=lambda_g2,
        lambda_r=lambda_r,
        lambda_count=lambda_count,
        lambda_f_reg=lambda_f_reg,
        target_count=target_count,
        num_epochs=num_epochs,
        device=device,
        learning_rate=learning_rate,
        cv_mode=cv_mode,
        return_gene_pred=return_gene_pred,
        density_prior=density_prior,
        random_state=random_state,
        verbose=verbose,
    )
    if batched == "auto":
        batched = mode in ("clusters", "cells", "constrained")
    if batched:
        return _cross_val_batched(
            adata_sc, adata_sp, fold_batch_size=fold_batch_size, mesh=mesh,
            resume_path=resume_path, **kwargs
        )
    if resume_path is not None:
        raise ValueError(
            "resume_path requires the batched cross_val path "
            "(batched=True or a batched-capable mode)"
        )
    return _cross_val_loop(adata_sc, adata_sp, **kwargs)


def _summary(test_scores, train_scores):
    cv_dict = {
        "avg_test_score": float(np.nanmean(test_scores)),
        "avg_train_score": float(np.nanmean(train_scores)),
    }
    print("cv avg test score {:.3f}".format(cv_dict["avg_test_score"]))
    print("cv avg train score {:.3f}".format(cv_dict["avg_train_score"]))
    return cv_dict


def _loop_fold(adata_sc, adata_sp, sc_for_scoring, train_genes, test_genes,
               **map_kwargs):
    """One fold of the loop path: ``map_cells_to_space`` on the fold's
    training genes, then the projection and scores of its genes. Returns
    the fold's record and its projected AnnData."""
    from .mapping import map_cells_to_space

    adata_map = map_cells_to_space(adata_sc=adata_sc, adata_sp=adata_sp,
                                   cv_train_genes=train_genes, verbose=False,
                                   **map_kwargs)
    fold_genes = train_genes + test_genes
    adata_ge = project_genes(adata_map, adata_sc[:, fold_genes],
                             cluster_label=map_kwargs["cluster_label"],
                             scale=map_kwargs["scale"])
    scores = compare_spatial_geneexp(adata_ge, adata_sp, sc_for_scoring, fold_genes)
    fold = {
        "test_genes": test_genes,
        "test_df": scores[scores.index.isin(test_genes)],
        "test_score": scores.loc[test_genes]["score"].mean(),
        "train_score": float(list(adata_map.uns["training_history"]["main_loss"])[-1]),
    }
    return fold, adata_ge


def _cross_val_loop(
    adata_sc,
    adata_sp,
    *,
    cluster_label,
    mode,
    scale,
    lambda_d,
    lambda_g1,
    lambda_g2,
    lambda_r,
    lambda_count,
    lambda_f_reg,
    target_count,
    num_epochs,
    device,
    learning_rate,
    cv_mode,
    return_gene_pred,
    density_prior,
    random_state,
    verbose,
):
    """Reference-style sequential CV: one full ``map_cells_to_space`` per
    fold. The arguments are checked before the first fold trains, by the
    batched path's validator."""
    from .mapping import _check_mapping_args, adata_to_cluster_expression

    _check_mapping_args(mode, lambda_g1, lambda_d, density_prior, cluster_label,
                        target_count, lambda_f_reg, lambda_count)
    sc_for_scoring = (
        adata_to_cluster_expression(adata_sc, cluster_label, scale)
        if mode == "clusters"
        else adata_sc
    )

    map_kwargs = dict(
        mode=mode, device=device, learning_rate=learning_rate, num_epochs=num_epochs,
        cluster_label=cluster_label, scale=scale, lambda_d=lambda_d,
        lambda_g1=lambda_g1, lambda_g2=lambda_g2, lambda_r=lambda_r,
        lambda_count=lambda_count, lambda_f_reg=lambda_f_reg,
        target_count=target_count, random_state=random_state,
        density_prior=density_prior,
    )
    records = []
    held_out_predictions = []
    for fold_no, (train_genes, test_genes) in enumerate(
        cv_data_gen(adata_sc, adata_sp, cv_mode), start=1
    ):
        fold, adata_ge = _loop_fold(adata_sc, adata_sp, sc_for_scoring, train_genes,
                                    test_genes, **map_kwargs)
        if cv_mode == "loo" and return_gene_pred:
            held_out_predictions.append(adata_ge[:, test_genes].X.T)
        records.append(fold)
        if verbose:
            print(
                "cv set: {}----train score: {:.3f}----test score: {:.3f}".format(
                    fold_no, fold["train_score"], fold["test_score"]
                )
            )

    test_scores = [r["test_score"] for r in records]
    cv_dict = _summary(test_scores, [r["train_score"] for r in records])

    if cv_mode == "loo" and return_gene_pred:
        adata_ge_cv = adlite.AnnData(
            X=np.squeeze(np.array(held_out_predictions)).T,
            obs=adata_sp.obs.copy(),
            var=pd.DataFrame(
                test_scores,
                columns=["test_score"],
                index=np.squeeze(
                    np.array([r["test_genes"] for r in records], dtype=object)
                ),
            ),
        )
        test_gene_df = pd.concat([r["test_df"] for r in records], axis=0)
        return cv_dict, adata_ge_cv, test_gene_df

    return cv_dict


#: device bytes that one fold of the batched training step holds, per entry
#: of its (cells × spots), (spots × genes) and (cells × genes) arrays: f32
#: M and Adam's mu and nu, plus at the backward's peak softmax(M), its log,
#: their product, dP and the softmax backward's temporaries (10 f32 per
#: cell-spot entry); the projection Y, the gene-masked G and the cosines'
#: products and gradients alive at once (6 per spot-gene entry, the scoring
#: pass's prediction among them); the gene-masked S or the constrained A and
#: its gradient (4 per cell-gene entry). On an H100 the step's peak per fold
#: came to 37 B per cell-spot entry (cells-mode 10-fold at 26,000 × 9,852 ×
#: 249) and 19 B per spot-gene entry (the 249-fold LOO at 22 × 9,852 ×
#: 249). JAX's count (M and two moments, 12 B) leaves the step's own arrays
#: out: at the tutorial shape it would batch 13 folds where 4 fit.
_FOLD_BYTES_PER_ENTRY = {"cs": 40, "sg": 24, "cg": 16}
#: the most folds one batch holds
_MAX_FOLD_BATCH = 256


def _fold_bytes(n_cells: int, n_spots: int, n_genes: int, cell_shards: int = 1) -> int:
    """Device bytes one fold of the batched training step takes, its
    (cells × spots) arrays split over ``cell_shards`` ranks."""
    b = _FOLD_BYTES_PER_ENTRY
    return (b["cs"] * n_cells * n_spots // cell_shards + b["sg"] * n_spots * n_genes
            + b["cg"] * n_cells * n_genes)


def auto_fold_batch_size(n_cells: int, n_spots: int, n_genes: int, device,
                         cell_shards: int = 1, fold_shards: int = 1) -> int:
    """Folds per batch that fit :func:`~tangram_tpu_torch.utils.device_memory_budget`
    (half the card), between 1 and 256, with each fold's cells over
    ``cell_shards`` ranks; on a fold axis of ``fold_shards`` ranks rounded
    down to a multiple of it, and at least one fold per rank (the JAX
    package's rule)."""
    from .utils import device_memory_budget

    budget = device_memory_budget(device)
    per_fold = _fold_bytes(n_cells, n_spots, n_genes, cell_shards)
    batch = int(np.clip(budget // max(per_fold, 1), 1, _MAX_FOLD_BATCH))
    return max(fold_shards, batch // fold_shards * fold_shards)


def _fit_folds(params0, data, masks, lw, num_epochs: int, learning_rate,
               constrained: bool, cell=None, n_cells: int = None):
    """Adam on a batch of folds: every fold starts from ``params0`` (M, or
    (M, F)) and trains with its row of ``masks`` (folds, genes) as the gene
    mask of the reference loss (the materialized core and the loss
    epilogue of ``compute_loss`` / ``compute_constrained_loss``, each
    mapped over the folds by ``torch.func.vmap``; products in f32, TF32 off
    as PyTorch's default leaves it), each fold with its own moments and one
    shared step count. Returns the trained parameters, each with a leading
    fold axis, and each fold's gene-voxel score before the last step (the
    training score the loop path reports).

    On a cell block (``cell``, a mesh axis of
    :mod:`~tangram_tpu_torch.parallel.mesh`, with ``params0``, ``data.S``
    and ``data.d_source`` this rank's rows of ``n_cells``) the core's sums
    over cells (Y, q, Σh and the filter's two sums) are summed over the
    axis between the two mapped halves: a collective does not map.
    """
    from .models.mapper import _lr_at
    from .ops.core import mapper_core_reference
    from .ops.optim import make_adam
    from .ops.losses import (constrained_epilogue, constrained_inputs,
                             unconstrained_epilogue, unconstrained_inputs)
    from .ops.axes import NO_AXIS, sum_replicated

    cell = NO_AXIS if cell is None else cell
    n = masks.shape[0]
    leaves0 = tuple(params0) if constrained else (params0,)
    params = tuple(p.expand(n, *p.shape).clone() for p in leaves0)
    mus = tuple(torch.zeros_like(p) for p in params)
    nus = tuple(torch.zeros_like(p) for p in params)
    if data.d_source is None and not constrained:
        c_local = leaves0[0].shape[0]
        # the uniform marginal over every cell of the fold, not the block's
        data = data._replace(d_source=torch.full(
            (c_local,), 1.0 / (n_cells or c_local), dtype=torch.float32,
            device=leaves0[0].device))

    def partials(mask, *leaves):
        """This rank's share of one fold's core: Y, q, Σh and, constrained,
        Σσ(F) and Σσ(F)(1 − σ(F))."""
        fold = data._replace(gene_mask=mask)
        if constrained:
            A, w = constrained_inputs(leaves[1], fold)
            f_sums = (torch.sum(w), torch.sum(w - w * w))
        else:
            A, w = unconstrained_inputs(leaves[0], fold, lw)
            f_sums = ()
        Y, q, h = mapper_core_reference(leaves[0], A, w)
        return (Y, q, torch.sum(h)) + f_sums

    def epilogue(mask, Y, q, h_sum, *f_sums):
        fold = data._replace(gene_mask=mask)
        if constrained:
            total, terms = constrained_epilogue(Y, q, h_sum, None, fold, lw, f_sums=f_sums)
        else:
            total, terms = unconstrained_epilogue(Y, q, h_sum, None, None, fold, lw)
        return total, terms["main_loss"]

    cores, losses = torch.func.vmap(partials), torch.func.vmap(epilogue)
    main = None
    for t in range(num_epochs):
        with torch.enable_grad():
            leaves = tuple(p.detach().requires_grad_() for p in params)
            sums = (sum_replicated(x, cell) for x in cores(masks, *leaves))
            totals, main = losses(masks, *sums)
            grads = torch.autograd.grad(totals.sum(), leaves)
        make_adam(_lr_at(learning_rate, t)).update(grads, (t, mus, nus), params)
        # the gradients are (folds, c, s): free them before the next forward
        del leaves, totals, grads
    return params, main.detach()


def _fold_scores(M, S, G, test_cols, cell=None):
    """Per-fold, per-gene cosine of the projection softmax(M)ᵀS against G,
    (folds, genes), and each fold's test-gene columns of the projection,
    gathered on the device: (n, spots) for the ``n`` (fold, gene) pairs of
    ``test_cols``. The softmax runs over spots, the LAST axis of the
    (folds, cells, spots) M: over cells it would renormalize the wrong way
    and depress every held-out score (−0.078 on the recorded LOO). On a
    cell block (M's and S's rows) the projection is summed over ``cell``."""
    from .ops.axes import NO_AXIS, all_sum_

    G_pred = all_sum_(torch.matmul(torch.softmax(M, dim=-1).transpose(1, 2), S),
                      NO_AXIS if cell is None else cell)
    dots = torch.sum(G_pred * G[None], dim=1)
    n1 = torch.linalg.vector_norm(G_pred, dim=1)
    n2 = torch.linalg.vector_norm(G, dim=0)[None]
    preds = None
    if test_cols is not None:
        f_idx, g_idx = test_cols
        preds = G_pred[f_idx, :, g_idx]
    return dots / (n1 * n2), preds


@torch.no_grad()
def _cross_val_batched(
    adata_sc,
    adata_sp,
    *,
    cluster_label,
    mode,
    scale,
    lambda_d,
    lambda_g1,
    lambda_g2,
    lambda_r,
    num_epochs,
    device,
    learning_rate,
    cv_mode,
    return_gene_pred,
    density_prior,
    random_state,
    verbose,
    fold_batch_size,
    mesh=None,
    resume_path=None,
    lambda_count=1,
    lambda_f_reg=1,
    target_count=None,
):
    """All CV folds as batches of folds trained together (see
    :func:`_fit_folds`), on ``mesh`` as :func:`cross_val` says."""
    from .mapping import (_check_mapping_args, _densify, _resolve_density,
                          adata_to_cluster_expression)
    from .models.mapper import (_check_mesh, _draw_device, init_constrained_logits,
                                init_logits)
    from .ops.losses import LossWeights, MapperData
    from .ops.schedules import resolve_lr
    from .parallel.mesh import BatchLayout
    from .utils import annotate_gene_sparsity

    # the SAME validator the per-fold loop path runs, so that batched and
    # loop cross_val accept and reject identical arguments
    lambda_d = _check_mapping_args(
        mode, lambda_g1, lambda_d, density_prior, cluster_label,
        target_count, lambda_f_reg, lambda_count,
    )
    constrained = mode == "constrained"
    mesh = _check_mesh(mesh, device)

    adata_sc_orig = adata_sc
    if mode == "clusters":
        adata_sc = adata_to_cluster_expression(
            adata_sc, cluster_label, scale, add_density=True
        )

    training_genes = list(adata_sc.uns["training_genes"])
    S = _densify(adata_sc[:, training_genes].X)
    G = _densify(adata_sp[:, training_genes].X)
    # the prior map_cells_to_space resolves, so that both CV paths train on
    # the same density target
    prior = _resolve_density(mode, density_prior, lambda_d, adata_sc, adata_sp)
    lw = LossWeights(
        lambda_g1=float(lambda_g1),
        lambda_d=float(prior.lambda_d),
        lambda_g2=float(lambda_g2),
        lambda_r=float(lambda_r),
        lambda_count=float(lambda_count),
        lambda_f_reg=float(lambda_f_reg),
    )

    folds = list(cv_data_gen(adata_sc, adata_sp, cv_mode))
    n_folds = len(folds)
    gene_index = {g: i for i, g in enumerate(training_genes)}
    masks = np.zeros((n_folds, len(training_genes)), dtype=np.float32)
    test_idx_lists = []
    for f, (train_genes, test_genes) in enumerate(folds):
        masks[f, [gene_index[g] for g in train_genes]] = 1.0
        test_idx_lists.append([gene_index[g] for g in test_genes])

    n_cells, n_spots = S.shape[0], G.shape[0]
    layout = BatchLayout(mesh, "fold", n_cells, what="per-fold")
    if fold_batch_size == "auto":
        fold_batch_size = auto_fold_batch_size(
            n_cells, n_spots, len(training_genes), device,
            cell_shards=layout.cell.block.count, fold_shards=layout.batch.block.count)
    fold_batch_size = int(fold_batch_size)
    init_device = _draw_device("auto", n_cells * n_spots, device, mesh)
    if constrained:
        params0 = init_constrained_logits(n_cells, n_spots, random_state, "auto",
                                          device=init_device)
    else:
        params0 = init_logits(n_cells, n_spots, random_state, "auto", device=init_device)

    def dev(x):
        return None if x is None else torch.tensor(np.asarray(x, dtype=np.float32),
                                                   device=device)

    # this rank's cells of every fold
    rows = layout.rows
    params0 = (tuple(p[rows].to(device) for p in params0) if constrained
               else params0[rows].to(device))
    data = MapperData(
        S=dev(S[rows]), G=dev(G), d=dev(prior.d),
        d_source=None if prior.d_source is None else dev(np.asarray(prior.d_source)[rows]),
        target_count=dev(np.float32(target_count)) if constrained else None,
    )
    lr = resolve_lr(learning_rate, int(num_epochs))

    all_scores = np.zeros((n_folds, len(training_genes)))
    train_scores = np.zeros(n_folds)
    pred_cols = {} if return_gene_pred else None

    # crash tolerance: journal each completed fold batch (scores as JSONL
    # rows, per-fold predictions as .npy sidecars) so that an interrupted
    # sweep resumes at the first incomplete batch
    journal, done_folds, pred_store = None, {}, None
    if resume_path is not None:
        from .utils import _SweepJournal

        journal = _SweepJournal(
            resume_path,
            meta=dict(
                workload="cross_val", mode=mode, cv_mode=cv_mode,
                num_epochs=int(num_epochs), random_state=random_state,
                n_folds=n_folds, n_genes=len(training_genes),
                return_gene_pred=bool(return_gene_pred),
            ),
            sync=layout,
        )
        done_folds = {int(rec["fold"]): rec for rec in journal.load()}
        if return_gene_pred:
            pred_store = resume_path + ".preds"
            os.makedirs(pred_store, exist_ok=True)

    for start in range(0, n_folds, fold_batch_size):
        stop = min(start + fold_batch_size, n_folds)
        if journal is not None and all(f in done_folds for f in range(start, stop)):
            for f in range(start, stop):
                rec = done_folds[f]
                all_scores[f] = np.asarray(rec["gene_scores"], np.float64)
                train_scores[f] = float(rec["train_score"])
                if return_gene_pred:
                    arr = np.load(os.path.join(pred_store, f"fold{f}.npy"))
                    for k, tg in enumerate(test_idx_lists[f]):
                        pred_cols[tg] = arr[k]
            if verbose:
                print(f"cv folds {start}-{stop - 1} resumed from journal")
            continue
        # this rank's folds of the batch: a block of the fold axis, or all
        n = stop - start
        mine = layout.part(n)
        first, last = start + mine.start, start + mine.stop
        params, main = _fit_folds(params0, data, dev(masks[first:last]), lw,
                                  int(num_epochs), lr, constrained, cell=layout.cell,
                                  n_cells=n_cells)
        # every fold's test genes padded to the batch's most (the last
        # repeated), so that each rank gathers alike-shaped predictions
        width = max(len(test_idx_lists[f]) for f in range(start, stop))
        pairs = []
        for f in range(first, last):
            tgs = test_idx_lists[f]
            pairs += [(f - first, tgs[min(j, len(tgs) - 1)]) for j in range(width)]
        test_cols = (tuple(torch.tensor(v, device=device) for v in zip(*pairs))
                     if return_gene_pred else None)
        scores, preds = _fold_scores(params[0], data.S, data.G, test_cols, cell=layout.cell)
        del params
        all_scores[start:stop] = layout.gather(scores, n).cpu().numpy()
        train_scores[start:stop] = layout.gather(main, n).cpu().numpy()
        if return_gene_pred:
            preds = layout.gather(preds.reshape(last - first, width, -1), n).cpu().numpy()
            for f in range(start, stop):
                for j, tg in enumerate(test_idx_lists[f]):
                    pred_cols[tg] = preds[f - start, j]
        if journal is not None:
            if return_gene_pred and layout.lead:
                # predictions first: the journal line is the commit point
                for f in range(start, stop):
                    np.save(os.path.join(pred_store, f"fold{f}.npy"),
                            np.stack([pred_cols[tg] for tg in test_idx_lists[f]]))
            journal.append([
                {"fold": f,
                 "gene_scores": [float(x) for x in all_scores[f]],
                 "train_score": float(train_scores[f])}
                for f in range(start, stop)
            ])
        if verbose:
            print(f"cv folds {start}-{stop - 1} done")

    test_score_list = [
        float(np.mean([all_scores[f, i] for i in test_idx_lists[f]]))
        for f in range(n_folds)
    ]
    cv_dict = _summary(test_score_list, train_scores)

    if cv_mode == "loo" and return_gene_pred:
        test_genes_flat = [folds[f][1][0] for f in range(n_folds)]
        X_pred = np.stack(
            [pred_cols[test_idx_lists[f][0]] for f in range(n_folds)], axis=1
        )
        adata_ge_cv = adlite.AnnData(
            X=X_pred,
            obs=adata_sp.obs.copy(),
            var=pd.DataFrame(
                test_score_list, columns=["test_score"], index=test_genes_flat
            ),
        )
        # test-gene dataframe matching compare_spatial_geneexp columns
        annotate_gene_sparsity(adata_sp)
        sc_for_sparsity = adata_sc if mode == "clusters" else adata_sc_orig
        annotate_gene_sparsity(sc_for_sparsity)
        sparsity_sp = adata_sp[:, test_genes_flat].var["sparsity"].to_numpy()
        sparsity_sc = sc_for_sparsity[:, test_genes_flat].var["sparsity"].to_numpy()
        test_gene_df = pd.DataFrame(
            {
                "score": test_score_list,
                "is_training": False,
                "sparsity_sp": sparsity_sp,
                "sparsity_sc": sparsity_sc,
                "sparsity_diff": sparsity_sp - sparsity_sc,
            },
            index=test_genes_flat,
        )
        return cv_dict, adata_ge_cv, test_gene_df

    return cv_dict


def _first_occurrence_keep(values, dropped_positions):
    """Keep each element whose *first* occurrence position survives.

    Replicates the reference's ``list.index``-based filter
    (ref utils.py:739-741): an element is kept iff the position of its first
    appearance is not in ``dropped_positions``, so duplicated values share
    the fate of their first occurrence.
    """
    first_pos = {}
    for i, v in enumerate(values):
        first_pos.setdefault(v, i)
    return [v for v in values if first_pos[v] not in dropped_positions]


def _auc(x, y) -> float:
    """``sklearn.metrics.auc``, written out: the trapezoid rule over (x, y),
    negated for a decreasing x; ``ValueError`` for fewer than two points or
    an x that is neither increasing nor decreasing."""
    x = np.ravel(np.asarray(x))
    y = np.ravel(np.asarray(y))
    if x.shape[0] < 2:
        raise ValueError(
            "At least 2 points are needed to compute area under curve, but "
            f"x.shape = {x.shape[0]}")
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    # numpy's trapezoid, term for term
    return direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0)


def _polynomial_auc(scores, sparsities):
    """Area under a degree-2 fit of (score → sparsity) inside the unit square.

    Quirk-compatible with ref utils.py:710-747: 10-point grid on [0, 1];
    only the first grid value is clamped to 1; one real root in [0, 1] (if
    any) extends the curve to y=0; points outside the unit square are dropped
    by first-occurrence position before the area (:func:`_auc`).
    """
    coeffs = np.polyfit(scores, sparsities, 2)
    grid_x = list(np.linspace(0, 1, 10))
    grid_y = [float(np.polyval(coeffs, x)) for x in grid_x]
    grid_y[0] = min(grid_y[0], 1.0)

    real_roots = [
        float(np.real(r))
        for r in np.roots(coeffs)
        if np.isreal(r) and 0 <= np.real(r) <= 1
    ]
    if real_roots:
        grid_x.append(real_roots[0])
        grid_y.append(0.0)

    outside = {
        i
        for i, (x, y) in enumerate(zip(grid_x, grid_y))
        if not (0 <= x <= 1 and 0 <= y <= 1)
    }
    kept_x = _first_occurrence_keep(grid_x, outside)
    kept_y = _first_occurrence_keep(grid_y, outside)

    return float(np.real(_auc(kept_x, kept_y))), (kept_x, kept_y)


def eval_metric(df_all_genes, test_genes=None):
    """Summary metrics from a score/sparsity table (ref utils.py:671-758):
    average test/train score, spatial-sparsity-weighted score, and the
    polynomial AUC (golden 0.750597829464878 on the bundled 18k-gene CSV).

    Returns ``(metric_dict, ((curve_x, curve_y), (scores, sparsities)))``.
    """
    if test_genes is None:
        test_genes = list(
            set(df_all_genes[df_all_genes["is_training"] == False].index.values)  # noqa: E712
        )
    else:
        if not set(test_genes).issubset(set(df_all_genes.index.values)):
            raise ValueError(
                "the input of test_genes should be subset of genes of input dataframe"
            )
        test_genes = np.unique(test_genes)

    if len(test_genes) == 0:
        raise ValueError(
            "No test genes found: pass `test_genes` explicitly or include rows "
            "with is_training == False in df_all_genes."
        )

    test_rows = df_all_genes.loc[test_genes]
    scores = test_rows["score"]
    sparsities = test_rows["sparsity_sp"]
    density = 1 - sparsities

    auc_score, curve = _polynomial_auc(list(scores), list(sparsities))

    metric_dict = {
        "avg_test_score": scores.mean(),
        "avg_train_score": df_all_genes.loc[
            df_all_genes["is_training"] == True, "score"  # noqa: E712
        ].mean(),
        "sp_sparsity_score": np.sum(scores * density / density.sum()),
        "auc_score": auc_score,
    }
    return metric_dict, (curve, (list(scores), list(sparsities)))
