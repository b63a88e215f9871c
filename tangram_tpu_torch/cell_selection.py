"""Cell sampling preprocessing (the reference's CytoSPACE-based step,
``cell_selection/cell_sampling.py:12-44``), the counterpart of
``tangram_tpu/cell_selection.py``: host code in numpy, pandas and scipy,
with the same random draws in the same order (``np.random.default_rng``),
so that :func:`cell_sampling` returns the JAX package's cells bit for bit.

* :func:`estimate_cell_type_fractions` — per-type fractions from an NNLS fit
  of the spatial pseudobulk onto cell-type mean expression profiles.
* :func:`estimate_cell_number_rna_reads` — per-spot cell counts proportional
  to per-spot RNA reads, scaled to a target mean (min 1 per spot).
* :func:`downsample_transcripts` — multinomial thinning of cells above a
  transcript budget.
* :func:`sample_single_cells` — per-type sampling (with duplicates when a
  type is short of its target).
* :func:`cell_sampling` — the full pipeline, AnnData in / AnnData out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .adlite import AnnData

__all__ = [
    "estimate_cell_type_fractions",
    "estimate_cell_number_rna_reads",
    "downsample_transcripts",
    "sample_single_cells",
    "cell_sampling",
]


def _dense(X):
    return np.asarray(X.toarray() if sp.issparse(X) or hasattr(X, "toarray") else X, dtype=np.float64)


def estimate_cell_type_fractions(adata_sc, adata_sp, cell_type_key: str) -> pd.Series:
    """Fraction of each cell type in the spatial sample.

    Non-negative least squares of the (CPM-normalized) spatial pseudobulk
    against cell-type mean expression over shared genes, normalized to sum 1.
    """
    from scipy.optimize import nnls

    sc_genes = pd.Index([g.lower() for g in adata_sc.var.index])
    sp_genes = pd.Index([g.lower() for g in adata_sp.var.index])
    shared = sc_genes.intersection(sp_genes)
    if len(shared) < 2:
        raise ValueError("Too few shared genes to estimate cell-type fractions.")

    S = _dense(adata_sc.X)[:, sc_genes.get_indexer(shared)]
    G = _dense(adata_sp.X)[:, sp_genes.get_indexer(shared)]

    labels = np.asarray(adata_sc.obs[cell_type_key])
    types = pd.unique(labels)
    profiles = np.stack([S[labels == t].mean(axis=0) for t in types], axis=1)

    def cpm(v):
        tot = v.sum()
        return v / tot * 1e6 if tot > 0 else v

    pseudobulk = cpm(G.sum(axis=0))
    profiles = np.apply_along_axis(cpm, 0, profiles)

    coef, _ = nnls(profiles, pseudobulk)
    if coef.sum() == 0:
        coef = np.ones_like(coef)
    fractions = coef / coef.sum()
    return pd.Series(fractions, index=types, name="fraction")


def estimate_cell_number_rna_reads(adata_sp, mean_cell_numbers: int = 5) -> np.ndarray:
    """Per-spot integer cell counts proportional to per-spot RNA reads,
    scaled so the mean is ``mean_cell_numbers`` (at least 1 per spot)."""
    reads = _dense(adata_sp.X).sum(axis=1)
    mean_reads = reads.mean() if reads.mean() > 0 else 1.0
    counts = np.round(reads / mean_reads * mean_cell_numbers).astype(int)
    return np.maximum(counts, 1)


def downsample_transcripts(
    X, max_transcripts_per_cell: int = 1500, random_state: Optional[int] = 0
):
    """Multinomially thin each cell's counts down to the transcript budget."""
    rng = np.random.default_rng(random_state)
    X = _dense(X).copy()
    totals = X.sum(axis=1)
    for i in np.where(totals > max_transcripts_per_cell)[0]:
        p = X[i] / totals[i]
        X[i] = rng.multinomial(max_transcripts_per_cell, p)
    return X


def sample_single_cells(
    labels,
    cell_type_numbers: pd.Series,
    sampling_method: str = "duplicates",
    random_state: int = 1234,
) -> np.ndarray:
    """Indices of sampled cells matching the per-type targets.

    ``duplicates`` samples with replacement when a type has fewer cells than
    its target; ``place_holders`` caps at the available count.
    """
    rng = np.random.default_rng(random_state)
    labels = np.asarray(labels)
    chosen = []
    for cell_type, target in cell_type_numbers.items():
        target = int(target)
        pool = np.where(labels == cell_type)[0]
        if len(pool) == 0 or target <= 0:
            continue
        if target <= len(pool):
            chosen.append(rng.choice(pool, size=target, replace=False))
        elif sampling_method == "duplicates":
            chosen.append(pool)
            chosen.append(rng.choice(pool, size=target - len(pool), replace=True))
        else:
            chosen.append(pool)
    return np.concatenate(chosen) if chosen else np.array([], dtype=int)


def cell_sampling(
    adata_sc,
    adata_st,
    cell_type_key: str = "cell_subclass",
    mean_cell_numbers: int = 5,
    max_transcripts_per_cell: int = 1500,
    sampling_method: str = "duplicates",
    random_state: int = 1234,
):
    """Subsample single cells to match the spatial sample's estimated
    composition (native equivalent of the reference CytoSPACE pipeline).

    Returns a new AnnData whose cells follow the estimated per-type targets,
    with transcript counts thinned to ``max_transcripts_per_cell``.
    """
    fractions = estimate_cell_type_fractions(adata_sc, adata_st, cell_type_key)
    cells_per_spot = estimate_cell_number_rna_reads(adata_st, mean_cell_numbers)
    number_of_cells = int(cells_per_spot.sum())

    cell_type_numbers = (fractions * number_of_cells).round().astype(int)

    X = downsample_transcripts(
        adata_sc.X, max_transcripts_per_cell, random_state=random_state
    )
    idx = sample_single_cells(
        adata_sc.obs[cell_type_key], cell_type_numbers, sampling_method, random_state
    )

    obs = adata_sc.obs.iloc[idx].copy()
    obs.index = [f"{name}.{i}" for i, name in enumerate(obs.index)]
    out = AnnData(
        X=X[idx],
        obs=obs,
        var=adata_sc.var.copy(),
        uns=dict(adata_sc.uns),
    )
    out.uns["cell_sampling"] = {
        "number_of_cells": number_of_cells,
        "cell_type_fractions": {str(k): float(v) for k, v in fractions.items()},
    }
    return out
