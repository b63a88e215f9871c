"""Synthetic mapping fixtures: negative-binomial + dropout sc/spatial pairs.

A copy of ``tangram_tpu/datasets.py`` (numpy only). The defaults reproduce
the shape of the reference's MOp snRNA → Slide-seq tutorial workload
(26,000 cells × 9,852 voxels, 249 training genes) with UMI-like statistics:
lognormal per-gene means, negative-binomial counts with per-gene dispersion,
snRNA-style dropout, and spatially smooth cell-type abundance fields on a
hex lattice, so the mapping problem is learnable. The generator also returns
the true per-spot type fractions for accuracy checks.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from . import adlite

__all__ = ["synthetic_mapping_pair"]


def _hex_coords(n_spots: int, pitch: float = 1.0) -> np.ndarray:
    """Row-staggered hex lattice with at least ``n_spots`` sites, truncated."""
    side = int(np.ceil(np.sqrt(n_spots)))
    coords = []
    for r in range(side + 1):
        for c in range(side + 1):
            coords.append(((c + 0.5 * (r % 2)) * pitch,
                           r * (np.sqrt(3.0) / 2.0) * pitch))
    return np.asarray(coords[:n_spots], dtype=np.float64)


def _nb_counts(rng, mean, dispersion):
    """Gamma–Poisson draw: Var = mean + mean²/dispersion (per-gene shape)."""
    lam = rng.gamma(shape=dispersion, scale=np.maximum(mean, 1e-12) / dispersion)
    return rng.poisson(lam)


def synthetic_mapping_pair(
    n_cells: int = 26_000,
    n_spots: int = 9_852,
    n_genes: int = 249,
    n_types: int = 22,
    random_state: int = 0,
    sc_depth: float = 1.2,
    sp_depth: float = 3.0,
    dropout: float = 0.35,
    marker_logfold: float = 1.8,
):
    """Generate a (single-cell, spatial) AnnData pair with UMI-like statistics.

    Defaults reproduce the tutorial workload shape (26k cells → 9,852 voxels,
    249 training genes, ``BASELINE.md``). Returns ``(ad_sc, ad_sp)``; the
    spatial AnnData carries ``obsm["spatial"]`` hex coordinates and
    ``uns["true_type_fractions"]`` (spots × types DataFrame) for accuracy
    evaluation; the sc AnnData carries ``obs["subclass_label"]``.
    """
    rng = np.random.default_rng(random_state)
    genes = [f"gene{i}" for i in range(n_genes)]
    types = [f"type{t}" for t in range(n_types)]

    # --- expression model -------------------------------------------------
    # base mean per gene: lognormal across ~3 orders of magnitude
    base = np.exp(rng.normal(loc=-1.0, scale=1.4, size=n_genes))
    # marker structure: each gene is boosted in 1-3 types
    n_marked = rng.integers(1, 4, size=n_genes)
    logfold = np.zeros((n_types, n_genes))
    for g in range(n_genes):
        marked = rng.choice(n_types, size=n_marked[g], replace=False)
        logfold[marked, g] = rng.normal(marker_logfold, 0.4, size=n_marked[g])
    mu = base[None, :] * np.exp(logfold)  # (types, genes)
    # per-gene NB dispersion: small shape = heavy overdispersion (UMI-like)
    dispersion = np.exp(rng.normal(loc=0.0, scale=0.7, size=n_genes)) * 0.8

    # --- single-cell side (snRNA-style) ------------------------------------
    type_props = rng.dirichlet(np.full(n_types, 3.0))
    labels = rng.choice(n_types, size=n_cells, p=type_props)
    lib_sc = np.exp(rng.normal(0.0, 0.45, size=n_cells)) * sc_depth
    X_sc = _nb_counts(
        rng, lib_sc[:, None] * mu[labels], dispersion[None, :]
    ).astype(np.float32)
    # zero inflation concentrated on lowly-expressed genes (snRNA dropout)
    p_keep = 1.0 - dropout * np.exp(-0.5 * base)[None, :]
    X_sc *= rng.random(X_sc.shape) < p_keep

    # --- spatial side (Slide-seq/Visium-style voxels) -----------------------
    coords = _hex_coords(n_spots)
    span = coords.max(axis=0) - coords.min(axis=0)
    centers = coords.min(axis=0) + rng.random((n_types, 2)) * span
    scales = (0.15 + 0.25 * rng.random(n_types)) * span.mean()
    # smooth abundance field per type: Gaussian blob + floor
    d2 = ((coords[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    field = np.exp(-0.5 * d2 / scales[None, :] ** 2) + 0.02
    fractions = field * type_props[None, :]
    fractions /= fractions.sum(axis=1, keepdims=True)  # (spots, types)

    lib_sp = np.exp(rng.normal(0.0, 0.35, size=n_spots)) * sp_depth
    mean_sp = lib_sp[:, None] * (fractions @ mu)
    X_sp = _nb_counts(rng, mean_sp, dispersion[None, :]).astype(np.float32)

    # mapping needs every gene observed somewhere on both sides; re-seed the
    # rare all-zero columns with a minimal count instead of dropping them so
    # the returned shapes are exactly as requested
    for X in (X_sc, X_sp):
        dead = ~X.any(axis=0)
        if dead.any():
            X[rng.integers(0, X.shape[0], size=int(dead.sum())),
              np.nonzero(dead)[0]] = 1.0

    ad_sc = adlite.AnnData(
        X=X_sc,
        obs=pd.DataFrame(
            {"subclass_label": pd.Categorical([types[t] for t in labels])},
            index=[f"cell{i}" for i in range(n_cells)],
        ),
        var=pd.DataFrame(index=genes),
    )
    ad_sp = adlite.AnnData(
        X=X_sp,
        obs=pd.DataFrame(index=[f"voxel{i}" for i in range(n_spots)]),
        var=pd.DataFrame(index=genes),
    )
    ad_sp.obsm["spatial"] = coords
    ad_sp.uns["true_type_fractions"] = pd.DataFrame(
        fractions, index=ad_sp.obs.index, columns=types
    )
    return ad_sc, ad_sp
