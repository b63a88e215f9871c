"""Training-gene selection strategies, the counterpart of
``tangram_tpu/gene_selection.py`` (host code in numpy, pandas and scipy).

The reference ``gene_selection/`` package wraps scanpy and two external
packages: ``ctg`` (cell-type markers via ``sc.tl.rank_genes_groups``),
``hvg`` (``sc.pp.highly_variable_genes``), ``spapros`` (theislab/spapros
probeset selection) and ``svg`` (SpatialDE spatially variable genes). The
statistical selections are written out here (no scanpy), and the external
packages are used when they are installed:

* :func:`ctg` — per-cluster t-test marker ranking (scanpy's default method),
  top 150 per group, union.
* :func:`hvg` — Seurat-flavor dispersion-based highly variable genes.
* :func:`svg` — spatially variable genes by per-gene Moran's I on the spot
  graph of :func:`~tangram_tpu_torch.spatial.spatial_neighbors`, with an
  analytic z-test and Benjamini-Hochberg correction (SpatialDE instead
  when importable and ``method='spatialde'``).
* :func:`spapros` — requires the external package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .spatial import sparse_weights, spatial_neighbors

__all__ = ["ctg", "hvg", "svg", "spapros"]


def _dense(X):
    return np.asarray(
        X.toarray() if sp.issparse(X) or hasattr(X, "toarray") else X,
        dtype=np.float64,
    )


def ctg(adata_sc, cluster_label: str, n_genes: int = 150):
    """Cell-type-specific marker genes: Welch t-test of each cluster vs the
    rest, top ``n_genes`` per cluster, unique union (reference
    ``celltype_specific_genes.py:9-11``)."""
    X = _dense(adata_sc.X)
    labels = np.asarray(adata_sc.obs[cluster_label])
    genes = np.asarray(adata_sc.var.index)

    selected = set()
    for group in pd.unique(labels):
        in_mask = labels == group
        n_in, n_out = in_mask.sum(), (~in_mask).sum()
        if n_in < 2 or n_out < 2:
            continue
        mean_in = X[in_mask].mean(axis=0)
        mean_out = X[~in_mask].mean(axis=0)
        var_in = X[in_mask].var(axis=0, ddof=1)
        var_out = X[~in_mask].var(axis=0, ddof=1)
        denom = np.sqrt(var_in / n_in + var_out / n_out)
        denom[denom == 0] = np.inf
        scores = (mean_in - mean_out) / denom
        top = np.argsort(scores)[::-1][:n_genes]
        selected.update(genes[top])
    return sorted(selected)


def hvg(adata_sc, n_top_genes: int = 4000, n_bins: int = 20):
    """Highly variable genes, Seurat flavor: dispersion = var/mean, z-scored
    within mean bins, top ``n_top_genes`` (reference
    ``highly_variable_genes.py:7-8``; algorithm per scanpy's seurat flavor)."""
    X = _dense(adata_sc.X)
    # seurat flavor operates on expm1 of log data; accept raw counts too —
    # the ranking is monotone either way for non-negative data
    mean = X.mean(axis=0)
    var = X.var(axis=0, ddof=1)
    mean_nz = np.where(mean == 0, 1e-12, mean)
    dispersion = var / mean_nz

    df = pd.DataFrame({"mean": mean, "dispersion": dispersion})
    df["bin"] = pd.cut(df["mean"], bins=n_bins)
    grouped = df.groupby("bin", observed=True)["dispersion"]
    bin_mean = grouped.transform("mean")
    bin_std = grouped.transform("std")
    # seurat-flavor singleton-bin rule (as in scanpy): a gene alone in its
    # mean bin gets normalized dispersion 1.0
    singleton = bin_std.isna() | (bin_std == 0)
    bin_std = bin_std.where(~singleton, bin_mean)
    bin_mean = bin_mean.where(~singleton, 0.0)
    df["dispersion_norm"] = (
        (df["dispersion"] - bin_mean) / bin_std.replace(0, np.nan)
    ).fillna(0.0)

    n_top = min(n_top_genes, len(df))
    order = np.argsort(df["dispersion_norm"].to_numpy())[::-1][:n_top]
    genes = np.asarray(adata_sc.var.index)
    keep = np.zeros(len(genes), bool)
    keep[order] = True
    return list(genes[keep])


def svg(adata_st, alpha: float = 0.05, method: str = "moran", n_neighs: int = 6):
    """Spatially variable genes (reference ``spatially_variable_genes.py``).

    ``method='moran'`` (native): per-gene Moran's I on the KNN spot graph,
    analytic z-test under the normality null, Benjamini-Hochberg adjusted;
    genes with padj < ``alpha``. ``method='spatialde'`` delegates to the
    external SpatialDE package when installed.
    """
    if method == "spatialde":
        import SpatialDE  # external, optional

        adata_st.X = adata_st.raw.X
        svg_full, _ = SpatialDE.test(adata_st, omnibus=True)
        return svg_full[svg_full.padj < alpha].gene

    if not {"spatial_connectivities", "spatial_distances"}.issubset(
        set(adata_st.obsp.keys())
    ):
        spatial_neighbors(adata_st, n_neighs=n_neighs)
    # Everything below is O(nnz) in the spot graph: the Moran numerator is
    # Σ_g z ⊙ (W z) and the variance moments are sparse sums — no dense s×s
    # matrix, no O(s²·g) einsum, so 50k+ spots stay cheap on the host.
    W = sparse_weights(adata_st, standardized=True)

    X = _dense(adata_st.X)
    n = X.shape[0]
    z = X - X.mean(axis=0)
    denom = (z * z).sum(axis=0)
    denom[denom == 0] = np.inf
    S0 = W.sum()
    moran = (n / S0) * np.einsum("ig,ig->g", z, W @ z) / denom

    # analytic moments under the normality assumption
    EI = -1.0 / (n - 1)
    S1 = 0.5 * (W + W.T).power(2).sum()
    row_sums = np.asarray(W.sum(axis=1)).ravel()
    col_sums = np.asarray(W.sum(axis=0)).ravel()
    S2 = ((row_sums + col_sums) ** 2).sum()
    var_I = (
        (n * n * S1 - n * S2 + 3 * S0 * S0) / ((n * n - 1) * S0 * S0)
        - EI * EI
    )
    var_I = max(var_I, 1e-12)
    zscores = (moran - EI) / np.sqrt(var_I)

    from scipy.stats import norm

    pvals = norm.sf(zscores)  # one-sided: positive spatial autocorrelation
    # Benjamini-Hochberg
    order = np.argsort(pvals)
    ranked = pvals[order] * len(pvals) / (np.arange(len(pvals)) + 1)
    padj = np.minimum.accumulate(ranked[::-1])[::-1]
    padj_full = np.empty_like(padj)
    padj_full[order] = np.clip(padj, 0, 1)

    genes = np.asarray(adata_st.var.index)
    result = pd.DataFrame(
        {"gene": genes, "moran_i": moran, "pval": pvals, "padj": padj_full}
    )
    adata_st.uns["svg_results"] = result
    return list(result[result["padj"] < alpha]["gene"])


def spapros(adata_sc):
    """Spapros probeset selection — requires the external package
    (reference ``spapros_genes.py``)."""
    try:
        import spapros as sprs
    except ImportError as err:
        raise ImportError(
            "spapros is required for probeset selection: "
            "https://github.com/theislab/spapros"
        ) from err
    selector = sprs.se.ProbesetSelector(adata_sc)
    selector.select_probeset()
    return selector.probeset.index[selector.probeset["selection"]].to_list()
