"""Plotting suite: training diagnostics, spatial maps, and evaluation curves.

The counterpart of ``tangram_tpu/plot_utils.py``: the 13 public plot
functions of the reference (``plot_utils.py`` of broadinstitute/Tangram)
on a few shared primitives: a 4-panel score dashboard
(`_score_dashboard`), a horizontal unit colorbar (`_unit_colorbar`), an
ordered value scatter (`_value_scatter`) and a spatial renderer
(`_render_spatial`) that uses ``scanpy.pl.spatial`` when scanpy is
installed and an internal matplotlib fallback (:func:`_spatial_scatter`)
otherwise. Host code: matplotlib and seaborn are imported inside the
functions that draw, so importing this module needs neither.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import scipy.sparse as sp

from . import utils as ut

__all__ = [
    "q_value",
    "plot_training_scores",
    "plot_gene_sparsity",
    "ordered_predictions",
    "convert_adata_array",
    "construct_obs_plot",
    "plot_cell_annotation_sc",
    "plot_cell_annotation",
    "plot_genes_sc",
    "plot_genes",
    "quick_plot_gene",
    "plot_annotation_entropy",
    "plot_test_scores",
    "plot_auc",
    "mapping_colors",
]

_SPARSITY_PANELS = (
    ("sparsity_sc", "score vs sparsity (single cells)"),
    ("sparsity_sp", "score vs sparsity (spatial)"),
    ("sparsity_diff", "score vs sparsity (sp - sc)"),
)


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _require_robust_perc(robust, perc):
    """The reference's paired validation of (robust, perc)
    (ref plot_utils.py:227-231 and equivalents)."""
    if not robust and perc != 0:
        raise ValueError("Arg perc is zero when robust is False.")
    if robust and perc == 0:
        raise ValueError("Arg perc cannot be zero when robust is True.")


def _have_scanpy():
    try:
        import scanpy  # noqa: F401

        return True
    except ImportError:
        return False


def q_value(data, perc):
    """Symmetric percentile color range: (perc-th, (100−perc)-th)
    (ref plot_utils.py:22-36)."""
    return np.nanpercentile(data, perc), np.nanpercentile(data, 100 - perc)


def ordered_predictions(xs, ys, preds, reverse=False):
    """Sort (x, y, value) triples by value so strong signal draws on top
    (ref plot_utils.py:132-155)."""
    assert len(xs) == len(ys) == len(preds)
    order = np.argsort(np.asarray(preds))
    if reverse:
        order = order[::-1]
    return (
        list(np.asarray(xs)[order]),
        list(np.asarray(ys)[order]),
        list(np.asarray(preds)[order]),
    )


def convert_adata_array(adata):
    """Densify ``adata.X`` in place (ref plot_utils.py:158-160)."""
    if sp.issparse(adata.X) or hasattr(adata.X, "toarray"):
        adata.X = adata.X.toarray()


def construct_obs_plot(df_plot, adata, perc=0, suffix=None):
    """Percentile-clip, min-max normalize and append plotting columns to
    ``adata.obs`` (ref plot_utils.py:163-172)."""
    clipped = df_plot.clip(
        df_plot.quantile(perc), df_plot.quantile(1 - perc), axis=1
    )
    normalized = (clipped - clipped.min()) / (clipped.max() - clipped.min())
    if suffix:
        normalized = normalized.add_suffix(f" ({suffix})")
    adata.obs = pd.concat([adata.obs, normalized], axis=1)


def _gene_vector(adata, gene):
    """Expression column of one gene, or zeros when absent."""
    if gene not in adata.var.index:
        return np.zeros(adata.n_obs)
    return np.asarray(adata[:, gene].X).ravel()


def _score_dashboard(df, value_col, bins, alpha, color=None):
    """One histogram + three score-vs-sparsity scatter panels, all on the
    unit square (layout shared by plot_training_scores / plot_test_scores,
    ref plot_utils.py:39-94 and :609-659)."""
    import seaborn as sns

    plt = _plt()
    fig, axs = plt.subplots(1, 4, figsize=(12, 3), sharey=True)
    panels = axs.flatten()
    panels[0].set_ylim([0.0, 1.0])

    sns.histplot(data=df, y=value_col, bins=bins, ax=panels[0], color=color)
    for ax, (col, title) in zip(panels[1:], _SPARSITY_PANELS):
        ax.set_xlim([0.0, 1.0])
        ax.set_ylim([0.0, 1.0])
        ax.set_title(title)
        sns.scatterplot(
            data=df, y=value_col, x=col, ax=ax, alpha=alpha, color=color
        )
    plt.tight_layout()
    return fig


def plot_training_scores(adata_map, bins=10, alpha=0.7):
    """Training diagnosis: per-gene score histogram + sparsity scatters
    (ref plot_utils.py:39-94)."""
    return _score_dashboard(
        adata_map.uns["train_genes_df"], "train_score", bins, alpha, "coral"
    )


def plot_test_scores(df_gene_score, bins=10, alpha=0.7):
    """Held-out score diagnosis on a compare_spatial_geneexp table
    (ref plot_utils.py:609-659)."""
    needed = {"score", "sparsity_sc", "sparsity_sp", "sparsity_diff"}
    if not needed <= set(df_gene_score.columns):
        raise ValueError(
            "There are missing columns in df_gene_score. Run `compare_spatial_geneexp` "
            "with `adata_ge`, `adata_sp`, and `adata_sc` to produce complete dataframe input."
        )
    df = df_gene_score
    if "is_training" in df.keys():
        df = df[df["is_training"] == False]
    df = df.rename({"score": "test_score"}, axis="columns")
    return _score_dashboard(df, "test_score", bins, alpha)


def plot_gene_sparsity(adata_1, adata_2, xlabel="adata_1", ylabel="adata_2", genes=None, s=1):
    """Per-gene sparsity of one AnnData against another
    (ref plot_utils.py:97-129)."""
    from .mapping import pp_adatas

    plt = _plt()
    pp_adatas(adata_1, adata_2, genes=genes)
    assert adata_1.uns["training_genes"] == adata_2.uns["training_genes"]
    shared = adata_1.uns["training_genes"]

    for adata in (adata_1, adata_2):
        ut.annotate_gene_sparsity(adata)
    sparsity_1 = adata_1[:, shared].var["sparsity"].values
    sparsity_2 = adata_2[:, shared].var["sparsity"].values

    fig, ax = plt.subplots(1, 1)
    ax.set_aspect(1)
    ax.set_xlabel(f"sparsity ({xlabel})")
    ax.set_ylabel(f"sparsity ({ylabel})")
    ax.set_title(f"Gene sparsity ({len(shared)} genes)")
    ax.scatter(sparsity_1, sparsity_2, s=s, marker="x")
    return fig


# ---------------------------------------------------------------------------
# spatial rendering
# ---------------------------------------------------------------------------


def _spatial_scatter(
    adata, color, spot_size=None, scale_factor=None, cmap="viridis",
    alpha_img=1.0, bw=False, ax=None, title=None,
):
    """Minimal scanpy.pl.spatial equivalent: scatter obsm['spatial'] colored
    by an obs column, with optional tissue image from uns['spatial']."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()

    coords = np.asarray(adata.obsm["spatial"], dtype=float)
    sf = scale_factor
    size = spot_size

    library = adata.uns.get("spatial")
    if isinstance(library, dict) and library:
        entry = library[next(iter(library))]
        scalefactors = entry.get("scalefactors", {}) if isinstance(entry, dict) else {}
        sf = sf or scalefactors.get("tissue_hires_scalef", 1.0)
        if size is None:
            size = scalefactors.get("spot_diameter_fullres", 30.0)
        images = entry.get("images", {}) if isinstance(entry, dict) else {}
        if images:
            img = np.asarray(images.get("hires", next(iter(images.values()))))
            if bw:
                img = img.mean(axis=-1)
            ax.imshow(img, alpha=alpha_img, cmap="gray" if bw else None)
    else:
        sf = sf or 1.0
        if size is None:
            size = 30.0

    points = ax.scatter(
        coords[:, 0] * sf, coords[:, 1] * sf,
        c=np.asarray(adata.obs[color], dtype=float), s=size, cmap=cmap,
    )
    ax.set_title(title or color)
    ax.set_aspect("equal")
    ax.invert_yaxis()
    ax.axis("off")
    plt.colorbar(points, ax=ax, shrink=0.7)
    return ax


def _render_spatial(adata, color, *, spot_size, scale_factor, cmap,
                    alpha_img, bw, ax):
    """Spatial panels: scanpy when available, internal fallback otherwise.

    ``color`` is a list of obs columns; ``ax`` is a matching list of axes
    (or None to let scanpy lay the panels out itself)."""
    if _have_scanpy():
        import scanpy as scp

        scp.pl.spatial(
            adata, color=color, cmap=cmap, show=False, frameon=False,
            spot_size=spot_size, scale_factor=scale_factor,
            alpha_img=alpha_img, bw=bw,
            ax=ax[0] if isinstance(ax, (list, np.ndarray)) and len(ax) == 1 else ax,
        )
    else:
        axes = ax
        if axes is None:
            _, axes = _plt().subplots(1, len(color), figsize=(4 * len(color), 4))
            axes = np.atleast_1d(axes)
        for name, one_ax in zip(color, axes):
            _spatial_scatter(
                adata, name, spot_size=spot_size, scale_factor=scale_factor,
                cmap=cmap, alpha_img=alpha_img, bw=bw, ax=one_ax,
            )


def _ensure_spatial_coords(adata, x, y):
    if "spatial" not in adata.obsm.keys():
        adata.obsm["spatial"] = np.column_stack(
            [np.asarray(adata.obs[x].values), np.asarray(adata.obs[y].values)]
        )


def _check_spatial_args(adata, spot_size, scale_factor, strict_exclusive):
    has_library = "spatial" in adata.uns.keys()
    if not has_library and spot_size is None and scale_factor is None:
        raise ValueError(
            "Spot Size and Scale Factor cannot be None when ad_sp.uns['spatial'] does not exist"
        )
    if (
        strict_exclusive
        and has_library
        and spot_size is not None
        and scale_factor is not None
    ):
        raise ValueError(
            "Spot Size and Scale Factor should be None when ad_sp.uns['spatial'] exists"
        )


def plot_cell_annotation_sc(
    adata_sp, annotation_list, x="x", y="y", spot_size=None, scale_factor=None,
    perc=0, alpha_img=1.0, bw=False, ax=None,
):
    """Spatial probability maps of transferred annotations, one panel per
    annotation (ref plot_utils.py:175-213). Consumes
    ``obsm['tangram_ct_pred']`` (from project_cell_annotations) and leaves
    ``obs`` unmodified on exit."""
    adata_sp.obs.drop(annotation_list, inplace=True, errors="ignore", axis=1)
    construct_obs_plot(
        adata_sp.obsm["tangram_ct_pred"][annotation_list], adata_sp, perc=perc
    )
    _ensure_spatial_coords(adata_sp, x, y)
    _check_spatial_args(adata_sp, spot_size, scale_factor, strict_exclusive=True)

    _render_spatial(
        adata_sp, annotation_list, spot_size=spot_size,
        scale_factor=scale_factor, cmap="viridis", alpha_img=alpha_img,
        bw=bw, ax=None if ax is None else [ax] * len(annotation_list),
    )

    adata_sp.obs.drop(annotation_list, inplace=True, errors="ignore", axis=1)


def _unit_colorbar(cmap_name, label):
    """Standalone horizontal [0, 1] colorbar strip (the reference draws one
    above its scatter grids, ref plot_utils.py:256-263 and :500-507)."""
    import matplotlib as mpl

    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 0.4))
    fig.subplots_adjust(top=0.5)
    cmap = plt.get_cmap(cmap_name) if isinstance(cmap_name, str) else cmap_name
    mpl.colorbar.ColorbarBase(
        ax, cmap=cmap, norm=mpl.colors.Normalize(vmin=0, vmax=1),
        orientation="horizontal", label=label,
    )
    return cmap


def _value_scatter(ax, xs, ys, values, *, s, cmap, robust, perc, log=False,
                   title=None, invert_y=False, clamp=True):
    """Ordered scatter of a value map with percentile color limits.

    ``clamp=False`` skips the vmin/vmax limits entirely (matplotlib
    normalizes over the plotted values) — the reference's measured panel
    behaves this way, while its predicted panels clamp to the PRE-log value
    range even when ``log`` is set (quirk preserved, ref plot_utils.py:535-542).
    """
    xs, ys, values = ordered_predictions(xs, ys, values)
    limits = {}
    if clamp:
        vmin, vmax = q_value(values, perc=perc if robust else 0)
        limits = {"vmin": vmin, "vmax": vmax}
    if log:
        values = np.log(1 + np.asarray(values))
    ax.scatter(xs, ys, c=values, cmap=cmap, s=s, **limits)
    if title:
        ax.set_title(title)
    ax.axis("off")
    ax.set_aspect(1)
    if invert_y:
        ax.invert_yaxis()


def plot_cell_annotation(
    adata_map, adata_sp, annotation="cell_type", x="x", y="y", nrows=1, ncols=1,
    s=5, cmap="viridis", subtitle_add=False, robust=False, perc=0, invert_y=True,
):
    """Transfer an annotation and scatter its per-type probability maps
    (ref plot_utils.py:216-313)."""
    plt = _plt()
    _require_robust_perc(robust, perc)

    ut.project_cell_annotations(adata_map, adata_sp, annotation=annotation)
    prob_maps = adata_sp.obsm["tangram_ct_pred"]

    cmap = _unit_colorbar(cmap, "Probability")

    if nrows is None or ncols is None:
        nrows, ncols = len(prob_maps.columns), 1
    fig, axs = plt.subplots(
        nrows, ncols, figsize=(ncols * 3, nrows * 3), sharex=True, sharey=True
    )
    panels = np.atleast_1d(axs).flatten()
    if invert_y:
        panels[0].invert_yaxis()
    for ax in panels:
        ax.axis("off")

    if len(prob_maps.columns) > len(panels):
        logging.warning(
            "Number of panels smaller than annotations. Increase `nrows`/`ncols`."
        )

    for ax, name in zip(panels, prob_maps.columns):
        _value_scatter(
            ax, adata_map.var[x], adata_map.var[y], prob_maps[name],
            s=s, cmap=cmap, robust=robust, perc=perc, title=name,
        )

    if subtitle_add:
        fig.suptitle(annotation)
    return fig


def plot_genes_sc(
    genes, adata_measured, adata_predicted, x="x", y="y", spot_size=None,
    scale_factor=None, cmap="inferno", perc=0, alpha_img=1.0, bw=False,
    return_figure=False,
):
    """Measured-vs-predicted spatial maps per gene, rendered through the
    spatial backend (ref plot_utils.py:316-447)."""
    from matplotlib.gridspec import GridSpec

    plt = _plt()
    labeled = {
        "measured": [f"{g} (measured)" for g in genes],
        "predicted": [f"{g} (predicted)" for g in genes],
    }
    adata_measured.obs.drop(labeled["measured"], inplace=True, errors="ignore", axis=1)
    adata_predicted.obs.drop(labeled["predicted"], inplace=True, errors="ignore", axis=1)

    convert_adata_array(adata_measured)
    for adata in (adata_measured, adata_predicted):
        adata.var.index = [g.lower() for g in adata.var.index]
    adata_predicted.obsm = adata_measured.obsm
    adata_predicted.uns = adata_measured.uns

    measured_df = pd.DataFrame(
        {g: _gene_vector(adata_measured, g) for g in genes},
        index=adata_measured.obs.index,
    )
    construct_obs_plot(measured_df, adata_measured, suffix="measured")

    predicted_df = pd.DataFrame(
        np.asarray(adata_predicted[:, genes].X),
        columns=genes, index=adata_predicted.obs.index,
    )
    construct_obs_plot(predicted_df, adata_predicted, perc=perc, suffix="predicted")

    for adata in (adata_measured, adata_predicted):
        _ensure_spatial_coords(adata, x, y)
    _check_spatial_args(adata_measured, spot_size, scale_factor, strict_exclusive=False)

    fig = plt.figure(figsize=(7, len(genes) * 3.5))
    grid = GridSpec(len(genes), 2, figure=fig)
    for row, gene in enumerate(genes):
        for col, (adata, kind) in enumerate(
            [(adata_measured, "measured"), (adata_predicted, "predicted")]
        ):
            panel = fig.add_subplot(grid[row, col])
            _render_spatial(
                adata, [f"{gene} ({kind})"], spot_size=spot_size,
                scale_factor=scale_factor, cmap=cmap, alpha_img=alpha_img,
                bw=bw, ax=[panel],
            )

    adata_measured.obs.drop(labeled["measured"], inplace=True, errors="ignore", axis=1)
    adata_predicted.obs.drop(labeled["predicted"], inplace=True, errors="ignore", axis=1)
    if return_figure:
        return fig


def plot_genes(
    genes, adata_measured, adata_predicted, x="x", y="y", s=5, log=False,
    cmap="inferno", robust=False, perc=0, invert_y=True,
):
    """Measured-vs-predicted spatial patterns as raw coordinate scatters
    (ref plot_utils.py:450-549)."""
    plt = _plt()
    _require_robust_perc(robust, perc)

    convert_adata_array(adata_measured)
    for adata in (adata_measured, adata_predicted):
        adata.var.index = [g.lower() for g in adata.var.index]

    cmap = _unit_colorbar(cmap, "Expression Level")

    fig, axs = plt.subplots(nrows=len(genes), ncols=2, figsize=(6, len(genes) * 3))
    axs = np.atleast_2d(axs)
    for row, gene in enumerate(genes):
        _value_scatter(
            axs[row, 0],
            adata_measured.obs[x], adata_measured.obs[y],
            _gene_vector(adata_measured, gene),
            s=s, cmap=cmap, robust=False, perc=0, log=log,
            title=f"{gene} (measured)", invert_y=invert_y, clamp=False,
        )
        _value_scatter(
            axs[row, 1],
            adata_predicted.obs[x], adata_predicted.obs[y],
            np.asarray(adata_predicted[:, gene].X).ravel(),
            s=s, cmap=cmap, robust=robust, perc=perc, log=log,
            title=f"{gene} (predicted)", invert_y=invert_y,
        )
    return fig


def quick_plot_gene(
    gene, adata, x="x", y="y", s=50, log=False, cmap="viridis", robust=False, perc=0
):
    """One-gene spatial scatter on the current axes
    (ref plot_utils.py:552-587)."""
    plt = _plt()
    _require_robust_perc(robust, perc)
    xs, ys, vs = ordered_predictions(
        adata.obs[x], adata.obs[y], np.asarray(adata[:, gene].X).ravel()
    )
    vmin, vmax = q_value(vs, perc=perc if robust else 0)
    if log:
        vs = np.log(1 + np.asarray(vs))
    plt.scatter(xs, ys, c=vs, cmap=cmap, s=s, vmin=vmin, vmax=vmax)


def plot_annotation_entropy(adata_map, annotation="cell_type"):
    """Boxen plot of per-cell mapping entropy grouped by annotation
    (ref plot_utils.py:590-606)."""
    import seaborn as sns
    from scipy.stats import entropy

    plt = _plt()
    adata_map.obs["entropy"] = entropy(
        adata_map.X, base=adata_map.X.shape[1], axis=1
    )
    fig, ax = plt.subplots(1, 1, figsize=(10, 3))
    ax.set_ylim(0, 1)
    sns.boxenplot(x=annotation, y="entropy", data=adata_map.obs, ax=ax)
    plt.xticks(rotation=30)
    return fig


def plot_auc(df_all_genes, test_genes=None):
    """Score-vs-sparsity cloud with the fitted AUC curve
    (ref plot_utils.py:662-692)."""
    import seaborn as sns

    plt = _plt()
    metrics, ((curve_x, curve_y), (xs, ys)) = ut.eval_metric(df_all_genes, test_genes)

    fig = plt.figure(figsize=(6, 5))
    plt.plot(curve_x, curve_y, c="r")
    sns.scatterplot(x=xs, y=ys, alpha=0.5, edgecolors="face")

    plt.xlim([0.0, 1.0])
    plt.ylim([0.0, 1.0])
    plt.gca().set_aspect(0.5)
    plt.xlabel("score")
    plt.ylabel("spatial sparsity")
    plt.tick_params(axis="both", labelsize=8)
    plt.title("Prediction on test transcriptome")
    plt.text(
        0.03, 0.1,
        "auc_score={}".format(np.round(metrics["auc_score"], 3)),
        fontsize=11, verticalalignment="top",
        bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.3),
    )
    return fig


# Manuscript color table for deterministic cell-type color assignment
# (reference ``plot_utils.py:696-724`` — a data table, reproduced verbatim).
mapping_colors = {
    "L6 CT": (0.19215686274509805, 0.5098039215686274, 0.7411764705882353),
    "L6 IT": (0.4196078431372549, 0.6823529411764706, 0.8392156862745098),
    "L5/6 NP": (0.6196078431372549, 0.792156862745098, 0.8823529411764706),
    "L6b": "#0000c2ff",
    "L2/3 IT": (0.9019607843137255, 0.3333333333333333, 0.050980392156862744),
    "L5 IT": (0.19215686274509805, 0.6392156862745098, 0.32941176470588235),
    "L5 ET": (0.4549019607843137, 0.7686274509803922, 0.4627450980392157),
    "Oligo": (0.4588235294117647, 0.4196078431372549, 0.6941176470588235),
    "Vip": (0.6196078431372549, 0.6039215686274509, 0.7843137254901961),
    "Astro": "#ffdd55ff",
    "Micro-PVM": "#000000ff",
    "Pvalb": (0.38823529411764707, 0.38823529411764707, 0.38823529411764707),
    "Lamp5": (0.5882352941176471, 0.5882352941176471, 0.5882352941176471),
    "Sst": (0.7411764705882353, 0.7411764705882353, 0.7411764705882353),
    "Sst Chodl": (0.8509803921568627, 0.8509803921568627, 0.8509803921568627),
    "Sncg": (0.5176470588235295, 0.23529411764705882, 0.2235294117647059),
    "Peri": (0.6784313725490196, 0.28627450980392155, 0.2901960784313726),
    "VLMC": (0.8392156862745098, 0.3803921568627451, 0.4196078431372549),
    "Endo": (0.9058823529411765, 0.5882352941176471, 0.611764705882353),
    "Meis2": "#FFA500ff",
    "SMC": "#000000ff",
    "L6 PT": "#4682B4ff",
    "L5 PT": "#a1ed7bff",
    "L5 NP": "#6B8E23ff",
    "L4": "#d61f1dff",
    "Macrophage": "#2b2d2fff",
    "CR": "#000000ff",
}
