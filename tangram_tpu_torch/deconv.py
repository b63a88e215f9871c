"""Annotation transfer and segmentation-level deconvolution.

Counterpart of ``tangram_tpu/deconv.py``, host code in numpy and pandas:
``project_cell_annotations`` (ref utils.py:126), the segmentation chain
(ref utils.py:156/205/288/790) and ``cell_type_mapping`` (ref
utils.py:820). Per-object ids and coordinates come from one
``np.repeat``/``np.concatenate`` pass, per-spot per-type counts from one
``np.add.at`` scatter, and the centroid→type assignment from cumulative
count slicing, so the chain stays O(objects) at atlas scale. The mapping it
reads is the ``adata_map`` that
:func:`~tangram_tpu_torch.mapping.map_cells_to_space` returns, on the host.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd

from . import adlite

__all__ = [
    "one_hot_encoding",
    "project_cell_annotations",
    "create_segment_cell_df",
    "count_cell_annotations",
    "deconvolve_cell_annotations",
    "df_to_cell_types",
    "cell_type_mapping",
]


def one_hot_encoding(l, keep_aggregate=False):
    """Indicator DataFrame for a categorical sequence (ref utils.py:105).

    Columns follow first-appearance order of the values; with
    ``keep_aggregate`` the raw labels are kept as a leading ``"cl"`` column.
    """
    labels = l if isinstance(l, pd.Series) else pd.Series(l)
    columns = {"cl": labels} if keep_aggregate else {}
    for cat in labels.unique():
        columns[cat] = (labels == cat).astype(int)
    return pd.DataFrame(columns)


def _annotation_matrix(obs_column):
    """(codes, type_names) for an obs annotation, in one-hot column order."""
    labels = pd.Series(np.asarray(obs_column))
    types = list(pd.Series(labels).unique())
    index_of = {t: i for i, t in enumerate(types)}
    codes = labels.map(index_of).to_numpy()
    return codes, types


def project_cell_annotations(adata_map, adata_sp, annotation="cell_type", threshold=0.5):
    """Write the annotation probability map ``Mᵀ·onehot`` into
    ``adata_sp.obsm['tangram_ct_pred']``.

    ``threshold`` is accepted for signature parity but has no effect: in the
    reference (utils.py:126-153) the F_out subsetting is dead code and the
    stored result is always the unfiltered product.
    """
    del threshold
    onehot = one_hot_encoding(adata_map.obs[annotation])
    pred = pd.DataFrame(
        np.asarray(adata_map.X).T @ onehot.to_numpy(dtype=float),
        index=adata_map.var.index,
        columns=onehot.columns,
    )
    adata_sp.obsm["tangram_ct_pred"] = pred
    logging.info(
        "spatial prediction dataframe is saved in `obsm` `tangram_ct_pred` of the spatial AnnData."
    )


def create_segment_cell_df(adata_sp):
    """Flatten squidpy-style segmentation features into one row per object.

    Reads ``obsm['image_features']`` (per-spot object count in
    ``segmentation_label`` and centroid list in ``segmentation_centroid``,
    ref utils.py:156-202) and writes:

    - ``uns['tangram_cell_segmentation']``: columns spot_idx / y / x /
      centroids, one row per segmented object;
    - ``obsm['tangram_spot_centroids']``: per-spot arrays of object ids.
    """
    if "image_features" not in adata_sp.obsm.keys():
        raise ValueError(
            "Missing parameter for tangram deconvolution. Run `sqidpy.im.calculate_image_features`."
        )

    feats = adata_sp.obsm["image_features"]
    counts = np.asarray(feats["segmentation_label"], dtype=np.int64)
    spot_ids = np.asarray(adata_sp.obs.index, dtype=object)
    total = int(counts.sum())

    # Object ids "<spot>_<j>" for j in range(count), built in one repeat pass.
    owner = np.repeat(np.arange(len(counts)), counts)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(total) - bounds[owner]
    object_ids = np.array(
        np.char.add(
            np.char.add(spot_ids[owner].astype(str), "_"), within.astype(str)
        ),
        dtype=object,
    )

    per_spot_ids = [
        object_ids[bounds[i] : bounds[i + 1]] for i in range(len(counts))
    ]
    spot_centroids = pd.Series(per_spot_ids, index=feats.index, name="centroids_idx")

    # Centroid coordinates, stored as (y, x) pairs per spot.
    coord_blocks = [
        np.asarray(list(c), dtype=float).reshape(-1, 2)
        for c in feats["segmentation_centroid"]
    ]
    coords = (
        np.concatenate(coord_blocks, axis=0) if coord_blocks else np.empty((0, 2))
    )
    if coords.shape[0] != total:
        raise ValueError(
            "segmentation_centroid lengths disagree with segmentation_label counts"
        )

    segmentation_df = pd.DataFrame(
        {
            "spot_idx": spot_ids[owner],
            "y": coords[:, 0],
            "x": coords[:, 1],
            "centroids": object_ids,
        }
    )

    adata_sp.uns["tangram_cell_segmentation"] = segmentation_df
    adata_sp.obsm["tangram_spot_centroids"] = spot_centroids
    logging.info(
        "cell segmentation dataframe is saved in `uns` `tangram_cell_segmentation` of the spatial AnnData."
    )
    logging.info(
        "spot centroids is saved in `obsm` `tangram_spot_centroids` of the spatial AnnData."
    )


def count_cell_annotations(adata_map, adata_sc, adata_sp, annotation="cell_type", threshold=0.5):
    """Per-spot, per-type counts of mapped cells (ref utils.py:205-285).

    Each cell is assigned to its argmax spot; constrained-mode runs keep only
    cells with ``F_out > threshold``. The counts land in a single
    ``np.add.at`` scatter instead of a per-cell DataFrame loop, and the
    result (spot coordinates, object counts, centroid ids, one count column
    per type) goes to ``obsm['tangram_ct_count']``.
    """
    for key, owner, hint in [
        ("spatial", adata_sp.obsm, None),
        ("image_features", adata_sp.obsm, "sqidpy.im.calculate_image_features"),
        ("tangram_cell_segmentation", adata_sp.uns, "create_segment_cell_df"),
        ("tangram_spot_centroids", adata_sp.obsm, "create_segment_cell_df"),
    ]:
        if key in owner.keys():
            continue
        if key == "spatial":
            raise ValueError(
                "Missing spatial information in AnnDatas. Please make sure coordinates are saved with AnnData.obsm['spatial']"
            )
        raise ValueError(
            f"Missing parameter for tangram deconvolution. Run `{hint}`."
        )

    n_spots = adata_sp.n_obs
    top_spot = np.argmax(np.asarray(adata_map.X), axis=1)
    codes, types = _annotation_matrix(adata_sc.obs[annotation])

    if "F_out" in adata_map.obs.keys():
        keep = np.asarray(adata_map.obs["F_out"]) > threshold
    else:
        keep = np.ones(len(top_spot), dtype=bool)

    counts = np.zeros((n_spots, len(types)), dtype=np.int64)
    np.add.at(counts, (top_spot[keep], codes[keep]), 1)

    coords = np.asarray(adata_sp.obsm["spatial"])
    table = pd.DataFrame(
        {
            "x": coords[:, 1],
            "y": coords[:, 0],
            "cell_n": adata_sp.obsm["image_features"]["segmentation_label"],
            "centroids": adata_sp.obsm["tangram_spot_centroids"],
        },
        index=list(adata_sp.obs.index),
    )
    for j, t in enumerate(types):
        table[t] = counts[:, j]

    adata_sp.obsm["tangram_ct_count"] = table
    logging.info(
        "spatial cell count dataframe is saved in `obsm` `tangram_ct_count` of the spatial AnnData."
    )


def df_to_cell_types(df, cell_types):
    """Distribute each spot's centroid ids over its per-type counts.

    Within a spot the first ``df[t0]`` centroids belong to type ``t0``, the
    next ``df[t1]`` to ``t1``, and so on (cumulative slicing, ref
    utils.py:790-818; slices clamp at the available centroid count).
    Returns ``{cell_type: [centroid ids]}`` ordered by spot.
    """
    counts = df[list(cell_types)].to_numpy(dtype=np.int64)
    centroid_arrays = list(df["centroids"])
    lengths = np.array([len(c) for c in centroid_arrays], dtype=np.int64)

    # Per-row slice boundaries for each type, clamped to the row's centroids.
    ends = np.minimum(np.cumsum(counts, axis=1), lengths[:, None])
    starts = np.concatenate([np.zeros((len(counts), 1), np.int64), ends[:, :-1]], axis=1)
    taken_per_type = ends - starts

    taken = [c[:e] for c, e in zip(centroid_arrays, ends[:, -1])]
    flat = np.concatenate(taken) if taken else np.empty(0, dtype=object)
    # Type label of every taken centroid, rows outer / types inner — matching
    # the flattened order of `flat`.
    labels = np.repeat(
        np.tile(np.arange(len(cell_types)), len(counts)), taken_per_type.ravel()
    )

    return {
        t: list(flat[labels == j]) for j, t in enumerate(cell_types)
    }


def deconvolve_cell_annotations(adata_sp, filter_cell_annotation=None):
    """Produce a segmentation-level AnnData with a ``cluster`` call per
    object (ref utils.py:288-335): per-spot counts are converted to
    object→type assignments and joined back onto the segmentation table.
    """
    if (
        "tangram_ct_count" not in adata_sp.obsm.keys()
        or "tangram_cell_segmentation" not in adata_sp.uns.keys()
    ):
        raise ValueError("Missing tangram parameters. Run `count_cell_annotations`.")

    if filter_cell_annotation is None:
        annotations = pd.unique(
            np.asarray(adata_sp.obsm["tangram_ct_pred"].columns)
        )
    else:
        annotations = pd.unique(np.asarray(filter_cell_annotation))

    assigned = df_to_cell_types(adata_sp.obsm["tangram_ct_count"], annotations)
    sizes = [len(assigned[t]) for t in annotations]
    calls = pd.DataFrame(
        {
            "centroids": np.concatenate(
                [np.asarray(assigned[t], dtype=object) for t in annotations]
            )
            if sum(sizes)
            else np.empty(0, dtype=object),
            "cluster": np.repeat(np.asarray(annotations, dtype=object), sizes),
        }
    )

    segmentation_df = adata_sp.uns["tangram_cell_segmentation"]
    merged = (
        segmentation_df.merge(calls, on="centroids", how="inner")
        .drop(columns="spot_idx")
        .drop_duplicates()
        .dropna()
        .reset_index(drop=True)
    )

    adata_segment = adlite.AnnData(np.zeros(merged.shape), obs=merged)
    adata_segment.obsm["spatial"] = merged[["y", "x"]].to_numpy()
    adata_segment.uns = adata_sp.uns
    return adata_segment


def cell_type_mapping(adata_map, cell_types_key="cell_types"):
    """Min-max-normalized type × spot intensity map into
    ``adata_map.varm['ct_map']`` (ref utils.py:820-842). Constrained-mode
    maps only aggregate cells whose ``F_out`` passes 0.5.
    """
    onehot = one_hot_encoding(adata_map.obs[cell_types_key])
    M = np.asarray(adata_map.X)
    indicator = onehot.to_numpy(dtype=float)

    if "F_out" in adata_map.obs.keys():
        selected = np.asarray(adata_map.obs["F_out"]) >= 0.5
        M = M[selected]
        indicator = indicator[selected]

    intensity = pd.DataFrame(
        M.T @ indicator, index=adata_map.var.index, columns=onehot.columns
    )
    span = intensity.max() - intensity.min()
    adata_map.varm["ct_map"] = (intensity - intensity.min()) / span
