"""Tutorial: constrained mapping + segmentation-based deconvolution.

A runnable equivalent of the reference's squidpy tutorial flow: constrained
mapping with a learned cell filter, spot segmentation features, per-spot
cell-type counts, and segment-level annotation assignment.

Run: ``python -m tangram_tpu_torch.examples.tutorial_deconvolution
[--device cpu]``
"""

import argparse

import numpy as np
import pandas as pd

import tangram_tpu_torch as tgt
from tangram_tpu_torch.examples.tutorial_mapping import make_synthetic_pair


def add_segmentation_features(ad_sp, mean_cells=4, seed=1):
    """Synthetic squidpy-style image features: per-spot segmentation label
    counts and centroid lists."""
    rng = np.random.default_rng(seed)
    n = ad_sp.n_obs
    counts = np.maximum(rng.poisson(mean_cells, n), 1)
    coords = np.asarray(ad_sp.obsm["spatial"])
    centroids = [
        [tuple(coords[i] + rng.normal(0, 0.01, 2)) for _ in range(c)]
        for i, c in enumerate(counts)
    ]
    ad_sp.obsm["image_features"] = pd.DataFrame(
        {
            "segmentation_label": counts,
            "segmentation_centroid": pd.Series(centroids, index=ad_sp.obs.index),
        },
        index=ad_sp.obs.index,
    )


def main(device=None):
    ad_sc, ad_sp = make_synthetic_pair(800, 300, 200)
    add_segmentation_features(ad_sp)

    tgt.pp_adatas(ad_sc, ad_sp)

    # target_count: how many cells the filter should keep — estimated from
    # the segmentation (sum of per-spot cell counts)
    target_count = int(ad_sp.obsm["image_features"]["segmentation_label"].sum())
    print("target_count:", target_count)

    ad_map = tgt.map_cells_to_space(
        ad_sc,
        ad_sp,
        mode="constrained",
        target_count=min(target_count, ad_sc.n_obs),
        density_prior="rna_count_based",
        num_epochs=300,
        random_state=42,
        verbose=False,
        device=device,
    )
    kept = int((ad_map.obs["F_out"] > 0.5).sum())
    print(f"filter keeps {kept}/{ad_sc.n_obs} cells")

    # deconvolution chain
    tgt.create_segment_cell_df(ad_sp)
    tgt.project_cell_annotations(ad_map, ad_sp, annotation="subclass_label")
    tgt.count_cell_annotations(ad_map, ad_sc, ad_sp, annotation="subclass_label")
    adata_segment = tgt.deconvolve_cell_annotations(ad_sp)
    print("segmentation objects annotated:", adata_segment.n_obs)
    print(adata_segment.obs["cluster"].value_counts())


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tangram_tpu_torch.examples.tutorial_deconvolution")
    parser.add_argument("--device", default=None,
                        help="torch device (the card by default; 'cpu' for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
