"""Tutorial: mapping single-nucleus RNA-seq onto spatial voxels.

A runnable equivalent of the reference's
``tutorial_tangram_without_squidpy.ipynb``: preprocess, select training
genes, map at cell level, inspect training, project the whole
transcriptome, validate with leave-one-out cross-validation, and score.

Run: ``python -m tangram_tpu_torch.examples.tutorial_mapping [--quick]
[--device cpu] [--outdir DIR]`` (synthetic data stands in for the MOp snRNA
/ Slide-seq download; the plots go to ``--outdir``, the current directory
by default).
"""

import argparse
import os

import numpy as np
import pandas as pd

import tangram_tpu_torch as tgt


def make_synthetic_pair(n_cells=2000, n_spots=800, n_genes=500, n_types=8, seed=0):
    """Synthetic sc/sp pair with shared cell-type structure and spatially
    smooth type composition (a stand-in for snRNA + Slide-seq)."""
    rng = np.random.default_rng(seed)
    programs = rng.lognormal(0.0, 1.0, (n_types, n_genes))
    labels = rng.integers(0, n_types, n_cells)
    S = rng.poisson(programs[labels] * rng.gamma(3.0, 1 / 3, (n_cells, 1))).astype(np.float32)

    coords = rng.random((n_spots, 2))
    centers = rng.random((n_types, 2))
    logits = -10 * ((coords[:, None, :] - centers[None]) ** 2).sum(-1)
    mix = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    G = rng.poisson(mix @ programs * 3.0).astype(np.float32)

    ad_sc = tgt.AnnData(
        X=S,
        obs=pd.DataFrame(
            {"subclass_label": pd.Categorical([f"type_{l}" for l in labels])},
            index=[f"cell_{i}" for i in range(n_cells)],
        ),
        var=pd.DataFrame(index=[f"Gene{i}" for i in range(n_genes)]),
    )
    ad_sp = tgt.AnnData(
        X=G,
        obs=pd.DataFrame(
            {"x": coords[:, 0], "y": coords[:, 1]},
            index=[f"voxel_{i}" for i in range(n_spots)],
        ),
        var=pd.DataFrame(index=[f"Gene{i}" for i in range(n_genes)]),
    )
    ad_sp.obsm["spatial"] = coords
    return ad_sc, ad_sp


def main(quick=False, device=None, outdir="."):
    ad_sc, ad_sp = make_synthetic_pair(
        *(500, 200, 120) if quick else (2000, 800, 500)
    )
    epochs = 100 if quick else 1000

    # 1. training genes: cell-type markers (reference uses ~250 MOp markers)
    markers = tgt.gene_selection.ctg(ad_sc, "subclass_label", n_genes=40)
    print(f"{len(markers)} marker genes selected")

    # 2. preprocess: gene intersection, density priors, spot graph
    tgt.pp_adatas(ad_sc, ad_sp, genes=markers)

    # 3. map at cell level
    ad_map = tgt.map_cells_to_space(
        ad_sc,
        ad_sp,
        mode="cells",
        density_prior="rna_count_based",
        num_epochs=epochs,
        random_state=42,
        verbose=True,
        device=device,
    )
    print("train score:", round(ad_map.uns["training_history"]["main_loss"][-1], 3))

    # 3b. the same mapping an order of magnitude faster: a tuned cosine lr
    # schedule + stop-on-convergence (extensions; the constant-lr run above
    # keeps the reference's exact schedule for parity)
    ad_map_fast = tgt.map_cells_to_space(
        ad_sc,
        ad_sp,
        mode="cells",
        density_prior="rna_count_based",
        num_epochs=epochs,
        learning_rate=tgt.cosine_lr(1.0, epochs, end=0.1),
        early_stop_tol=1e-4,
        early_stop_window=max(epochs // 20, 10),
        random_state=42,
        verbose=False,
        device=device,
    )
    fast_hist = ad_map_fast.uns["training_history"]["main_loss"]
    print(
        f"tuned schedule: score {fast_hist[-1]:.3f} in {len(fast_hist)} epochs"
    )

    # 4. transfer cell-type annotations onto space
    tgt.project_cell_annotations(ad_map, ad_sp, annotation="subclass_label")
    print("ct prediction:", ad_sp.obsm["tangram_ct_pred"].shape)

    # 5. project the whole transcriptome and score against measured data
    ad_ge = tgt.project_genes(ad_map, ad_sc)
    df_all = tgt.compare_spatial_geneexp(ad_ge, ad_sp, ad_sc)
    print(df_all.head())

    # 6. held-out validation: LOO cross-validation (every fold in one
    # batched problem)
    cv_dict, ad_ge_cv, test_df = tgt.cross_val(
        ad_sc,
        ad_sp,
        mode="cells",
        cv_mode="loo",
        num_epochs=max(epochs // 4, 50),
        random_state=42,
        return_gene_pred=True,
        density_prior="rna_count_based",
        device=device,
    )
    print("cv:", cv_dict)

    # 7. the AUC evaluation metric on held-out predictions
    metrics, _ = tgt.eval_metric(test_df)
    print("metrics:", {k: round(float(v), 3) for k, v in metrics.items()})

    # 8. plots, written to outdir
    try:
        import matplotlib
    except ImportError:
        print("plots skipped: matplotlib is not installed")
        return
    matplotlib.use("Agg")
    out = os.path.abspath(outdir)
    os.makedirs(out, exist_ok=True)
    tgt.plot_training_scores(ad_map).savefig(os.path.join(out, "training_scores.png"))
    fig = tgt.plot_auc(test_df)
    fig.savefig(os.path.join(out, "auc.png"))
    print("plots saved to", out)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tangram_tpu_torch.examples.tutorial_mapping")
    parser.add_argument("--quick", action="store_true", help="500 x 200 x 120, 100 epochs")
    parser.add_argument("--device", default=None,
                        help="torch device (the card by default; 'cpu' for the plain "
                        "PyTorch path)")
    parser.add_argument("--outdir", default=".", help="where the plots are written")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
