"""Generate ``notebooks/tutorial_tangram_tpu_torch.ipynb``, the notebook
walkthrough of ``tangram_tpu_torch`` (the port of
``scripts/gen_tutorial_notebook.py``): the reference tutorial's narrative
(``tutorial_tangram_without_squidpy.ipynb``: preprocess, map, inspect
training, transfer annotations, project genes, cross-validate, score) on
the port, with ``device=`` explicit in every call that takes it, and the
port's multi-GPU line in place of the JAX notebook's TPU-only cells. Built
from the source cells here, so it stays regenerable without jupyter::

    python -m tangram_tpu_torch.scripts.gen_tutorial_notebook
"""

from __future__ import annotations

import json
import os
import sys

__all__ = ["CELLS", "OUT", "build", "main"]

MD = "markdown"
CODE = "code"

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "notebooks", "tutorial_tangram_tpu_torch.ipynb")

CELLS = [
    (MD, """\
# tangram_tpu_torch tutorial: mapping single cells onto spatial data

This walkthrough mirrors the reference Tangram tutorial
(`tutorial_tangram_without_squidpy.ipynb`: snRNA-seq of mouse motor cortex
mapped onto Slide-seq voxels) on `tangram_tpu_torch`, the PyTorch port with
hand-written CUDA kernels for NVIDIA Hopper. Tangram learns a mapping
matrix `M` (cells × spots, rows softmax-normalized) by maximizing per-gene
cosine similarity between the projected expression `MᵀS` and the measured
spatial expression `G`.

Synthetic data stands in for the MOp download so the notebook runs
anywhere; substitute `tg.read_h5ad(...)` with your own files. Every call
that trains takes `device=`: `"cuda"` runs the kernels on the GPU, `"cpu"`
runs the same loops on the CPU (the kernels' plain PyTorch versions)."""),
    (CODE, """\
import numpy as np
import pandas as pd

import tangram_tpu_torch as tg

DEVICE = "cuda"  # "cpu" runs the plain PyTorch path on the CPU

rng = np.random.default_rng(0)
n_cells, n_spots, n_genes, n_types = 2000, 800, 500, 8

# synthetic sc/sp pair with shared cell-type programs and spatially smooth
# type composition (a stand-in for snRNA + Slide-seq)
programs = rng.lognormal(0.0, 1.0, (n_types, n_genes))
labels = rng.integers(0, n_types, n_cells)
S = rng.poisson(programs[labels] * rng.gamma(3.0, 1 / 3, (n_cells, 1))).astype(np.float32)

coords = rng.random((n_spots, 2))
centers = rng.random((n_types, 2))
logits = -10 * ((coords[:, None, :] - centers[None]) ** 2).sum(-1)
mix = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
G = rng.poisson(mix @ programs * 3.0).astype(np.float32)

ad_sc = tg.AnnData(
    X=S,
    obs=pd.DataFrame(
        {"subclass_label": pd.Categorical([f"type_{l}" for l in labels])},
        index=[f"cell_{i}" for i in range(n_cells)],
    ),
    var=pd.DataFrame(index=[f"Gene{i}" for i in range(n_genes)]),
)
ad_sp = tg.AnnData(
    X=G,
    obs=pd.DataFrame(
        {"x": coords[:, 0], "y": coords[:, 1]},
        index=[f"voxel_{i}" for i in range(n_spots)],
    ),
    var=pd.DataFrame(index=[f"Gene{i}" for i in range(n_genes)]),
)
ad_sp.obsm["spatial"] = coords
ad_sc"""),
    (MD, """\
## 1. Select training genes

The reference tutorial uses ~250 MOp marker genes. `tg.gene_selection.ctg`
ranks cell-type-discriminating genes natively (scanpy's
`rank_genes_groups` equivalent); `hvg` and the sparse spatially-variable
`svg` selector are also available."""),
    (CODE, """\
markers = tg.gene_selection.ctg(ad_sc, "subclass_label", n_genes=40)
print(len(markers), "marker genes")"""),
    (MD, """\
## 2. Preprocess

`pp_adatas` intersects genes (lowercased), drops all-zero genes, writes the
density priors, and — when `obsm["spatial"]` is present — builds the spot
neighbor graph (Visium hex-grid adjacency when `uns["spatial"]` library
metadata exists, generic KNN otherwise, like squidpy's auto `coord_type`).
The training genes keep the order they were asked for."""),
    (CODE, """\
tg.pp_adatas(ad_sc, ad_sp, genes=markers)
print(len(ad_sc.uns["training_genes"]), "training genes")
print(sorted(ad_sp.obsp.keys()))"""),
    (MD, """\
## 3. Map cells to space

The signature matches the reference, plus `device=`. On the GPU each
epoch is one fused step through the CUDA kernels (row statistics,
projection, the softmax gradient's row reduction, and the gradient with
the Adam update in one streamed pass); the mapping matrix P is never
stored. Per-epoch scores are kept on the device and read once at the
end."""),
    (CODE, """\
ad_map = tg.map_cells_to_space(
    ad_sc, ad_sp,
    mode="cells",
    density_prior="rna_count_based",
    num_epochs=1000,
    random_state=42,
    verbose=True,
    device=DEVICE,
)
hist = ad_map.uns["training_history"]
print("final train score:", round(hist["main_loss"][-1], 3))"""),
    (MD, """\
### 3b. Train an order of magnitude faster (extension)

The reference's constant `learning_rate=0.1` undertrains badly. A cosine
schedule converges higher in a fraction of the epochs, and
`early_stop_tol` stops once the score plateaus. Both are opt-in keywords —
omit them for epoch-for-epoch reference parity."""),
    (CODE, """\
ad_map_fast = tg.map_cells_to_space(
    ad_sc, ad_sp,
    mode="cells",
    density_prior="rna_count_based",
    num_epochs=1000,
    learning_rate=tg.cosine_lr(1.0, 1000, end=0.1),
    early_stop_tol=1e-4,
    early_stop_window=50,
    random_state=42,
    device=DEVICE,
)
fast = ad_map_fast.uns["training_history"]["main_loss"]
print(f"score {fast[-1]:.3f} in {len(fast)} epochs")"""),
    (MD, """\
## 4. Transfer cell-type annotations onto space"""),
    (CODE, """\
tg.project_cell_annotations(ad_map, ad_sp, annotation="subclass_label")
tg.plot_cell_annotation(ad_map, ad_sp, annotation="subclass_label",
                        x="x", y="y", nrows=2, ncols=4)"""),
    (MD, """\
## 5. Inspect training scores

Per-gene training scores live in `ad_map.uns["train_genes_df"]`, exactly as
in the reference."""),
    (CODE, """\
tg.plot_training_scores(ad_map, bins=20, alpha=0.5)
ad_map.uns["train_genes_df"].head()"""),
    (MD, """\
## 6. Project the whole transcriptome and score it"""),
    (CODE, """\
ad_ge = tg.project_genes(ad_map, ad_sc)
df_all_genes = tg.compare_spatial_geneexp(ad_ge, ad_sp, ad_sc)
df_all_genes.head()"""),
    (CODE, """\
# measured vs predicted patterns for a few genes
genes = list(df_all_genes.index[:3])
tg.plot_genes(genes, adata_measured=ad_sp, adata_predicted=ad_ge,
              x="x", y="y")"""),
    (MD, """\
## 7. Leave-one-out cross-validation

The reference retrains from scratch per fold (one training per held-out
gene for LOO). Here the folds train as one batched problem on the device:
one (folds, cells, spots) mapping, each fold with its gene held out of the
loss."""),
    (CODE, """\
cv_dict, ad_ge_cv, df_test_genes = tg.cross_val(
    ad_sc, ad_sp,
    mode="cells",
    cv_mode="loo",
    num_epochs=250,
    random_state=42,
    return_gene_pred=True,
    density_prior="rna_count_based",
    device=DEVICE,
)
cv_dict"""),
    (MD, """\
## 8. The AUC evaluation metric"""),
    (CODE, """\
metrics, _ = tg.eval_metric(df_test_genes)
tg.plot_auc(df_test_genes)
{k: round(float(v), 3) for k, v in metrics.items()}"""),
    (MD, """\
## 9. Scale out: several GPUs (extension)

The JAX notebook's TPU-only cells are left out here: its mesh over
virtual devices (`jax.sharding.Mesh`) and `enable_compilation_cache`
(PyTorch builds the CUDA kernels once, at their first use). On GPUs one
mapping trains over a mesh of processes, one per GPU: each keeps its
block of M and runs the kernels on it. Start them with `torchrun`, from a
script that calls `tg.parallel.init_distributed()` and passes
`mesh=tg.parallel.make_mesh()` to `map_cells_to_space`:

```bash
torchrun --nproc_per_node N -m tangram_tpu_torch.examples.tutorial_atlas_mesh
```"""),
    (MD, """\
## Going further

- **Constrained mode** (learned cell filter) and the **deconvolution
  chain**: `python -m tangram_tpu_torch.examples.tutorial_deconvolution`.
- **Hyperparameter tuning**: `tg.mapping_hyperparameter_tuning(...,
  device=DEVICE)` — the 5 stability metrics of the reference tuner, each
  population of trials trained as one batched problem;
  `search="adaptive"` adds multi-objective TPE rounds, `search="halving"`
  batched successive-halving pruning, and `search="adaptive+halving"`
  both composed; pick the winner with
  `.get_results().get_best_result(metric=...)`.
- **Checkpoint/resume**: `tangram_tpu_torch.checkpoint.train_checkpointed`
  (bit-exact resume with the optimizer's state).
- **The 100k × 50k north star**: `python -m tangram_tpu_torch.north_star`
  on one H100.
- Full API reference: `docs/reference_torch/index.md`."""),
]


def build() -> dict:
    """The notebook as nbformat 4 JSON, every code cell without outputs."""
    cells = []
    for kind, src in CELLS:
        cell = {"cell_type": kind, "metadata": {}, "source": src.splitlines(keepends=True)}
        if kind == CODE:
            cell["outputs"] = []
            cell["execution_count"] = None
        cells.append(cell)
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main(out: str = OUT) -> int:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(build(), f, indent=1, ensure_ascii=False)
        f.write("\n")
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
