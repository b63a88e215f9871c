"""tangram_tpu_torch: the Tangram mapper in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``tangram_tpu`` (JAX), with its flat public namespace:
``map_cells_to_space`` in cells, clusters and constrained modes, with
Adam or Adafactor, the L1/L2 terms, the five graph terms on dense or k-NN
spot graphs, validation metrics, f32 or bf16 storage, learning-rate
schedules, early stopping, init draws and checkpoints; gene projection,
scoring and gene-holdout cross-validation; annotation transfer and
segmentation-level deconvolution; cell sampling and training-gene
selection; the plotting suite; and phase timings and traces
(``profiling``). Training runs on one H100 through nine streamed kernels,
one for each Pallas kernel call of the JAX package, in three sources:
``csrc/mapper_kernels.cu`` (the row stats), ``csrc/dp_tensor_kernels.cu``
(rbar, dm_adam, gsq, dm_adafactor and the backward's two kernels on the
tensor-core dP tile) and ``csrc/project_tc_kernels.cu`` (project).
The hyperparameter tuner (``tuning``, ``search``) trains its populations
of mappings as one batched problem on the materialized core, as the JAX
tuner does on XLA, so it launches none of the kernels. ``parallel``
trains one mapping over a mesh of processes on ``torch.distributed``, the
kernels run shard by shard. ``tangram_tpu`` stays the reference it is
tested against. This package imports torch and never jax.

``import tangram_tpu_torch as tgt; tgt.pp_adatas(...);
tgt.map_cells_to_space(...)``
"""

from . import cell_selection, checkpoint, gene_selection, parallel, profiling
from ._version import __version__
from .adlite import AnnData, read_h5ad, write_h5ad
from .mapping import adata_to_cluster_expression, map_cells_to_space, pp_adatas
from .models.mapper import Mapper, MapperConstrained, fit_mapping, init_logits
from .ops.core import NeighborGraph, graph_matmul, mapper_core
from .ops.losses import (
    LossWeights,
    MapperData,
    compute_constrained_loss,
    compute_loss,
    val_metrics,
)
from .ops.schedules import cosine_lr
from .spatial import neighbor_graph, spatial_neighbors, spatial_weights
from .utils import (
    annotate_gene_sparsity,
    cell_type_mapping,
    compare_spatial_geneexp,
    count_cell_annotations,
    create_segment_cell_df,
    cross_val,
    cv_data_gen,
    deconvolve_cell_annotations,
    df_to_cell_types,
    eval_metric,
    get_matched_genes,
    one_hot_encoding,
    project_cell_annotations,
    project_genes,
    read_pickle,
    transfer_annotations_prob,
    transfer_annotations_prob_filter,
)

# Plotting pulls in matplotlib and seaborn: import it lazily.
_plot_names = {
    "plot_training_scores", "plot_gene_sparsity", "ordered_predictions",
    "convert_adata_array", "construct_obs_plot", "plot_cell_annotation",
    "plot_cell_annotation_sc", "plot_genes", "plot_genes_sc",
    "quick_plot_gene", "plot_annotation_entropy", "plot_test_scores",
    "plot_auc", "q_value", "mapping_colors",
}
_tune_names = {"mapping_hyperparameter_tuning", "train_multiple_Mapper",
               "pearson_corr", "vote_entropy", "consensus_entropy"}
_search_names = {"TPESampler", "nondominated_rank"}
_lazy_modules = {"plot_utils", "datasets", "evaluation", "deconv", "spatial",
                 "utils", "adlite", "tuning", "search"}

__all__ = sorted(
    {name for name in dir() if not name.startswith("_")}
    | _plot_names | _tune_names | _search_names | _lazy_modules
)


def __dir__():
    return __all__


def __getattr__(name):
    if name in _plot_names:
        from . import plot_utils

        return getattr(plot_utils, name)
    if name in _tune_names:
        from . import tuning

        return getattr(tuning, name)
    if name in _search_names:
        from . import search

        return getattr(search, name)
    if name in _lazy_modules:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'tangram_tpu_torch' has no attribute {name!r}")
