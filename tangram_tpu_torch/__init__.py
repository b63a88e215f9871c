"""tangram_tpu_torch: the Tangram mapper in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``tangram_tpu`` (JAX) that runs ``map_cells_to_space`` in
cells, clusters and constrained modes, with Adam or Adafactor, the L1/L2
terms, the five graph terms on dense or k-NN spot graphs
(``spatial_neighbors``, ``spatial_weights``, ``neighbor_graph``,
``NeighborGraph``, ``graph_matmul``), validation metrics, f32 or bf16 storage, learning-rate schedules
(``cosine_lr``), early stopping, on-device and expression init draws
(``init_logits``), checkpoints (the ``checkpoint`` module), gene-holdout
cross-validation (``cv_data_gen``, ``cross_val``) and ``eval_metric``, on
one H100 through nine streamed kernels, one for each Pallas kernel call of
the JAX package, in three sources: ``csrc/mapper_kernels.cu`` (the row
stats), ``csrc/dp_tensor_kernels.cu`` (rbar, dm_adam, gsq, dm_adafactor
and the backward's two kernels on the tensor-core dP tile) and
``csrc/project_tc_kernels.cu`` (project). ``tangram_tpu`` stays the
reference it is tested against. This package imports torch and never jax.

``import tangram_tpu_torch as tgt; tgt.pp_adatas(...);
tgt.map_cells_to_space(...)``
"""

from . import checkpoint
from .adlite import AnnData, read_h5ad, write_h5ad
from .evaluation import (compare_spatial_geneexp, cross_val, cv_data_gen, eval_metric,
                         project_genes)
from .mapping import adata_to_cluster_expression, map_cells_to_space, pp_adatas
from .models.mapper import Mapper, MapperConstrained, fit_mapping, init_logits
from .ops.core import NeighborGraph, graph_matmul
from .ops.schedules import cosine_lr
from .spatial import neighbor_graph, spatial_neighbors, spatial_weights
from .utils import one_hot_encoding

__all__ = [
    "AnnData",
    "read_h5ad",
    "write_h5ad",
    "pp_adatas",
    "adata_to_cluster_expression",
    "map_cells_to_space",
    "project_genes",
    "compare_spatial_geneexp",
    "cv_data_gen",
    "cross_val",
    "eval_metric",
    "Mapper",
    "MapperConstrained",
    "fit_mapping",
    "init_logits",
    "cosine_lr",
    "checkpoint",
    "NeighborGraph",
    "graph_matmul",
    "spatial_neighbors",
    "spatial_weights",
    "neighbor_graph",
    "one_hot_encoding",
]
