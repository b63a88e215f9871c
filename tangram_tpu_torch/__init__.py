"""tangram_tpu_torch: the Tangram mapper in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``tangram_tpu`` (JAX) that runs ``map_cells_to_space`` in
cells, clusters and constrained modes, with Adam or Adafactor, the L1/L2
terms, validation metrics and f32 storage, on one H100 through nine
streamed kernels (``csrc/mapper_kernels.cu``), one for each Pallas kernel
call of the JAX package. ``tangram_tpu`` stays the reference it is tested
against. This package imports torch and never jax.

``import tangram_tpu_torch as tgt; tgt.pp_adatas(...);
tgt.map_cells_to_space(...)``
"""

from .adlite import AnnData, read_h5ad, write_h5ad
from .evaluation import compare_spatial_geneexp, project_genes
from .mapping import adata_to_cluster_expression, map_cells_to_space, pp_adatas
from .models.mapper import Mapper, MapperConstrained, fit_mapping

__all__ = [
    "AnnData",
    "read_h5ad",
    "write_h5ad",
    "pp_adatas",
    "adata_to_cluster_expression",
    "map_cells_to_space",
    "project_genes",
    "compare_spatial_geneexp",
    "Mapper",
    "MapperConstrained",
    "fit_mapping",
]
