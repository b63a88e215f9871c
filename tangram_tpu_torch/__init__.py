"""tangram_tpu_torch: the Tangram mapper in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``tangram_tpu`` (JAX) that runs the main mapping path —
``map_cells_to_space`` in cells and clusters modes with Adam and f32
storage — on one H100 through four streamed kernels
(``csrc/mapper_kernels.cu``). ``tangram_tpu`` stays the reference it is
tested against. This package imports torch and never jax.

``import tangram_tpu_torch as tgt; tgt.pp_adatas(...);
tgt.map_cells_to_space(...)``
"""

from .adlite import AnnData, read_h5ad, write_h5ad
from .evaluation import compare_spatial_geneexp, project_genes
from .mapping import adata_to_cluster_expression, map_cells_to_space, pp_adatas
from .models.mapper import Mapper, fit_mapping

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
    "fit_mapping",
]
