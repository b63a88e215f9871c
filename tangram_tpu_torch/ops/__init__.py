from .core import mapper_core, NeighborGraph, graph_matmul
from .losses import (
    LossWeights,
    MapperData,
    cosine_similarity,
    kl_div_sum,
    spatial_local_indicators,
    compute_loss,
    compute_constrained_loss,
    val_metrics,
)

__all__ = [
    "mapper_core",
    "NeighborGraph",
    "graph_matmul",
    "LossWeights",
    "MapperData",
    "cosine_similarity",
    "kl_div_sum",
    "spatial_local_indicators",
    "compute_loss",
    "compute_constrained_loss",
    "val_metrics",
]
