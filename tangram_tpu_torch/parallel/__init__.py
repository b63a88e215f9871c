"""Multi-GPU training on ``torch.distributed`` (counterpart of
``tangram_tpu/parallel``): meshes, the rank's blocks, the generic sharded
fit and the fused one that runs the kernels shard by shard."""

from .mesh import (
    init_distributed,
    make_mesh,
    mapping_shardings,
    shard_mapping,
    fit_mapping_sharded,
    train_step_sharded,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "mapping_shardings",
    "shard_mapping",
    "fit_mapping_sharded",
    "train_step_sharded",
]

from .fused_sharded import fit_mapping_fused_sharded  # noqa: E402

__all__.append("fit_mapping_fused_sharded")
