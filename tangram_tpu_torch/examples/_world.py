"""What the tutorials and the fuzzers need to run alike in one process and
under ``torchrun``: the world's size, its process group, meshes over it,
printing from the lead rank, and a directory that every rank sees."""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile


def world_size() -> int:
    """The ranks of the running process group, else torchrun's
    ``WORLD_SIZE`` (1 outside torchrun)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def start_world(device) -> int:
    """Start the process group from torchrun's environment when it is not
    running yet (NCCL on the card, gloo for the CPU); returns its size."""
    import torch.distributed as dist

    from tangram_tpu_torch.parallel import init_distributed

    init_distributed(backend="gloo" if device.type == "cpu" else None)
    return dist.get_world_size()


def world_meshes(device, names_1d, names_2d):
    """Two meshes over the running process group's n ranks, their blocks on
    ``device``'s type: {"1d": ``names_1d`` over all n, "2d": ``names_2d``
    of 2 × n/2 when n is even, else 1 × n}; None when no process group is
    running (what the fuzzers' mesh runs take)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    ranks = torch.arange(n)
    rows = 2 if n % 2 == 0 else 1
    return {"1d": DeviceMesh(device.type, ranks, mesh_dim_names=names_1d),
            "2d": DeviceMesh(device.type, ranks.reshape(rows, n // rows),
                             mesh_dim_names=names_2d)}


def lead_print(mesh):
    """``print`` on the lead rank of ``mesh`` (every call in one process),
    a no-op on the others."""
    import torch.distributed as dist

    if mesh is None or dist.get_rank() == 0:
        return print
    return lambda *args, **kwargs: None


@contextlib.contextmanager
def shared_tempdir(mesh):
    """A temporary directory that every rank of ``mesh`` uses: the lead rank
    makes it and sends its path to the others (the ranks share a file
    system, as the processes of one host do), and removes it when every
    rank is done. Checkpoints and sweep journals are written by the lead
    rank and read by all."""
    if mesh is None:
        with tempfile.TemporaryDirectory() as path:
            yield path
        return
    import torch.distributed as dist

    lead = dist.get_rank() == 0
    path = [tempfile.mkdtemp() if lead else None]
    dist.broadcast_object_list(path, src=0)
    try:
        yield path[0]
    finally:
        dist.barrier()
        if lead:
            shutil.rmtree(path[0], ignore_errors=True)
