"""Tutorial: atlas-scale mapping on a mesh of GPUs, with checkpointing.

What the reference cannot do at all (its README's answer to running out of
memory is "split your spatial data into parts and map each part"):

1. shard the mapping problem over a mesh of processes, one per GPU (1-D
   over cells; ``parallel.make_mesh`` gives 2-D cells × spots when even
   single rows of M outgrow a card);
2. train through the fused CUDA kernels, run block by block;
3. checkpoint mid-run with intact Adam state and resume after preemption.

Run: ``python -m tangram_tpu_torch.examples.tutorial_atlas_mesh [--quick]
[--device cpu]`` in one process (no mesh), or ``torchrun
--nproc_per_node N -m tangram_tpu_torch.examples.tutorial_atlas_mesh`` for
a ``("cell",)`` mesh over N GPUs (gloo processes with ``--device cpu``).
Without ``--quick`` it maps 20,000 cells × 8,000 spots × 250 genes.
"""

import argparse

import numpy as np
import pandas as pd
import torch

import tangram_tpu_torch as tgt
from tangram_tpu_torch.examples._world import (lead_print, shared_tempdir, start_world,
                                               world_size)


def world_mesh(device):
    """A ``("cell",)`` mesh over every process of a torchrun world above
    one, else None."""
    if world_size() <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device.type, torch.arange(start_world(device)),
                      mesh_dim_names=("cell",))


def main(quick=False, device=None):
    from tangram_tpu_torch.models.mapper import resolve_device

    device = resolve_device(device)
    n_cells, n_spots, n_genes = (600, 400, 60) if quick else (20_000, 8_000, 250)
    rng = np.random.default_rng(0)
    S = (rng.poisson(1.5, (n_cells, n_genes)) + 0).astype(np.float32)
    G = (rng.poisson(2.0, (n_spots, n_genes)) + 0).astype(np.float32)
    S[0] += 1
    G[0] += 1

    ad_sc = tgt.AnnData(
        X=S,
        obs=pd.DataFrame(index=[f"c{i}" for i in range(n_cells)]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(n_genes)]),
    )
    ad_sp = tgt.AnnData(
        X=G,
        obs=pd.DataFrame(index=[f"s{i}" for i in range(n_spots)]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(n_genes)]),
    )
    ad_sp.obsm["spatial"] = rng.random((n_spots, 2)) * 100
    tgt.pp_adatas(ad_sc, ad_sp)

    # --- 1. a mesh over all processes -----------------------------------
    # 1-D over cells is the default production layout: the softmax stays
    # local to a process and only the (spots × genes) projection is summed
    # across them.
    mesh = world_mesh(device)
    say = lead_print(mesh)
    world = 1 if mesh is None else mesh.size()
    layout = None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"mesh: {layout} over {world} {device.type} device(s)")

    # --- 2. one-call mapping, sharded -----------------------------------
    ad_map = tgt.map_cells_to_space(
        ad_sc, ad_sp,
        mode="cells",
        density_prior="rna_count_based",
        num_epochs=100 if quick else 1000,
        random_state=42,
        verbose=False,
        device=device,
        mesh=mesh,
    )
    score = list(ad_map.uns["training_history"]["main_loss"])[-1]
    say(f"sharded mapping done: final train score {score:.4f}")

    # --- 3. checkpointed training for preemptible environments ----------
    from tangram_tpu_torch import checkpoint
    from tangram_tpu_torch.models.mapper import init_logits
    from tangram_tpu_torch.ops.losses import LossWeights, MapperData

    genes = ad_sc.uns["training_genes"]

    def tensor(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    data = MapperData(
        S=tensor(ad_sc[:, genes].X),
        G=tensor(ad_sp[:, genes].X),
        d=tensor(ad_sp.obs["rna_count_based_density"]),
    )
    lw = LossWeights(lambda_g1=1.0, lambda_d=1.0)
    M0 = init_logits(n_cells, n_spots, random_state=42, method="auto", device=device)

    epochs = 60 if quick else 300
    with shared_tempdir(mesh) as ckpt_dir:
        # simulate preemption: run a third, "crash", resume to completion
        # (training updates its logits in place: each call gets a copy)
        checkpoint.train_checkpointed(
            M0.clone(), data, lw, epochs // 3, 0.1,
            checkpoint_dir=ckpt_dir, checkpoint_every=epochs // 3, mesh=mesh,
        )
        say(f"...preempted at epoch {checkpoint.latest_epoch(ckpt_dir)}")
        params, history = checkpoint.train_checkpointed(
            M0.clone(), data, lw, epochs, 0.1,
            checkpoint_dir=ckpt_dir, checkpoint_every=epochs // 3, mesh=mesh,
        )
    say(
        f"resumed to epoch {len(history['total_loss'])}, "
        f"final loss {history['total_loss'][-1]:.4f}"
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tangram_tpu_torch.examples.tutorial_atlas_mesh")
    parser.add_argument("--quick", action="store_true",
                        help="600 x 400 x 60 instead of the atlas shape")
    parser.add_argument("--device", default=None,
                        help="torch device (the card by default; 'cpu' for the plain "
                        "PyTorch path and gloo processes)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
