"""Tutorial: fault-tolerant sweeps over a mesh (cross-validation + tuner).

Two capabilities the reference delegates to Ray (and loses without it):

1. **Data parallelism over whole problems**: on a 2-D mesh, `cross_val` /
   the tuner put folds/trials on the ``"fold"``/``"trial"`` axis and split
   each member's logits and Adam moments by cells over the other axis, so
   per-member problems larger than one card's memory still batch.
2. **Crash tolerance** (`resume_path=`): every completed batch/chunk is
   journaled to a JSONL file; a killed sweep resumes where it stopped,
   losing at most one in-flight batch (the role Ray Tune's trial fault
   tolerance / ``Tuner.restore`` plays for the reference).

Run: ``python -m tangram_tpu_torch.examples.tutorial_fault_tolerant_sweep
[--device cpu]`` in one process (no mesh), or ``torchrun
--nproc_per_node N -m tangram_tpu_torch.examples.tutorial_fault_tolerant_sweep``
for a ``("fold", "cell")`` / ``("trial", "cell")`` mesh of 2 × N/2 (1 × N
for an odd N) over N GPUs (gloo processes with ``--device cpu``).
"""

import argparse
import os

import numpy as np
import pandas as pd
import torch

import tangram_tpu_torch as tgt
from tangram_tpu_torch.examples._world import (lead_print, shared_tempdir, start_world,
                                               world_size)


def make_adatas(rng, n_cells=36, n_spots=20, n_genes=14):
    genes = [f"g{i}" for i in range(n_genes)]
    ad_sc = tgt.AnnData(
        X=(rng.poisson(2.0, (n_cells, n_genes)) + 1).astype(np.float32),
        obs=pd.DataFrame(
            {"subclass_label": rng.choice(["a", "b", "c"], n_cells)},
            index=[f"c{i}" for i in range(n_cells)],
        ),
        var=pd.DataFrame(index=genes),
    )
    ad_sp = tgt.AnnData(
        X=(rng.poisson(3.0, (n_spots, n_genes)) + 1).astype(np.float32),
        var=pd.DataFrame(index=genes),
    )
    ad_sp.obsm["spatial"] = rng.random((n_spots, 2)) * 100
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


def world_meshes(device):
    """``(("fold", "cell") mesh, ("trial", "cell") mesh)`` of 2 × world/2
    (1 × world for an odd world) over a torchrun world above one, else
    ``(None, None)``."""
    if world_size() <= 1:
        return None, None
    from torch.distributed.device_mesh import DeviceMesh

    world = start_world(device)
    groups = 2 if world % 2 == 0 else 1
    grid = torch.arange(world).reshape(groups, world // groups)
    return (DeviceMesh(device.type, grid, mesh_dim_names=("fold", "cell")),
            DeviceMesh(device.type, grid, mesh_dim_names=("trial", "cell")))


def main(device=None):
    from tangram_tpu_torch.models.mapper import resolve_device

    device = resolve_device(device)
    mesh, mesh_t = world_meshes(device)
    with shared_tempdir(mesh) as workdir:
        sweeps(device, mesh, mesh_t, workdir)


def sweeps(device, mesh, mesh_t, workdir):
    """The tutorial's two sweeps, journaled under ``workdir``."""
    from tangram_tpu_torch import tuning

    say = lead_print(mesh)
    rng = np.random.default_rng(0)
    ad_sc, ad_sp = make_adatas(rng)

    # --- cross-validation over folds and cells -----------------------------
    # folds ride the "fold" axis; each fold group's processes split every
    # fold's logits + Adam moments by cells
    cv_path = os.path.join(workdir, "cv_sweep.jsonl")
    cv = tgt.cross_val(
        ad_sc, ad_sp, mode="cells", cv_mode="10fold", num_epochs=40,
        random_state=0, verbose=True, fold_batch_size=4, mesh=mesh,
        resume_path=cv_path, device=device,
    )
    say("cross_val:", cv)
    # a second call with the same journal retrains NOTHING — every chunk is
    # restored from the file (kill the process mid-sweep and rerun to see a
    # partial resume instead)
    cv_again = tgt.cross_val(
        ad_sc, ad_sp, mode="cells", cv_mode="10fold", num_epochs=40,
        random_state=0, verbose=True, fold_batch_size=4, mesh=mesh,
        resume_path=cv_path, device=device,
    )
    if cv_again != cv:
        raise RuntimeError(f"the resumed cross_val differs: {cv_again} != {cv}")

    # --- fault-tolerant adaptive tuner over the same processes --------------
    tuner_path = os.path.join(workdir, "tuner_sweep.jsonl")
    result = tgt.mapping_hyperparameter_tuning(
        ad_sc, ad_sp,
        metric=["gene_expr_correctness", "cell_map_consistency"],
        config={
            "learning_rate": tuning.loguniform(0.02, 0.5),
            "lambda_d": tuning.uniform(0.0, 1.0),
            "num_epochs": 30,
        },
        tuner_num_samples=8, cluster_label="subclass_label",
        density_prior="uniform", random_state=0, population_batch_size=4,
        search="adaptive", mesh=mesh_t, resume_path=tuner_path, device=device,
    )
    df = result.get_results().get_dataframe()
    best = result.get_results().get_best_result(
        metric=["gene_expr_correctness", "cell_map_consistency"])
    say(df.round(4).to_string())
    say("best config:", {k: round(v, 4) for k, v in best.config.items()})
    with open(tuner_path) as f:
        say(f"journal: {tuner_path} ({sum(1 for _ in f)} lines)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tangram_tpu_torch.examples.tutorial_fault_tolerant_sweep")
    parser.add_argument("--device", default=None,
                        help="torch device (the card by default; 'cpu' for the plain "
                        "PyTorch path and gloo processes)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
