"""Run the north-star mapping, 100,000 cells × 50,000 spots × 249 genes, on
the card in one command (the port of ``scripts/north_star.py``):

    python -m tangram_tpu_torch.north_star                 # full width, one GPU
    python -m tangram_tpu_torch.north_star --tiny --device cpu   # smoke shape
    torchrun --nproc_per_node N -m tangram_tpu_torch.north_star [--mesh 2d]

M trains in f32 with Adam moments in bf16 and the contraction inputs (A
and dY) in bf16, rounded to nearest, under ``LossWeights(lambda_g1=1,
lambda_d=1)``, from an N(0, 1) start drawn on the device (a host draw in
float64 would take 40 GB at this width). In one process the fused loop
(``fit_mapping``) runs the kernels; under ``torchrun`` with a world above
one, ``parallel.fit_mapping_fused_sharded`` runs them block by block on a
1-D ``("cell",)`` mesh or a 2-D ``("cell", "spot")`` one. The data are
Poisson draws from ``--seed``, the same arrays the JAX script draws. The
kernels are built and loaded by a few warm-up steps from a separate start,
then the timed run starts anew; the clock stops after the device is
synchronised. The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .examples._world import start_world, world_size
from .models.mapper import fit_mapping, init_logits, resolve_device
from .ops.losses import LossWeights, MapperData

__all__ = ["parse_args", "make_problem", "mapper_data", "world_mesh", "train", "run",
           "main", "LOSS_WEIGHTS", "WARM_STEPS"]

#: the script's loss: the gene-voxel score and the density prior
LOSS_WEIGHTS = dict(lambda_g1=1.0, lambda_d=1.0)
#: steps run from a separate start before the timed run, to build and load
#: the kernels
WARM_STEPS = 3
TINY = (96, 40, 12, 5)  # cells, spots, genes, epochs


def parse_args(argv=None):
    """The JAX script's flags and defaults, plus ``--device``; ``--tiny``
    sets the 96 × 40 × 12 shape and 5 epochs."""
    p = argparse.ArgumentParser(prog="python -m tangram_tpu_torch.north_star",
                                description=__doc__.splitlines()[0])
    p.add_argument("--cells", type=int, default=100_000)
    p.add_argument("--spots", type=int, default=50_000)
    p.add_argument("--genes", type=int, default=249)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--mesh", choices=["1d", "2d"], default="1d")
    p.add_argument("--moment-dtype", default="bfloat16")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--parity-tol", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="96×40×12 cells×spots×genes, 5 epochs (CI smoke)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; 'cpu' runs the kernels' plain "
                   "versions")
    args = p.parse_args(argv)
    if args.tiny:
        args.cells, args.spots, args.genes, args.epochs = TINY
    return args


def make_problem(args):
    """(S (cells, genes), G (spots, genes), d (spots,)) as float32 numpy
    arrays: Poisson(1) and Poisson(2) counts and a uniform density
    normalised to 1, drawn from ``default_rng(seed)`` in the JAX script's
    order."""
    rng = np.random.default_rng(args.seed)
    S = rng.poisson(1.0, (args.cells, args.genes)).astype(np.float32)
    G = rng.poisson(2.0, (args.spots, args.genes)).astype(np.float32)
    d = rng.random(args.spots).astype(np.float32)
    return S, G, d / d.sum()


def mapper_data(S, G, d, device) -> MapperData:
    """The problem's tensors on ``device``."""
    return MapperData(S=torch.from_numpy(S).to(device), G=torch.from_numpy(G).to(device),
                      d=torch.from_numpy(d).to(device))


def world_mesh(args, device):
    """None in a world of one process; else the process group (started
    from torchrun's environment if it is not running yet: NCCL on the card,
    gloo for ``--device cpu``) and a mesh over every rank, ``("cell",)``
    for ``--mesh 1d`` and the most square ``("cell", "spot")`` grid for
    ``2d``."""
    if world_size() <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    from .parallel import make_mesh

    world = start_world(device)
    if args.mesh == "2d":
        return make_mesh()
    return DeviceMesh(device.type, torch.arange(world), mesh_dim_names=("cell",))


def train(M0, data: MapperData, args, mesh=None, epochs=None, return_opt_state=False):
    """Train from the logits ``M0`` (updated in place in one process) for
    ``epochs`` (``args.epochs`` by default) in the script's dtypes: the
    fused loop on ``M0``'s device, or the sharded fused loop over ``mesh``.
    Returns ``(M, history)``, or ``(M, opt_state, history)`` with
    ``return_opt_state`` (the Adam carry as the fit hands it back)."""
    lw = LossWeights(**LOSS_WEIGHTS)
    epochs = args.epochs if epochs is None else int(epochs)
    kw = dict(moment_dtype=args.moment_dtype, compute_dtype=args.compute_dtype,
              return_opt_state=return_opt_state)
    if mesh is None:
        return fit_mapping(M0, data, lw, epochs, args.lr, impl="fused", **kw)
    from .parallel import fit_mapping_fused_sharded

    return fit_mapping_fused_sharded(M0, data, lw, epochs, args.lr, mesh=mesh, **kw)


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Warm up, train, time; the result as the JSON object's fields."""
    device = resolve_device(args.device)
    mesh = world_mesh(args, device)
    data = mapper_data(*make_problem(args), device)

    def start():
        return init_logits(args.cells, args.spots, args.seed, method="jax", device=device)

    train(start(), data, args, mesh, epochs=min(WARM_STEPS, args.epochs))
    _synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    M0 = start()
    _synchronize(device)
    t0 = time.perf_counter()
    _, history = train(M0, data, args, mesh)
    main_loss = history["main_loss"].cpu().numpy()
    _synchronize(device)
    elapsed = time.perf_counter() - t0

    final_score = float(main_loss[-1])
    reached = np.nonzero(main_loss >= final_score - args.parity_tol)[0]
    parity_epoch = int(reached[0]) if len(reached) else args.epochs
    seconds_to_parity = parity_epoch * elapsed / args.epochs
    cuda = device.type == "cuda"
    return {
        "metric": f"north_star_{args.cells}x{args.spots}x{args.genes}"
                  f"_{args.epochs}_epochs",
        "value": round(elapsed, 3),
        "unit": "seconds",
        "seconds_to_loss_parity": round(seconds_to_parity, 3),
        "parity_epoch": parity_epoch,
        "ms_per_step": round(elapsed / args.epochs * 1e3, 3),
        "final_train_score": round(final_score, 4),
        "mesh": f"{args.mesh} over {world_size()} {device.type} devices",
        "data": "synthetic-poisson",
        "backend": device.type,
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "peak_gib": (round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
                     if cuda else None),
    }


def main(argv=None) -> int:
    import torch.distributed as dist

    started_here = not dist.is_initialized()
    result = run(parse_args(argv))
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(result), flush=True)
    if started_here and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
