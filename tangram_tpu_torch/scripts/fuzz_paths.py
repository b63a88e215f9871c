"""Randomized fuzz of the training loops (a tool, not a CI test: the CPU
suite carries seeded versions; run this for a deeper sweep). The port of
``scripts/fuzz_paths.py``.

Random shapes, loss weights, gene masks, learning-rate vectors and
constrained mode through:

  the reference loop (``impl="reference"``: autograd through the
  materialized core)  vs  the fused loop (``impl="fused"``: the CUDA
  kernels on the card, their plain twins on the CPU)  vs  the fused loop
  sharded over a mesh (``parallel.fit_mapping_fused_sharded``)  vs  the
  same sharded fit in random chunks with its Adam state carried

hunting numeric divergence. Usage::

    python -m tangram_tpu_torch.scripts.fuzz_paths [seed] [n_trials] [--device cpu]
    torchrun --nproc-per-node N -m tangram_tpu_torch.scripts.fuzz_paths [seed] [n_trials]

The sharded pairs run over the ranks of a ``torch.distributed`` process
group: under ``torchrun`` (NCCL on the card, gloo with ``--device cpu``),
or one the caller started. Every rank draws the same trials and only rank
0 prints. The JAX tool's meshes are 8 virtual CPU devices ("1d") and 4 of
them as 2 x 2 ("2d"); here "1d" is ``("cell",)`` over the world's n ranks
and "2d" is ``("cell", "spot")`` of 2 x n/2 when n is even, else 1 x n.
Without a process group the tool says that it skipped the sharded pairs
and compares the fused loop with the reference loop alone.

Trial i of a seed is the JAX tool's trial i bit for bit (:func:`draw_trial`
consumes the ``default_rng(seed)`` stream in its order), held to its bounds
(past its ranges also by two rules of f32 scale: :data:`LOSS_ULPS`,
:data:`KINK_SHARE`). Exits non-zero on any divergence.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..examples._world import start_world, world_meshes
from ..models.mapper import fit_mapping, resolve_device
from ..ops.losses import LossWeights, MapperData

__all__ = ["Trial", "draw_trial", "trial_meshes", "loss_tol", "kinks", "run", "main",
           "C_RANGE", "S_RANGE", "G_RANGE", "LOSS_ULPS", "KINK_SHARE"]

#: the JAX tool's ranges of cells, spots and genes (``rng.integers(lo, hi)``:
#: ``hi`` excluded)
C_RANGE, S_RANGE, G_RANGE = (9, 70), (8, 50), (4, 20)
#: The JAX tool's bounds (logits within 2e-3 + 0.02 max(lr), losses within
#: 1e-3) hold unchanged at its ranges. Past them two f32 runs of one loop
#: miss them (the reference loop against itself started 1 ulp away, on the
#: CPU at c, s in the thousands with lambda_l1 > 0), in two ways, which
#: these rules admit and nothing else:
#: * a loss over millions of logits (lambda_l1 times the sum of |M|) has an
#:   f32 ulp near 1e-3: the loss bound is LOSS_ULPS ulps of the largest loss
#:   where that exceeds 1e-3 (|loss| >= 4,096);
#: * with lambda_l1 > 0 the gradient jumps by 2 lambda_l1 where a logit
#:   crosses 0, so a logit that two runs round to opposite signs at a step
#:   takes an Adam step of O(lr) apart: up to KINK_SHARE of the logits
#:   (rounded down: none at the JAX tool's ranges, at most 69 x 49 logits)
#:   may exceed the logit bound, each within max(lr) of 0 in the second run
#:   of the pair.
LOSS_ULPS, KINK_SHARE = 4, 1e-5


@dataclasses.dataclass
class Trial:
    """One trial's problem as the JAX tool draws it: ``d`` is drawn in every
    trial and enters the data where ``lw.lambda_d`` is set (always when
    constrained); ``target_count`` and ``F0`` only when constrained;
    ``mesh`` ("1d" or "2d") and ``cuts`` (the chunk boundaries of the
    chunked run) are drawn after the fits in the JAX tool, which draw
    nothing."""

    c: int
    s: int
    g: int
    constrained: bool
    S: np.ndarray
    G: np.ndarray
    d: np.ndarray
    M0: np.ndarray
    lw: LossWeights
    target_count: Optional[float]
    F0: Optional[np.ndarray]
    gene_mask: Optional[np.ndarray]
    epochs: int
    lr: object  # a float or a (epochs,) float32 vector
    mesh: str
    cuts: Optional[np.ndarray]


def draw_trial(rng: np.random.Generator, c_range=C_RANGE, s_range=S_RANGE,
               g_range=G_RANGE) -> Trial:
    """The next trial from ``rng``, drawn in ``scripts/fuzz_paths.py``'s
    order: c, s, g, constrained, S, G, d, M0, the weights (and the target
    count), F0, the mask coin and mask, epochs, the lr coin and lr, the mesh
    coin and the chunk cuts."""
    c = int(rng.integers(*c_range))
    s = int(rng.integers(*s_range))
    g = int(rng.integers(*g_range))
    constrained = bool(rng.integers(0, 2))
    S = (rng.gamma(2.0, 1.0, (c, g)) + 0.05).astype(np.float32)
    G = (rng.gamma(3.0, 1.0, (s, g)) + 0.05).astype(np.float32)
    d = rng.random(s).astype(np.float32)
    d /= d.sum()
    M0 = rng.normal(0, 1, (c, s)).astype(np.float32)
    target = F0 = None
    if constrained:
        lw = LossWeights(
            lambda_g1=float(rng.uniform(0.3, 2.0)),
            lambda_d=1.0,
            lambda_r=float(rng.choice([0.0, rng.uniform(0, 1e-2)])),
            lambda_count=float(rng.uniform(0.2, 2.0)),
            lambda_f_reg=float(rng.uniform(0.2, 2.0)),
        )
        target = float(rng.integers(s // 2, 2 * s))
        F0 = rng.normal(0, 1, (c,)).astype(np.float32)
    else:
        lw = LossWeights(
            lambda_g1=float(rng.uniform(0.3, 2.0)),
            lambda_d=float(rng.choice([0.0, 1.0])),
            lambda_g2=float(rng.choice([0.0, rng.uniform(0, 1)])),
            lambda_r=float(rng.choice([0.0, rng.uniform(0, 1e-2)])),
            lambda_l1=float(rng.choice([0.0, rng.uniform(0, 1e-2)])),
            lambda_l2=float(rng.choice([0.0, rng.uniform(0, 1e-3)])),
        )
    gene_mask = None
    if rng.integers(0, 2):
        # CV-fold-style gene masking: exercises the masked reductions
        gene_mask = (rng.random(g) < 0.7).astype(np.float32)
        if gene_mask.sum() == 0:
            gene_mask[0] = 1.0
    epochs = int(rng.integers(3, 25))
    lr = (np.linspace(0.3, 0.02, epochs).astype(np.float32)
          if rng.integers(0, 2) else float(rng.uniform(0.02, 0.5)))
    mesh = str(rng.choice(["1d", "2d"]))
    cuts = None
    if epochs > 2:
        n_cuts = int(rng.integers(1, min(3, epochs - 1) + 1))
        cuts = np.sort(rng.choice(np.arange(1, epochs), size=n_cuts, replace=False))
    return Trial(c, s, g, constrained, S, G, d, M0, lw, target, F0, gene_mask, epochs, lr,
                 mesh, cuts)


def _data(trial: Trial, device) -> MapperData:
    def put(x):
        return torch.tensor(x, device=device)

    if trial.constrained:
        data = MapperData(S=put(trial.S), G=put(trial.G), d=put(trial.d),
                          target_count=torch.tensor(trial.target_count, dtype=torch.float32,
                                                    device=device))
    else:
        data = MapperData(S=put(trial.S), G=put(trial.G),
                          d=put(trial.d) if trial.lw.lambda_d else None)
    if trial.gene_mask is not None:
        data = data._replace(gene_mask=put(trial.gene_mask))
    return data


def _start(trial: Trial, device):
    """Fresh start tensors (the loops update their parameters in place)."""
    M0 = torch.tensor(trial.M0, device=device)
    return (M0, torch.tensor(trial.F0, device=device)) if trial.constrained else M0


def _raw_start(trial: Trial):
    """The start as host arrays, as the sharded fit takes it."""
    return (trial.M0.copy(), trial.F0.copy()) if trial.constrained else trial.M0.copy()


def _leaves(params):
    return [np.asarray(p.float().cpu()) for p in
            (params if isinstance(params, (tuple, list)) else (params,))]


def _losses(history):
    return np.asarray(torch.as_tensor(history["total_loss"]).float().cpu())


def loss_tol(losses) -> float:
    """The loss bound for a pair whose second run recorded ``losses``:
    1e-3, or LOSS_ULPS f32 ulps of the largest where that is more."""
    top = np.float32(np.max(np.abs(losses))) if np.size(losses) else np.float32(0)
    return max(1e-3, LOSS_ULPS * float(np.spacing(top)))


def kinks(a, b, tol: float, lr_max: float):
    """The logits of ``a`` beyond ``tol`` from ``b`` that the L1 kink
    admits: all of them when each lies within ``lr_max`` of 0 in ``b`` and
    they are at most KINK_SHARE of the logits, else none. Returns (their
    count, how many were allowed)."""
    beyond = np.abs(a - b) > tol
    allowed = int(KINK_SHARE * b.size)
    n = int(beyond.sum())
    if n and n <= allowed and bool((np.abs(b[beyond]) <= lr_max).all()):
        return n, allowed
    return 0, allowed


def trial_meshes(device):
    """The meshes of the sharded pairs over the running process group:
    {"1d": ("cell",) over its n ranks, "2d": ("cell", "spot") of 2 x n/2
    when n is even, else 1 x n}; None when no process group is running."""
    return world_meshes(device, ("cell",), ("cell", "spot"))


def _sharded_fits(trial: Trial, data, lw, mesh):
    """(params, history) of one sharded fit, and of the chunked one: random
    chunk boundaries, Adam state carried, ``step_offset`` keeping the
    absolute epoch (lr vectors sliced per chunk). The chunked run must
    reproduce the single-call trajectory."""
    from ..parallel import fit_mapping_fused_sharded

    epochs, lr = trial.epochs, trial.lr
    p_s, h_s = fit_mapping_fused_sharded(_raw_start(trial), data, lw, epochs, lr, mesh=mesh)
    if trial.cuts is None:
        return (p_s, h_s), (p_s, h_s)
    p_c, opt_state, losses, start = _raw_start(trial), None, [], 0
    for b in [*trial.cuts.tolist(), epochs]:
        lr_chunk = lr[start:b] if np.ndim(lr) == 1 else lr
        p_c, opt_state, hc = fit_mapping_fused_sharded(
            p_c, data, lw, b - start, lr_chunk, mesh=mesh, opt_state=opt_state,
            return_opt_state=True, step_offset=start)
        losses.append(_losses(hc))
        start = b
    return (p_s, h_s), (p_c, {"total_loss": np.concatenate(losses)})


def run(seed: int, n_trials: int, device="cuda", c_range=C_RANGE, s_range=S_RANGE,
        g_range=G_RANGE) -> int:
    """Run ``n_trials`` trials from ``seed`` on ``device`` and return how
    many diverged; the ranges are ``rng.integers`` bounds (the JAX tool's by
    default). The sharded pairs run when a process group is up
    (:func:`trial_meshes`)."""
    import torch.distributed as dist

    device = resolve_device(device)
    meshes = trial_meshes(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    if meshes is None:
        say("sharded pairs skipped: no torch.distributed process group (run under "
            "torchrun, or start one first)")
    rng = np.random.default_rng(seed)
    fails = 0
    for trial in range(n_trials):
        t = draw_trial(rng, c_range, s_range, g_range)
        data, lw, lr, epochs = _data(t, device), t.lw, t.lr, t.epochs
        kw = dict(constrained=t.constrained)
        p_r, h_r = fit_mapping(_start(t, device), data, lw, epochs, lr, impl="reference", **kw)
        p_f, h_f = fit_mapping(_start(t, device), data, lw, epochs, lr, impl="fused",
                               fused=True, **kw)
        params = [("fused-vs-reference", p_f, p_r)]
        losses = [("loss fused-vs-reference", h_f, h_r)]
        mesh = None
        if meshes is not None:
            mesh = meshes[t.mesh]
            (p_s, h_s), (p_c, h_c) = _sharded_fits(t, data, lw, mesh)
            params += [("sharded-vs-fused", p_s, p_f), ("chunked-vs-sharded", p_c, p_s)]
            losses += [("loss sharded-vs-fused", h_s, h_f),
                       ("loss chunked-vs-sharded", h_c, h_s)]

        # Param tolerance is lr-aware: Adam's first step is ~lr*g/(|g|+eps),
        # so entries whose true gradient is near zero amplify benign
        # reduction-order noise into O(lr*1e-2) param differences. The loss
        # history is the stable discriminator and gets a tight bound.
        lr_max = float(np.max(lr))
        param_tol = 2e-3 + 0.02 * lr_max
        ok = True
        for name, a, b in params:
            for leaf_a, leaf_b in zip(_leaves(a), _leaves(b)):
                diff = float(np.max(np.abs(leaf_a - leaf_b)))
                n_kinks = 0
                if lw.lambda_l1 and np.isfinite(diff) and diff > param_tol:
                    n_kinks, allowed = kinks(leaf_a, leaf_b, param_tol, lr_max)
                    if n_kinks:
                        say(f"trial {trial}: {name} {n_kinks} logits beyond {param_tol:.1e} "
                            f"(max|d|={diff:.2e}), each within max(lr) {lr_max:.3g} of 0: "
                            f"the L1 kink (at most {allowed} of {leaf_b.size} admitted)")
                if not np.isfinite(diff) or (diff > param_tol and not n_kinks):
                    axes = None if mesh is None else mesh.mesh_dim_names
                    say(f"trial {trial}: {name} max|d|={diff:.2e} (tol {param_tol:.1e}) "
                        f"c={t.c} s={t.s} g={t.g} ep={epochs} mesh={axes} "
                        f"constrained={t.constrained} target={t.target_count} "
                        f"lr={'vec' if np.ndim(lr) else round(float(lr), 4)} lw={lw}")
                    ok = False
        for name, ha, hb in losses:
            dl = float(np.max(np.abs(_losses(ha) - _losses(hb))))
            if not np.isfinite(dl) or dl > loss_tol(_losses(hb)):
                say(f"trial {trial}: {name} max|dloss|={dl:.2e} c={t.c} s={t.s} g={t.g} "
                    f"ep={epochs} constrained={t.constrained}")
                ok = False
        fails += 0 if ok else 1
    say(f"{n_trials} trials, {fails} failures")
    return fails


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tangram_tpu_torch.scripts.fuzz_paths",
                                description=__doc__.splitlines()[0])
    p.add_argument("seed", type=int, nargs="?", default=0)
    p.add_argument("n_trials", type=int, nargs="?", default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if "WORLD_SIZE" not in os.environ:
        return 1 if run(args.seed, args.n_trials, device) else 0
    import torch.distributed as dist

    start_world(device)
    try:
        return 1 if run(args.seed, args.n_trials, device) else 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
