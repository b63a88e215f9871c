"""Randomized fuzz of the tuner's search modes (a tool, not a CI test: the
CPU suite carries seeded versions; run this for a deeper sweep). The port
of ``scripts/fuzz_tuner.py``.

Random shapes, search spaces (including spatial lambdas, schedules, fixed
zeros) and search modes through ``mapping_hyperparameter_tuning``,
checking per trial:

* the result frame's rows and columns, its metrics finite;
* same-seed determinism (the whole frame equal on a repeat run);
* over a mesh of the trial axis (``("trial",)``, or ``("trial", "cell")``,
  which also splits each trial's cells when they divide), the same
  eliminations and the metrics within 5e-3 of one device's, when a
  ``torch.distributed`` process group is running (under ``torchrun``, or
  one the caller started); the JAX tool's meshes of 4 and 2 x 3 virtual
  devices become the world's n ranks and 2 x n/2 of them (1 x n when n is
  odd);
* ``search="halving"``: rungs restarted under a forced-down memory budget
  give the carried state's eliminations and metrics.

Usage::

    python -m tangram_tpu_torch.scripts.fuzz_tuner [seed] [n_trials] [--device cpu]
    torchrun --nproc-per-node N -m tangram_tpu_torch.scripts.fuzz_tuner [seed] [n_trials]

Trial i of a seed draws the JAX tool's trial i: :func:`draw_trial` (with
:func:`make_adatas` and :func:`random_space`) and :func:`draw_mesh`
consume the ``default_rng(seed)`` stream in its order. Every rank draws
the same trials and only rank 0 prints. Exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import pandas as pd

from .. import tuning
from ..adlite import AnnData
from ..examples._world import start_world, world_meshes
from ..mapping import pp_adatas
from ..models.mapper import resolve_device

__all__ = ["make_adatas", "random_space", "TunerTrial", "draw_trial", "draw_mesh",
           "trial_meshes", "frame", "run", "main"]


def make_adatas(rng, c, s, g, n_types):
    """A single-cell and a spatial AnnData with ``obsm["spatial"]``, after
    ``pp_adatas``, drawn from ``rng`` as the JAX tool draws them."""
    genes = [f"g{i}" for i in range(g)]
    ad_sc = AnnData(
        X=(rng.poisson(2.0, (c, g)) + 1).astype(np.float32),
        obs=pd.DataFrame(
            {"subclass_label": rng.choice([f"t{t}" for t in range(n_types)], c)},
            index=[f"c{i}" for i in range(c)],
        ),
        var=pd.DataFrame(index=genes),
    )
    ad_sp = AnnData(
        X=(rng.poisson(3.0, (s, g)) + 1).astype(np.float32),
        var=pd.DataFrame(index=genes),
    )
    ad_sp.obsm["spatial"] = rng.random((s, 2)) * 100
    pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


def random_space(rng):
    """A search space drawn from ``rng`` as the JAX tool draws it: a
    learning-rate range, each optional key with probability 0.4 (a fixed
    value or a domain), and ``num_epochs``."""
    config = {"learning_rate": tuning.loguniform(0.02, 0.5)}
    optional = {
        "lambda_g1": lambda: tuning.uniform(0.5, 1.0),
        "lambda_d": lambda: tuning.uniform(0.0, 1.0),
        "lambda_r": lambda: tuning.loguniform(1e-10, 1e-3),
        "lambda_l1": lambda: float(rng.choice([0.0, 1e-4])),
        "lambda_l2": lambda: tuning.choice([0.0, 1e-4, 1e-3]),
        "lambda_neighborhood_g1": lambda: float(rng.choice([0.0, 0.3])),
        "lambda_ct_islands": lambda: tuning.uniform(0.0, 0.5),
        "lambda_getis_ord": lambda: float(rng.choice([0.0, 0.2])),
        "lr_peak": lambda: tuning.loguniform(0.2, 1.0),
        "lr_end": lambda: tuning.loguniform(0.01, 0.1),
    }
    for key, maker in optional.items():
        if rng.random() < 0.4:
            config[key] = maker()
    if "lr_peak" in config and "lr_end" not in config:
        config["lr_end"] = tuning.loguniform(0.01, 0.1)
    config["num_epochs"] = int(rng.choice([8, 12, 20]))
    return config


def trial_meshes(device):
    """The meshes of the trial-mesh check over the running process group:
    {"1d": ("trial",) over its n ranks, "2d": ("trial", "cell") of 2 x n/2
    when n is even, else 1 x n}; None when no process group is running."""
    return world_meshes(device, ("trial",), ("trial", "cell"))


@dataclasses.dataclass
class TunerTrial:
    """One trial as the JAX tool draws it: the pair (after ``pp_adatas``)
    and the tuner's arguments."""

    c: int
    s: int
    g: int
    n_types: int
    search: str
    n_samples: int
    batch: int
    metric: list
    config: dict
    seed: int
    ad_sc: AnnData
    ad_sp: AnnData

    def kwargs(self, device) -> dict:
        return dict(metric=self.metric, config=self.config,
                    tuner_num_samples=self.n_samples, cluster_label="subclass_label",
                    search=self.search, population_batch_size=self.batch,
                    random_state=self.seed, device=device)

    def label(self, trial: int) -> str:
        keys = sorted(k for k in self.config if k != "num_epochs")
        return (f"[{trial}] {self.search} c={self.c} s={self.s} g={self.g} "
                f"n={self.n_samples} keys={keys}")


def draw_trial(rng) -> TunerTrial:
    """The next trial from ``rng``, drawn in ``scripts/fuzz_tuner.py``'s
    order: the shape, the search mode, the sample and batch counts, the
    metrics, the space, the tuner's seed, then the pair."""
    c = int(rng.integers(12, 40))
    s = int(rng.integers(6, 24))
    g = int(rng.integers(6, 16))
    n_types = int(rng.integers(2, 5))
    search = str(rng.choice(["sobol", "adaptive", "halving", "adaptive+halving"]))
    n_samples = int(rng.integers(3, 9))
    batch = int(rng.integers(2, 5))
    metric = list(rng.choice(tuning.METRIC_KEYS, size=int(rng.integers(1, 3)), replace=False))
    config = random_space(rng)
    if "halving" in search:
        config["num_epochs"] = 16  # fixed budget required
    seed = int(rng.integers(0, 2**31))
    ad_sc, ad_sp = make_adatas(rng, c, s, g, n_types)
    return TunerTrial(c, s, g, n_types, search, n_samples, batch, metric, config, seed,
                      ad_sc, ad_sp)


def draw_mesh(rng):
    """The JAX tool's mesh coins, drawn after a trial's repeat: None (no
    mesh run), "1d" or "2d"."""
    if rng.random() < 0.5:
        return "1d" if rng.random() < 0.5 else "2d"
    return None


def frame(trial: TunerTrial, device, **kw):
    """The trial's result frame, numpy's global stream seeded first (the
    repeat inits continue it)."""
    np.random.seed(trial.seed % (2**31))
    return tuning.mapping_hyperparameter_tuning(
        trial.ad_sc, trial.ad_sp, **trial.kwargs(device), **kw).get_results().get_dataframe()


def run(seed: int, n_trials: int, device="cuda") -> int:
    """Run ``n_trials`` trials from ``seed`` on ``device``; returns how many
    failed. The trial-mesh runs need a process group (:func:`trial_meshes`)."""
    import torch.distributed as dist

    from .. import utils

    device = resolve_device(device)
    meshes = trial_meshes(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    if meshes is None:
        say("trial-mesh checks skipped: no torch.distributed process group (run under "
            "torchrun, or start one first)")
    rng = np.random.default_rng(seed)
    fails = 0
    for i in range(n_trials):
        trial = draw_trial(rng)
        label = trial.label(i)
        try:
            df1 = frame(trial, device)
            if len(df1) != trial.n_samples:
                raise AssertionError(f"row count {len(df1)}")
            for m in tuning.METRIC_KEYS:
                if m not in df1.columns:
                    raise AssertionError(f"missing {m}")
                if not np.isfinite(df1[m]).all():
                    raise AssertionError(f"non-finite {m}")
            # determinism
            pd.testing.assert_frame_equal(df1, frame(trial, device))
            kind = draw_mesh(rng)
            if kind is not None and meshes is not None:
                # trial data parallelism (a 2-D mesh also splits each
                # trial's cells when they divide) must reproduce the
                # unsharded run, halving's eliminations included
                mesh = meshes[kind]
                dfm = frame(trial, device, mesh=mesh)
                axes = mesh.mesh_dim_names
                if "trained_epochs" in df1.columns:
                    np.testing.assert_array_equal(
                        df1["trained_epochs"].to_numpy(), dfm["trained_epochs"].to_numpy(),
                        err_msg=f"mesh {axes} eliminations")
                for m in tuning.METRIC_KEYS:
                    np.testing.assert_allclose(df1[m].to_numpy(), dfm[m].to_numpy(),
                                               atol=5e-3, err_msg=f"mesh {axes} {m}")
            if "halving" in trial.search:
                # restart-mode rungs must reproduce carried-state results
                # (the tuner imports the budget from utils when it runs)
                budget = utils.device_memory_budget
                utils.device_memory_budget = lambda *a, **k: 1.0
                try:
                    df3 = frame(trial, device)
                finally:
                    utils.device_memory_budget = budget
                np.testing.assert_array_equal(df1["trained_epochs"].to_numpy(),
                                              df3["trained_epochs"].to_numpy())
                for m in tuning.METRIC_KEYS:
                    np.testing.assert_allclose(df1[m].to_numpy(), df3[m].to_numpy(),
                                               rtol=1e-4, atol=1e-5)
            say(f"{label}: ok")
        except Exception as err:  # a failed trial is reported and the fuzz goes on
            fails += 1
            say(f"{label}: FAIL {type(err).__name__}: {err}")
    say(f"{n_trials} trials, {fails} failures")
    return fails


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tangram_tpu_torch.scripts.fuzz_tuner",
                                description=__doc__.splitlines()[0])
    p.add_argument("seed", type=int, nargs="?", default=0)
    p.add_argument("n_trials", type=int, nargs="?", default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; 'cpu' runs the same code on the CPU")
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
