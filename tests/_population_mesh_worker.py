"""The port's side of ``tests/test_torch_population_mesh.py``: batched
cross-validation and the tuner on meshes of ``gloo`` processes on the CPU.

This module imports numpy, pandas, torch and ``tangram_tpu_torch`` only
(no JAX), so a spawned worker starts in about a second. :func:`run` spawns
``WORLD`` workers with a ``file://`` rendezvous in a directory; each runs
every case of :func:`cases` on its mesh, one torch thread each, and pickles
what it returned to ``rank<r>.pkl`` there, with the shapes that the fold
and population trainers were handed (the split that took place) and the
replication warnings it logged.

The fixtures (:func:`cv_adatas`, :func:`tuner_adatas`) take the package to
build them with, so that the test builds the same inputs for the JAX
package.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys
import traceback

import numpy as np
import pandas as pd
import torch

WORLD = 6

#: mesh name → (shape, axis names), built alike by both packages
MESHES = {
    "fold": ((6,), ("fold",)),
    "fold cell": ((2, 3), ("fold", "cell")),
    "first axis": ((2, 3), ("batch", "cell")),
    "trial": ((6,), ("trial",)),
    "trial cell": ((2, 3), ("trial", "cell")),
}


def cv_adatas(api, n_cells=30):
    """``tests/test_cross_val.py``'s ``cv_adatas`` (30 cells × 20 spots × 12
    genes, 3 cell types) through ``api``'s AnnData, the training genes
    sorted: ``cv_data_gen`` folds them in their order, which the JAX
    package's ``pp_adatas`` leaves to set iteration."""
    rng = np.random.default_rng(0)
    n_spots, n_genes = 20, 12
    centers = rng.normal(0, 1, (3, n_genes)) * 2
    labels = rng.integers(0, 3, n_cells)
    S = rng.poisson(np.exp(centers[labels] * 0.5) + 0.5).astype(np.float32)
    G = rng.poisson(
        np.exp(centers[rng.integers(0, 3, n_spots)] * 0.5) + 0.5).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(n_genes)])
    ad_sc = api.AnnData(
        X=S, obs=pd.DataFrame({"subclass_label": pd.Categorical([f"c{x}" for x in labels])},
                              index=[f"cell{i}" for i in range(n_cells)]),
        var=genes.copy())
    ad_sp = api.AnnData(X=G, obs=pd.DataFrame(index=[f"s{i}" for i in range(n_spots)]),
                        var=genes.copy())
    api.pp_adatas(ad_sc, ad_sp)
    for ad in (ad_sc, ad_sp):
        ad.uns["training_genes"] = sorted(ad.uns["training_genes"])
    return ad_sc, ad_sp


def tuner_adatas(api, n_cells=30):
    """``tests/test_tuning.py``'s ``tuner_adatas`` (30 cells × 24 spots × 12
    genes, 3 cell types, random spot positions) through ``api``'s AnnData."""
    rng = np.random.default_rng(0)
    n_spots, n_genes = 24, 12
    S = (rng.poisson(2.0, (n_cells, n_genes)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (n_spots, n_genes)) + 1).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(n_genes)])
    ad_sc = api.AnnData(
        X=S, obs=pd.DataFrame({"subclass_label": pd.Categorical(
            rng.choice(["a", "b", "c"], n_cells))}, index=[f"c{i}" for i in range(n_cells)]),
        var=genes.copy())
    ad_sp = api.AnnData(X=G, obs=pd.DataFrame(index=[f"s{i}" for i in range(n_spots)]),
                        var=genes.copy())
    ad_sp.obsm["spatial"] = rng.random((n_spots, 2))
    api.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


CV_MODES = {
    "cells": {},
    "clusters": {"cluster_label": "subclass_label"},
    "constrained": {"target_count": 15, "density_prior": "uniform"},
}

#: name → (mesh, n_cells, cross_val's arguments): JAX's
#: ``tests/test_cross_val.py`` cases on a world of six
CV_CASES = {
    # 10 folds as 6 + 4: the first batch one fold a rank, the second whole
    "cv fold": ("fold", 30, dict(mode="cells", cv_mode="10fold", num_epochs=30,
                                 random_state=7, fold_batch_size=6)),
    "cv fold cell": ("fold cell", 30, dict(mode="cells", cv_mode="10fold", num_epochs=30,
                                           random_state=7, fold_batch_size=8)),
    "cv fold cell constrained": ("fold cell", 30, dict(
        mode="constrained", cv_mode="10fold", num_epochs=30, random_state=7,
        fold_batch_size=8, **CV_MODES["constrained"])),
    # no "fold" axis: the first one carries the folds; three clusters on
    # three cell ranks
    "cv first axis clusters": ("first axis", 30, dict(
        mode="clusters", cv_mode="10fold", num_epochs=30, random_state=7,
        fold_batch_size=4, **CV_MODES["clusters"])),
    # 32 cells do not divide the 3 cell ranks: replicated, with the warning
    "cv replicated": ("fold cell", 32, dict(mode="cells", cv_mode="10fold", num_epochs=30,
                                            random_state=7, fold_batch_size=8)),
}
CV_RESUME = dict(mode="cells", cv_mode="loo", num_epochs=15, random_state=3,
                 fold_batch_size=4, return_gene_pred=True)

TUNER_BASE = dict(metric=["gene_expr_correctness"], cluster_label="subclass_label",
                  density_prior="uniform")


def tuner_space(api, kind):
    if kind == "density":
        return {"lambda_g1": 1.0, "lambda_d": api.uniform(0.1, 1.0), "num_epochs": 25}
    return {"learning_rate": api.loguniform(0.02, 0.5), "lambda_d": api.uniform(0.1, 1.0),
            "num_epochs": 16}


#: name → (mesh, n_cells, space, the tuner's arguments): JAX's
#: ``tests/test_tuning.py`` and ``tests/test_adaptive_search.py`` cases on a
#: world of six
TUNER_CASES = {
    # 8 trials as 6 + 2: one a rank, then whole
    "tuner trial": ("trial", 30, "density", dict(tuner_num_samples=8, random_state=11,
                                                 population_batch_size=6)),
    "tuner trial cell": ("trial cell", 30, "density", dict(
        tuner_num_samples=4, random_state=11, population_batch_size=4)),
    # rungs of 6 and 2 alive, both on the trial axis
    "halving carried": ("trial cell", 30, "halving", dict(
        tuner_num_samples=6, random_state=3, population_batch_size=3, search="halving")),
    # chunks of 3 (whole) then 2 (on the trial axis)
    "halving restarted": ("trial cell", 30, "halving", dict(
        tuner_num_samples=6, random_state=3, population_batch_size=3, search="halving")),
    "adaptive": ("trial", 30, "density", dict(tuner_num_samples=8, random_state=4,
                                              population_batch_size=6, search="adaptive")),
    # brackets of 4 configs: rungs of 4 and 2 alive
    "adaptive+halving": ("trial cell", 30, "halving", dict(
        tuner_num_samples=8, random_state=4, population_batch_size=4,
        search="adaptive+halving")),
    "tuner replicated": ("trial cell", 28, "density", dict(
        tuner_num_samples=4, random_state=3, population_batch_size=4)),
}
TUNER_SEED = 11  # the ambient numpy seed: run 0's init continues its stream

#: what the trainers were handed in the current case
CALLS = []


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        if "REPLICATION" in record.getMessage():
            self.messages.append(record.getMessage())


def _spy():
    """Record the (members, cells) of every fold batch and population that
    the trainers train: the split that took place."""
    from tangram_tpu_torch import evaluation, tuning

    fit_folds = evaluation._fit_folds

    def spy_folds(params0, data, masks, *args, **kwargs):
        M0 = params0[0] if isinstance(params0, tuple) else params0
        CALLS.append((int(masks.shape[0]), int(M0.shape[0])))
        return fit_folds(params0, data, masks, *args, **kwargs)

    train = tuning._PopulationSetup._train

    def spy_train(self, lam_mat, lr_peaks, lr_ends, M, *args, **kwargs):
        CALLS.append((int(M.shape[0]), int(M.shape[2])))
        return train(self, lam_mat, lr_peaks, lr_ends, M, *args, **kwargs)

    evaluation._fit_folds = spy_folds
    tuning._PopulationSetup._train = spy_train


def cv_case(name, meshes):
    import tangram_tpu_torch as tgt

    mesh, n_cells, kw = CV_CASES[name]
    out = tgt.cross_val(*cv_adatas(tgt, n_cells), device="cpu", verbose=False,
                        mesh=meshes[mesh], **kw)
    return {"cv": out}


def cv_resume_case(meshes, directory):
    """A LOO sweep journaled on the ("fold", "cell") mesh, its journal cut
    to the meta line and the first batch by the lead rank, and resumed."""
    import torch.distributed as dist

    import tangram_tpu_torch as tgt

    path = os.path.join(directory, "cv.jsonl")
    ad_sc, ad_sp = cv_adatas(tgt)
    kw = dict(device="cpu", verbose=False, mesh=meshes["fold cell"], **CV_RESUME)
    full, full_ge, full_df = tgt.cross_val(ad_sc, ad_sp, resume_path=path, **kw)
    with open(path) as f:
        lines = f.read().splitlines()
    dist.barrier()
    if dist.get_rank() == 0:
        with open(path, "w") as f:
            f.write("\n".join(lines[:1 + CV_RESUME["fold_batch_size"]]) + "\n")
    dist.barrier()
    resumed, res_ge, res_df = tgt.cross_val(ad_sc, ad_sp, resume_path=path, **kw)
    return dict(full=full, full_X=np.asarray(full_ge.X), full_df=full_df,
                resumed=resumed, resumed_X=np.asarray(res_ge.X), resumed_df=res_df,
                lines=len(lines))


def tuner_case(name, meshes):
    import tangram_tpu_torch as tgt
    import tangram_tpu_torch.utils as tutils

    mesh, n_cells, space, kw = TUNER_CASES[name]
    budget = tutils.device_memory_budget
    if name == "halving restarted":
        tutils.device_memory_budget = lambda *a, **k: 1.0
    try:
        np.random.seed(TUNER_SEED)
        df = tgt.mapping_hyperparameter_tuning(
            *tuner_adatas(tgt, n_cells), config=tuner_space(tgt.tuning, space),
            device="cpu", mesh=meshes[mesh], **TUNER_BASE, **kw).get_results().get_dataframe()
    finally:
        tutils.device_memory_budget = budget
    return {"df": df}


def tuner_resume_case(meshes, directory):
    """A Sobol sweep journaled on the ("trial", "cell") mesh, cut to its
    first batch by the lead rank and resumed."""
    import torch.distributed as dist

    import tangram_tpu_torch as tgt

    path = os.path.join(directory, "tuner.jsonl")
    kw = dict(config=tuner_space(tgt.tuning, "density"), device="cpu",
              mesh=meshes["trial cell"], tuner_num_samples=8, random_state=5,
              population_batch_size=4, resume_path=path, **TUNER_BASE)
    frames = []
    for cut in (False, True):
        if cut:
            dist.barrier()
            if dist.get_rank() == 0:
                with open(path, "w") as f:
                    f.write("\n".join(lines[:1 + 4]) + "\n")
            dist.barrier()
        np.random.seed(TUNER_SEED)
        frames.append(tgt.mapping_hyperparameter_tuning(
            *tuner_adatas(tgt), **kw).get_results().get_dataframe())
        with open(path) as f:
            lines = f.read().splitlines()
    return dict(full=frames[0], resumed=frames[1], lines=len(lines))


def metrics_case(meshes):
    """``_device_metrics`` of a random (configs, runs, cells, spots) cube
    on this rank's cell block of the ("trial", "cell") mesh and whole."""
    from tangram_tpu_torch import tuning
    from tangram_tpu_torch.parallel.mesh import BatchLayout

    rng = np.random.default_rng(3)
    c, s, v = 30, 17, 5
    Ps = torch.softmax(torch.from_numpy(rng.normal(0, 2, (2, 3, c, s)).astype(np.float32)), -1)
    # a tie in one cell's votes across runs
    Ps[:, :, 4] = Ps[:, :1, 4]
    val = torch.from_numpy(rng.random((2, 3)).astype(np.float32))
    S_val = torch.from_numpy(rng.random((c, v)).astype(np.float32))
    layout = BatchLayout(meshes["trial cell"], "trial", c, "per-trial")
    rows = layout.rows
    part = tuning._device_metrics(Ps[:, :, rows], val, S_val[rows], layout.cell, c)
    whole = tuning._device_metrics(Ps, val, S_val)
    return dict(rows=(rows.start, rows.stop), part={k: v.numpy() for k, v in part.items()},
                whole={k: v.numpy() for k, v in whole.items()})


def cases(meshes, directory):
    jobs = [(name, lambda name=name: cv_case(name, meshes)) for name in CV_CASES]
    jobs.append(("cv resume", lambda: cv_resume_case(meshes, directory)))
    jobs += [(name, lambda name=name: tuner_case(name, meshes)) for name in TUNER_CASES]
    jobs.append(("tuner resume", lambda: tuner_resume_case(meshes, directory)))
    jobs.append(("device metrics", lambda: metrics_case(meshes)))
    return jobs


def worker(rank, directory):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh

    from tangram_tpu_torch import parallel as par

    par.init_distributed("file://" + os.path.join(directory, "rendezvous"), WORLD, rank,
                         backend="gloo")
    meshes = {name: DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                               mesh_dim_names=names)
              for name, (shape, names) in MESHES.items()}
    _spy()
    warnings = _Warnings()
    logging.getLogger().addHandler(warnings)
    results = {}
    for name, job in cases(meshes, directory):
        CALLS.clear()
        warnings.messages.clear()
        try:
            out = job()
        except Exception:  # every rank reports; a collective that failed hangs no test
            results[name] = {"error": traceback.format_exc()}
            break
        results[name] = dict(out, calls=list(CALLS), warnings=list(warnings.messages))
    with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    # a normal interpreter exit can abort in the teardown of the process
    # group's threads (tests/_parallel_worker.py)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run(directory, timeout=300.0):
    """Spawn the workers and return each rank's results; the workers are
    stopped after ``timeout`` seconds (a collective that one rank never
    reaches would wait for ever)."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(worker, args=(directory,), nprocs=WORLD,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"the gloo workers did not finish in {timeout} s")
    out = []
    for rank in range(WORLD):
        with open(os.path.join(directory, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
