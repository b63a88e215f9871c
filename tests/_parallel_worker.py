"""The port's side of ``tests/test_torch_parallel.py``, of the mesh cases
of ``tests/test_torch_printing.py`` and of the torchrun branches of
``tests/test_torch_north_star.py``,
``tests/test_torch_examples_torchrun.py`` and
``tests/test_torch_fuzz_{paths,tuner}.py``, and of
``tests/test_torch_mesh_of_one.py`` (suite ``"one"``, a world of one):
every case trained on a mesh of ``gloo`` processes on the CPU.

This module imports numpy, torch and ``tangram_tpu_torch`` only (no JAX),
so a spawned worker starts in about a second. :func:`run` spawns
``WORLD`` workers with a ``file://`` rendezvous in a directory (no port to
collide between test workers); each runs every case of one suite (the
fits of :data:`CASES` and the checks below, the printing cases, the north
star's cases, the tutorials' or the fuzzers'), one torch thread each, and
pickles its results to ``rank<r>.pkl`` there.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import sys
import traceback

import numpy as np
import torch

WORLD = 4


def make_problem(c, s, g=10, seed=0, with_d=True):
    """The inputs of ``tests/test_fused_sharded.py::make_problem`` (its
    init stream: seed 5), from a seeded generator, with a filter F0."""
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = None
    if with_d:
        d = rng.random(s).astype(np.float32)
        d /= d.sum()
    ct = np.zeros((c, 3), np.float32)
    ct[np.arange(c), rng.integers(0, 3, c)] = 1
    W = (0.05 * rng.random((s, s)) * (rng.random((s, s)) < 0.05)).astype(np.float32)
    ds = rng.random(c).astype(np.float32)
    M0 = np.random.RandomState(5).normal(0, 1, (c, s)).astype(np.float32)
    return dict(M0=M0, S=S, G=G, d=d, F0=rng.normal(size=c).astype(np.float32),
                ct=ct, W=W, d_source=ds / ds.sum())


PLAIN = dict(lambda_g1=1.0)
FULL = dict(lambda_g1=1.0, lambda_d=1.0, lambda_g2=0.5, lambda_r=0.01)
DENSITY = dict(lambda_g1=1.0, lambda_d=1.0)
NORMS = dict(lambda_g1=1.0, lambda_d=1.0, lambda_l1=0.01, lambda_l2=0.005)
CONSTRAINED = dict(lambda_g1=1.0, lambda_d=1.0, lambda_count=1.0, lambda_f_reg=1.0)

#: name → (problem, lambdas, mesh, epochs, options): the fits held to the
#: JAX package's sharded fits of the same name in test_torch_parallel.py.
#: ``target`` makes the problem constrained; ``clusters`` adds the cluster
#: densities, the one-hot cell types and a weak islands graph.
CASES = {
    "1d plain": (dict(c=64, s=48, with_d=False), PLAIN, "1d", 20, {}),
    "1d full": (dict(c=64, s=48), FULL, "1d", 20, {}),
    "1d clusters": (dict(c=32, s=40, g=8), dict(DENSITY, lambda_ct_islands=0.4), "1d", 15,
                    dict(clusters=True)),
    "1d padded": (dict(c=30, s=48), DENSITY, "1d", 15, {}),
    "1d constrained": (dict(c=48, s=36), CONSTRAINED, "1d", 20, dict(target=200.0)),
    "1d l1 l2": (dict(c=64, s=48), NORMS, "1d", 15, {}),
    "2d plain": (dict(c=30, s=41), dict(DENSITY, lambda_g2=0.5), "2d", 15, {}),
    "2d l1 l2": (dict(c=30, s=41), NORMS, "2d", 15, {}),
    "2d constrained": (dict(c=30, s=41), CONSTRAINED, "2d", 15, dict(target=200.0)),
    "slice": (dict(c=50, s=24), dict(DENSITY, lambda_r=0.01), "slice", 15, {}),
    "slice 2d": (dict(c=50, s=21), dict(DENSITY, lambda_r=0.01), "slice2d", 15, {}),
    "slice 2d constrained": (dict(c=48, s=20, g=8), CONSTRAINED, "slice2d", 12,
                             dict(target=15.0)),
    "generic constrained": (dict(c=32, s=24), CONSTRAINED, "2d", 15,
                            dict(target=200.0, generic=True)),
    "generic adafactor": (dict(c=32, s=24), DENSITY, "2d", 12,
                          dict(generic=True, optimizer="adafactor")),
    "1d stochastic": (dict(c=64, s=48), DENSITY, "1d", 20,
                      dict(bf16=True, rounding="stochastic")),
}


def torch_data(p, opts):
    from tangram_tpu_torch.ops.losses import MapperData

    t = (lambda x: None if x is None else torch.from_numpy(np.asarray(x).copy()))
    data = MapperData(S=t(p["S"]), G=t(p["G"]), d=t(p["d"]))
    if "target" in opts:
        data = data._replace(target_count=torch.tensor(np.float32(opts["target"])))
    if opts.get("clusters"):
        data = data._replace(d_source=t(p["d_source"]), ct_encode=t(p["ct"]),
                             neighborhood_filter=t(p["W"]))
    return data


def _numpy(out, hist):
    params = out if isinstance(out, tuple) else (out, None)
    return dict(M=params[0].float().numpy(), dtype=str(params[0].dtype),
                F=None if params[1] is None else params[1].numpy(),
                hist={k: v.cpu().numpy() for k, v in hist.items()})


def fit_case(name, meshes, perm=None):
    """Case ``name`` on its mesh; ``perm`` trains the same problem with its
    cells in that order (the rounding witness of a free-running
    Adafactor trajectory) and puts the logits back in order."""
    from tangram_tpu_torch import parallel as par
    from tangram_tpu_torch.ops.losses import LossWeights

    problem, lam, mesh, epochs, opts = CASES[name]
    p = make_problem(**problem)
    if perm is not None:
        p = dict(p, M0=p["M0"][perm], S=p["S"][perm], F0=p["F0"][perm])
    data = torch_data(p, opts)
    M0 = torch.from_numpy(p["M0"].copy())
    params = (M0, torch.from_numpy(p["F0"].copy())) if "target" in opts else M0
    kw = {}
    if opts.get("generic"):
        fit = par.fit_mapping_sharded
        kw = dict(constrained="target" in opts, optimizer=opts.get("optimizer", "adam"))
    else:
        fit = par.fit_mapping_fused_sharded
        if opts.get("bf16"):
            params = params.to(torch.bfloat16)
            kw = dict(moment_dtype="bfloat16", rounding=opts["rounding"])
    out, hist = fit(params, data, LossWeights(**lam), epochs, 0.1, mesh=meshes[mesh], **kw)
    res = _numpy(out, hist)
    if perm is not None:
        back = np.empty_like(res["M"])
        back[perm] = res["M"]
        res["M"] = back
    return res


def resume_case(meshes):
    """Two chunked runs with the carried state against one unbroken run
    (1-D and 2-D, and 1-D constrained), the state round-tripped through
    the host as a checkpoint would."""
    from tangram_tpu_torch import parallel as par
    from tangram_tpu_torch.ops.losses import LossWeights

    out = {}
    for label, mesh, constrained in (("1d", "1d", False), ("2d", "2d", False),
                                     ("1d constrained", "1d", True)):
        p = make_problem(c=30, s=42)
        lw = LossWeights(**(CONSTRAINED if constrained else DENSITY))
        data = torch_data(p, dict(target=200.0) if constrained else {})

        def start():
            M0 = torch.from_numpy(p["M0"].copy())
            return (M0, torch.from_numpy(p["F0"].copy())) if constrained else M0

        kw = dict(mesh=meshes[mesh])
        full, _ = par.fit_mapping_fused_sharded(start(), data, lw, 16, 0.1, **kw)
        half, state, _ = par.fit_mapping_fused_sharded(start(), data, lw, 8, 0.1,
                                                       return_opt_state=True, **kw)
        state = {k: v.cpu() if torch.is_tensor(v) else v for k, v in state.items()}
        again, _ = par.fit_mapping_fused_sharded(half, data, lw, 8, 0.1, opt_state=state,
                                                 step_offset=8, **kw)
        pair = (lambda x: x if constrained else (x,))
        out[label] = [(a.numpy(), b.numpy()) for a, b in zip(pair(again), pair(full))]
    return out


def mapper_val_case(meshes):
    """``Mapper(mesh=).train(val_each=5)`` on both layouts, as
    ``tests/test_fused_sharded.py::test_mesh_with_val_matches_single_device``
    builds it."""
    from tangram_tpu_torch.models.mapper import Mapper

    rng = np.random.default_rng(11)
    S = (rng.poisson(2.0, (32, 10)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (24, 10)) + 0.5).astype(np.float32)
    out = {"S": S, "G": G}
    for mesh in ("1d", "2d"):
        mapper = Mapper(S=S, G=G, random_state=3, device="cpu", mesh=meshes[mesh])
        probs, hist = mapper.train(num_epochs=20, learning_rate=0.1, print_each=None,
                                   val_each=5)
        out[mesh] = (probs, {k: np.asarray(v) for k, v in hist.items()})
    # the expression init, each rank's block gathered, against one process's
    from tangram_tpu_torch.models.mapper import expression_init_logits

    out["expression"] = (Mapper(S=S, G=G, device="cpu", init_method="expression",
                                mesh=meshes["2d"]).M.numpy(),
                         expression_init_logits(S, G).numpy())
    # early stopping in windows on the mesh against one process
    stops = []
    for mesh in (meshes["1d"], None):
        mapper = Mapper(S=S, G=G, random_state=3, device="cpu", mesh=mesh, impl="fused")
        _, hist = mapper.train(num_epochs=400, print_each=None, early_stop_tol=1e-3,
                               early_stop_window=20)
        stops.append(np.asarray(hist["main_loss"]))
    out["early stop"] = stops
    return out


def public_api_case(meshes):
    """``map_cells_to_space(mesh=)`` in cells and constrained modes, as
    ``tests/test_fused_sharded.py::test_mesh_through_public_api``."""
    import pandas as pd

    import tangram_tpu_torch as tgt

    c, s, g = 64, 40, 16
    rng = np.random.default_rng(12)
    S = (rng.poisson(2.0, (c, g)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (s, g)) + 1).astype(np.float32)
    ad_sc = tgt.AnnData(X=S, obs=pd.DataFrame(index=[f"c{i}" for i in range(c)]),
                        var=pd.DataFrame(index=[f"g{i}" for i in range(g)]))
    ad_sp = tgt.AnnData(X=G, var=pd.DataFrame(index=[f"g{i}" for i in range(g)]))
    tgt.pp_adatas(ad_sc, ad_sp)
    kw = dict(device="cpu", mesh=meshes["1d"], random_state=42, verbose=False)
    plain = tgt.map_cells_to_space(ad_sc, ad_sp, num_epochs=25, **kw)
    con = tgt.map_cells_to_space(ad_sc, ad_sp, mode="constrained", target_count=200,
                                 num_epochs=25, density_prior="uniform", **kw)
    return dict(S=S, G=G, X=np.asarray(plain.X), X_con=np.asarray(con.X),
                F_out=np.asarray(con.obs["F_out"]),
                report=plain.uns["train_genes_df"]["train_score"].to_dict())


def adjoint_case(meshes):
    """The collectives' gradients: a loss that every rank computes alike
    from Σ_r x_r has the gradient Σ_r x_r on each rank through
    ``sum_replicated`` (``torch.distributed.nn.functional.all_reduce`` gives
    WORLD times that); and the sharded materialized core's gradient in M,
    with the entropy and random cotangents of Y and q, against autograd of
    the single-process core, on the 2-D mesh."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    from tangram_tpu_torch.ops.core import mapper_core_reference
    from tangram_tpu_torch.parallel import mesh as pm

    rank = dist.get_rank()
    axis = pm._axis(meshes["1d"], ("cell",))
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    ours = torch.autograd.grad(0.5 * torch.sum(pm.sum_replicated(x, axis) ** 2), x)[0]
    y = torch.full((3,), float(rank + 1), requires_grad=True)
    theirs = torch.autograd.grad(0.5 * torch.sum(dnn.all_reduce(y) ** 2), y)[0]

    rng = np.random.default_rng(13)
    c, s, k = 18, 25, 4
    M = rng.normal(size=(c, s)).astype(np.float32)
    A = rng.random((c, k)).astype(np.float32)
    w = rng.random(c).astype(np.float32)
    cY = rng.normal(size=(s, k)).astype(np.float32)
    cq = rng.normal(size=s).astype(np.float32)

    def loss(Y, q, h_sum):
        return torch.sum(Y * torch.from_numpy(cY)) + torch.sum(q * torch.from_numpy(cq)) + h_sum

    M_full = torch.from_numpy(M).requires_grad_()
    Y, q, h = mapper_core_reference(M_full, torch.from_numpy(A), torch.from_numpy(w))
    truth = torch.autograd.grad(loss(Y, q, torch.sum(h)), M_full)[0]
    lay = pm._Layout(meshes["2d"], c, s)
    M_l = lay.block(torch.from_numpy(M)).requires_grad_()
    Y, q, h_sum = pm._sharded_core(M_l, lay.cell_rows(torch.from_numpy(A)),
                                   lay.cell_rows(torch.from_numpy(w)), lay)
    dM = torch.autograd.grad(loss(Y[:s], q[:s], h_sum), M_l)[0]
    return dict(ours=ours.numpy(), theirs=theirs.numpy(), x_sum=float(sum(range(1, WORLD + 1))),
                dM=lay.gather(dM).numpy(), truth=truth.numpy())


def checkpoint_case(meshes, directory):
    """``train_checkpointed(mesh=)`` cut after 8 epochs and resumed to 16,
    against 16 unbroken epochs."""
    from tangram_tpu_torch import checkpoint
    from tangram_tpu_torch.ops.losses import LossWeights

    p = make_problem(c=30, s=41)
    data, lw = torch_data(p, {}), LossWeights(**DENSITY)
    kw = dict(checkpoint_every=4, mesh=meshes["2d"])
    full, h_full = checkpoint.train_checkpointed(torch.from_numpy(p["M0"].copy()), data, lw,
                                                 16, 0.1, os.path.join(directory, "a"), **kw)
    cut = os.path.join(directory, "b")
    checkpoint.train_checkpointed(torch.from_numpy(p["M0"].copy()), data, lw, 8, 0.1, cut,
                                  **kw)
    again, h_again = checkpoint.train_checkpointed(torch.from_numpy(p["M0"].copy()), data,
                                                   lw, 16, 0.1, cut, **kw)
    _, _, state, _ = checkpoint.restore(cut)
    return dict(full=full.numpy(), again=again.numpy(), h_full=h_full["total_loss"],
                h_again=h_again["total_loss"], mu_shape=tuple(state["mu"].shape))


def shardings_case(meshes):
    """This rank's blocks from ``shard_mapping`` on the 2-D mesh."""
    from tangram_tpu_torch import parallel as par

    p = make_problem(c=30, s=41)
    data = torch_data(p, {})
    M = torch.from_numpy(p["M0"])
    (M_b, F_b), d_b = par.shard_mapping((M, torch.from_numpy(p["F0"])), data, meshes["2d"])
    (rows, cols), _ = par.mapping_shardings(meshes["2d"])
    return dict(ok=bool(torch.equal(M_b, M[rows.slice(30), cols.slice(41)])
                        and torch.equal(F_b, torch.from_numpy(p["F0"])[rows.slice(30)])
                        and torch.equal(d_b.S, data.S[rows.slice(30)])
                        and torch.equal(d_b.G, data.G[cols.slice(41)])
                        and torch.equal(d_b.d, data.d[cols.slice(41)])),
                shape=tuple(M_b.shape))


def schedule_case(meshes):
    """A cosine learning-rate vector on the fused sharded path (1-D and 2-D)
    and the generic one (2-D), as ``tests/test_lr_schedule.py`` runs them,
    ``Mapper(mesh=).train`` with a schedule on the 2-D mesh, and whether a
    vector of the wrong length is refused."""
    from tangram_tpu_torch import parallel as par
    from tangram_tpu_torch.models.mapper import Mapper
    from tangram_tpu_torch.ops.losses import LossWeights
    from tangram_tpu_torch.ops.schedules import cosine_lr

    p = make_problem(c=32, s=24)
    data, lw = torch_data(p, {}), LossWeights(**DENSITY)
    lrs = cosine_lr(0.5, 10, end=0.05)

    def fit(fn, mesh):
        M, hist = fn(torch.from_numpy(p["M0"].copy()), data, lw, 10, lrs, mesh=meshes[mesh])
        return M.numpy(), hist["total_loss"].numpy()

    out = {"fused 1d": fit(par.fit_mapping_fused_sharded, "1d"),
           "fused 2d": fit(par.fit_mapping_fused_sharded, "2d"),
           "generic 2d": fit(par.fit_mapping_sharded, "2d")}
    rng = np.random.default_rng(21)
    S = (rng.poisson(2.0, (32, 8)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (24, 8)) + 0.5).astype(np.float32)
    out["mapper"] = Mapper(S=S, G=G, random_state=2, device="cpu", mesh=meshes["2d"]).train(
        num_epochs=15, learning_rate=cosine_lr(0.4, 15, end=0.04), print_each=None)[0]
    try:
        par.fit_mapping_fused_sharded(torch.from_numpy(p["M0"].copy()), data, lw, 6,
                                      np.asarray([0.1, 0.2], np.float32), mesh=meshes["1d"])
        out["refused"] = None
    except ValueError as err:
        out["refused"] = str(err)
    return out


def printing_problem():
    """``tests/test_printing.py``'s ``problem`` fixture (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    S = (rng.poisson(2.0, (12, 8)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (9, 8)) + 0.5).astype(np.float32)
    return S, G, np.full(9, 1 / 9, np.float32)


def printed(fn):
    """``fn()``'s result and the non-blank lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [line for line in buf.getvalue().splitlines() if line.strip()]


def printing_jobs(meshes):
    """The mesh cases of ``tests/test_printing.py`` on the 1-D ``("cell",)``
    mesh of 4: what each printed, its mapping and its history."""
    from tangram_tpu_torch.models.mapper import Mapper, MapperConstrained

    S, G, d = printing_problem()
    kw = dict(random_state=2, device="cpu", mesh=meshes["1d"])

    def stream():
        (probs, hist), lines = printed(lambda: Mapper(S=S, G=G, d=d, lambda_d=1.0, **kw).train(
            num_epochs=20, learning_rate=0.1, print_each=10))
        return dict(lines=lines, probs=probs, main_loss=np.asarray(hist["main_loss"]))

    def val_cadence():
        (_, hist), lines = printed(lambda: Mapper(S=S, G=G, **kw).train(
            num_epochs=20, learning_rate=0.1, print_each=10, val_each=7))
        return dict(lines=lines, val=np.asarray(hist["val_gene_sim"]))

    def early_stop():
        (_, hist), lines = printed(lambda: Mapper(S=S, G=G, **kw).train(
            num_epochs=24, learning_rate=0.1, print_each=None, val_each=3,
            early_stop_tol=0.0, early_stop_window=10))
        return dict(lines=lines, main_loss=np.asarray(hist["main_loss"]),
                    val=np.asarray(hist["val_gene_sim"]))

    def constrained():
        (probs, F, _), lines = printed(lambda: MapperConstrained(
            S=S, G=G, d=d, target_count=6, **kw).train(num_epochs=20, learning_rate=0.1,
                                                       print_each=10))
        return dict(lines=lines, probs=probs, F=F)

    return [("stream", stream), ("val cadence", val_cadence), ("early stop", early_stop),
            ("constrained", constrained)]


def north_star_jobs():
    """``tangram_tpu_torch.north_star`` in a world of ``WORLD`` processes:
    ``main`` at the tiny shape on each mesh (what each rank printed), and
    ``train`` from one numpy start on each mesh, in f32 and in the script's
    bf16 mix (its history and logits)."""
    from tangram_tpu_torch import north_star as ns

    def run_main(mesh):
        _, lines = printed(lambda: ns.main(["--tiny", "--device", "cpu", "--mesh", mesh]))
        return dict(lines=lines)

    def fit(mesh, low):
        args = ns.parse_args(["--tiny", "--device", "cpu", "--mesh", mesh] + low)
        args.epochs = NORTH_STAR_EPOCHS
        S, G, d = ns.make_problem(args)
        M0 = torch.from_numpy(north_star_start(args))
        M, hist = ns.train(M0, ns.mapper_data(S, G, d, "cpu"), args,
                           ns.world_mesh(args, torch.device("cpu")))
        return dict(M=M.float().numpy(), hist={k: v.numpy() for k, v in hist.items()})

    jobs = []
    for mesh in ("1d", "2d"):
        jobs.append((f"main {mesh}", lambda mesh=mesh: run_main(mesh)))
        for name, low in NORTH_STAR_DTYPES.items():
            jobs.append((f"fit {mesh} {name}", lambda mesh=mesh, low=low: fit(mesh, low)))
    return jobs


def tutorial_jobs():
    """The atlas and sweep tutorials of ``tangram_tpu_torch.examples`` in
    a world of ``WORLD`` processes: what each rank printed (the sweep after
    seeding numpy's global stream with :data:`TUTORIAL_SEED`, which its
    ``random_state=0`` leaves unseeded)."""
    from tangram_tpu_torch.examples import tutorial_atlas_mesh as atlas
    from tangram_tpu_torch.examples import tutorial_fault_tolerant_sweep as sweep

    def atlas_job():
        return dict(lines=printed(lambda: atlas.main(quick=True, device="cpu"))[1])

    def sweep_job():
        np.random.seed(TUTORIAL_SEED)
        return dict(lines=printed(lambda: sweep.main(device="cpu"))[1])

    return [("atlas", atlas_job), ("sweep", sweep_job)]


TUTORIAL_SEED = 123

#: the north-star fits' epochs and dtype flags (the script's own: bf16
#: moments and contraction inputs)
NORTH_STAR_EPOCHS = 20
NORTH_STAR_DTYPES = {"f32": ["--moment-dtype", "float32", "--compute-dtype", "float32"],
                     "bf16": []}

#: the fuzzers' seeds and trial counts on the gloo ranks: seed 0's first
#: four path trials draw both meshes, constrained mode and chunked runs;
#: seed 5's first two tuner trials draw the ("trial", "cell") and
#: ("trial",) meshes (adaptive, then halving)
FUZZ_SEED, FUZZ_TRIALS = 0, 4
FUZZ_TUNER_SEED, FUZZ_TUNER_TRIALS = 5, 2


def fuzz_jobs(suite):
    """``tangram_tpu_torch.scripts.fuzz_paths`` (suite ``"fuzz_paths"``) or
    ``fuzz_tuner`` (``"fuzz_tuner"``) in a world of ``WORLD`` processes: its
    failures, what it printed, and the meshes it drew on (axis name to
    size)."""
    from tangram_tpu_torch.scripts import fuzz_paths, fuzz_tuner

    tool, seed, trials = {"fuzz_paths": (fuzz_paths, FUZZ_SEED, FUZZ_TRIALS),
                          "fuzz_tuner": (fuzz_tuner, FUZZ_TUNER_SEED,
                                         FUZZ_TUNER_TRIALS)}[suite]

    def job():
        fails, lines = printed(lambda: tool.run(seed, trials, device="cpu"))
        meshes = {name: dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
                  for name, mesh in tool.trial_meshes(torch.device("cpu")).items()}
        return dict(fails=fails, lines=lines, meshes=meshes)

    return [("fuzz", job)]


def north_star_start(args):
    """One numpy N(0, 1) start of the north star's shape for both packages."""
    return np.random.default_rng(args.seed + 7).standard_normal(
        (args.cells, args.spots)).astype(np.float32)


def parallel_jobs(meshes, directory):
    """The fits of :data:`CASES` and the checks of
    ``tests/test_torch_parallel.py``."""
    jobs = [(name, lambda name=name: fit_case(name, meshes)) for name in CASES]
    perm = np.random.default_rng(1).permutation(CASES["generic adafactor"][0]["c"])
    return jobs + [
        ("generic adafactor permuted", lambda: fit_case("generic adafactor", meshes, perm)),
        ("resume", lambda: resume_case(meshes)),
        ("mapper val", lambda: mapper_val_case(meshes)),
        ("public api", lambda: public_api_case(meshes)),
        ("adjoint", lambda: adjoint_case(meshes)),
        ("checkpoint", lambda: checkpoint_case(meshes, directory)),
        ("shardings", lambda: shardings_case(meshes)),
        ("schedule", lambda: schedule_case(meshes)),
    ]


#: name → (problem, lambdas, options): the fits of suite ``"one"``, each
#: trained for :data:`ONE_EPOCHS` epochs by the single-device fused loop and
#: on a ``("cell",)`` mesh of one rank, which must store the same bits
ONE_CASES = {
    "f32 l1 l2 entropy": (dict(c=40, s=36), dict(NORMS, lambda_g2=0.5, lambda_r=0.01), {}),
    "constrained": (dict(c=40, s=36), dict(CONSTRAINED, lambda_g2=0.5, lambda_r=0.01),
                    dict(target=150.0)),
    "bf16 stochastic": (dict(c=40, s=36), dict(DENSITY, lambda_r=0.01),
                        dict(bf16=True, rounding="stochastic")),
}
ONE_EPOCHS = 10


def one_case(name, mesh):
    """Case ``name`` of :data:`ONE_CASES` by ``fit_mapping``'s fused loop
    and by ``fit_mapping_fused_sharded`` on ``mesh``, from the same start:
    the parameters, the moments and the history of each."""
    from tangram_tpu_torch import parallel as par
    from tangram_tpu_torch.models.mapper import fit_mapping
    from tangram_tpu_torch.ops.losses import LossWeights

    problem, lam, opts = ONE_CASES[name]
    p = make_problem(**problem)
    data = torch_data(p, opts)
    constrained = "target" in opts
    dtype = torch.bfloat16 if opts.get("bf16") else torch.float32
    low = dict(moment_dtype="bfloat16", rounding=opts["rounding"]) if opts.get("bf16") else {}

    def start():
        M0 = torch.from_numpy(p["M0"].copy()).to(dtype)
        return (M0, torch.from_numpy(p["F0"].copy())) if constrained else M0

    def arrays(params, moments, hist):
        params = params if constrained else (params,)
        return dict(params=[x.float().numpy() for x in params],
                    moments=[x.float().numpy() for x in moments],
                    hist={k: v.numpy() for k, v in hist.items()})

    lw = LossWeights(**lam)
    params, state, hist = fit_mapping(start(), data, lw, ONE_EPOCHS, 0.1, impl="fused",
                                      constrained=constrained, return_opt_state=True,
                                      param_dtype=str(dtype).removeprefix("torch."), **low)
    moments = (state[1] + state[2]) if constrained else state[1:]
    one = arrays(params, moments, hist)
    params, state, hist = par.fit_mapping_fused_sharded(
        start(), data, lw, ONE_EPOCHS, 0.1, mesh=mesh, return_opt_state=True, **low)
    keys = ("mu", "muF", "nu", "nuF") if constrained else ("mu", "nu")
    return dict(one=one, mesh=arrays(params, [state[k] for k in keys], hist))


def worker(rank, directory, suite="parallel", world=WORLD):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh

    from tangram_tpu_torch import parallel as par

    par.init_distributed("file://" + os.path.join(directory, "rendezvous"), world, rank,
                         backend="gloo")
    ranks = torch.arange(world)
    if suite == "one":
        meshes = {"1d": DeviceMesh("cpu", ranks, mesh_dim_names=("cell",))}
    else:
        meshes = {
            "1d": DeviceMesh("cpu", ranks, mesh_dim_names=("cell",)),
            "2d": par.make_mesh(2, 2),
            "slice": DeviceMesh("cpu", ranks.reshape(2, 2), mesh_dim_names=("slice", "cell")),
            "slice2d": DeviceMesh("cpu", ranks.reshape(2, 1, 2),
                                  mesh_dim_names=("slice", "cell", "spot")),
        }
    results = {}
    if suite == "one":
        jobs = [(name, lambda name=name: one_case(name, meshes["1d"])) for name in ONE_CASES]
    elif suite == "printing":
        jobs = printing_jobs(meshes)
    elif suite == "north_star":
        jobs = north_star_jobs()
    elif suite == "tutorials":
        jobs = tutorial_jobs()
    elif suite in ("fuzz_paths", "fuzz_tuner"):
        jobs = fuzz_jobs(suite)
    else:
        jobs = parallel_jobs(meshes, directory)
    for name, job in jobs:
        try:
            results[name] = job()
        except Exception:  # every rank reports; a collective that failed hangs no test
            results[name] = {"error": traceback.format_exc()}
            break
    with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    # a normal interpreter exit can abort in the teardown of the process
    # group's threads (about one run in six on the CPU)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run(directory, timeout=300.0, suite="parallel", world=WORLD):
    """Spawn ``world`` workers on ``suite`` (``"parallel"``, ``"printing"``,
    ``"north_star"``, ``"tutorials"``, ``"fuzz_paths"`` or ``"fuzz_tuner"``;
    ``"one"`` on a world of one) and return each rank's results; the
    workers are stopped after ``timeout`` seconds (a collective that one
    rank never reaches would wait for ever)."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(worker, args=(directory, suite, world), nprocs=world,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"the gloo workers did not finish in {timeout} s")
    out = []
    for rank in range(world):
        with open(os.path.join(directory, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
