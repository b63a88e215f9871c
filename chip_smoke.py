#!/usr/bin/env python3
"""Drive the PyTorch port's main mapping path once on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --phases device,build,kernels   # a subset
    python3 chip_smoke.py --profile        # also print a torch.profiler table

Phases (each prints its own lines; any failure exits non-zero before the
last line):

1. device     the card's name and power limit; TF32 off for matmul and cuDNN
2. build      nvcc builds tangram_tpu_torch/csrc/*.cu for sm_90a
3. kernels    each CUDA kernel against its plain PyTorch twin on seeded
              inputs at the tutorial shape (26,000 cells x 9,852 spots x 249
              genes), at its clusters-mode shape (22 x 9,852 x 249) and at a
              ragged small shape, with and without the entropy cotangent;
              median times from CUDA events
4. cells      synthetic tutorial pair -> pp_adatas -> map_cells_to_space
              (cells mode, 100 epochs) -> project_genes ->
              compare_spatial_geneexp, with the kernels' launch counts
5. clusters   map_cells_to_space in clusters mode (22 clusters), 100 epochs,
              and its steady step time
6. reference  10 epochs of the fused kernels against the materialized
              reference loop at the tutorial shape, and both step times

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``; the second is printed only when every
phase ran and passed. Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "cells", "clusters", "reference")
SHAPE = (26_000, 9_852, 249)      # the reference tutorial workload
CLUSTERS = (22, 9_852, 249)       # its clusters mode: 22 subclasses
RAGGED = (37, 53, 7)
EPOCHS = 100
SOURCE = "tangram_tpu_torch/csrc/mapper_kernels.cu"
REPLACES = {
    "rowstats": "tangram_tpu/ops/pallas_core.py:97",
    "project": "tangram_tpu/ops/pallas_core.py:159",
    "rbar": "tangram_tpu/ops/fused_step.py:386",
    "dm_adam": "tangram_tpu/ops/fused_step.py:307",
}
# kernel vs twin: max |kernel - twin| <= RTOL * max |twin|, per output.
# Both sides are IEEE f32; they differ only in summation order (the kernels
# reduce per thread, then across lanes; the twins through cuBLAS and
# PyTorch's reductions). Row stats sum 9,852 positive terms; the
# contractions sum 26,000 (project) or 250 (rbar, dm_adam) terms, so order
# alone moves the last ~4 bits of the largest values.
RTOL = {"rowstats": 1e-5, "project": 1e-4, "rbar": 1e-4, "dm_adam": 1e-4}
# fused kernels vs the reference loop over 10 epochs: the loss terms agree
# to LOSS_RTOL (the reference materializes P and sums in another order) and
# the logits to M_ATOL (Adam's normalized step is ~lr = 0.1 per epoch, so
# 1e-3 is 1% of one step after 10 of them), and the softmax maps to MAP_ATOL:
# a logit error e moves P = softmax(M) by at most about 2e·P, and P <= 1
LOSS_RTOL, M_ATOL, MAP_ATOL = 1e-4, 1e-3, 2e-3


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median ms of ``fn()`` over ``runs`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernels vs twins
# ---------------------------------------------------------------------------


def kernel_inputs(c, s, k, seed, dev):
    """Seeded inputs at the magnitudes of the main path: N(0, 1) logits,
    Poisson counts for A, the uniform cell weight, small cotangents and
    Adam moments a few steps in."""
    import torch

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    return dict(
        M=t(rng.standard_normal((c, s), dtype=np.float32)),
        A=t(rng.poisson(1.0, (c, k))),
        w=t(np.full(c, 1.0 / c)),
        dY=t(rng.standard_normal((s, k), dtype=np.float32) * 1e-4),
        dq=t(rng.standard_normal(s, dtype=np.float32)),
        dh=t(np.full(c, -0.05) + rng.standard_normal(c) * 1e-3),
        mu=t(rng.standard_normal((c, s), dtype=np.float32) * 1e-6),
        nu=t(rng.random((c, s), dtype=np.float32) * 1e-10),
    )


def rel_err(got, ref) -> tuple[float, float]:
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    return err, err / scale if scale else err


def compare_kernels(shape, dev, results, timed):
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs

    c, s, k = shape
    x = kernel_inputs(c, s, k, seed=11, dev=dev)
    M, A, w, dY, dq, dh = x["M"], x["A"], x["w"], x["dY"], x["dq"], x["dh"]
    scalars = fs.adam_scalars(3, 0.1)
    runs = 10

    def check(name, pairs, tag):
        worst_abs, worst_rel = 0.0, 0.0
        for what, got, ref in pairs:
            a, r = rel_err(got, ref)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
            say("kernels", f"{name} {tag} {what}: max_abs_err={a:.3e} "
                f"rel={r:.3e} (tol rel {RTOL[name]:.0e})")
            if not r <= RTOL[name]:
                fail(f"{name} {what} disagrees with its twin at {shape}: rel {r:.3e}")
        entry = results[name]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), worst_abs)

    # rowstats
    got, ref = cc._rowstats(M), cc._rowstats_plain(M)
    check("rowstats", zip("mlu", got, ref), f"{shape}")
    m, l, u = ref
    if timed:
        results["rowstats"]["ms"] = cuda_ms(lambda: cc._rowstats(M), runs)
        results["rowstats"]["plain_ms"] = cuda_ms(lambda: cc._rowstats_plain(M), runs)

    # project
    got, ref = cc._project(M, A, w, m, l), cc._project_plain(M, A, w, m, l)
    check("project", zip("Yq", got, ref), f"{shape}")
    if timed:
        results["project"]["ms"] = cuda_ms(lambda: cc._project(M, A, w, m, l), runs)
        results["project"]["plain_ms"] = cuda_ms(
            lambda: cc._project_plain(M, A, w, m, l), runs)

    for with_dh in (False, True):
        tag = f"{shape} with_dh={with_dh}"
        args = (M, A, w, m, l, dY, dq, dh)
        r_k = fs._rbar(*args, with_dh=with_dh)
        r_p = fs._rbar_plain(*args, with_dh=with_dh)
        check("rbar", [("r", r_k, r_p)], tag)

        Mk, muk, nuk = M.clone(), x["mu"].clone(), x["nu"].clone()
        Mp, mup, nup = M.clone(), x["mu"].clone(), x["nu"].clone()
        out_k = fs._dm_adam(Mk, A, w, m, l, dY, dq, dh, r_p, muk, nuk, scalars,
                            with_dh=with_dh)
        out_p = fs._dm_adam_plain(Mp, A, w, m, l, dY, dq, dh, r_p, mup, nup,
                                  scalars, with_dh=with_dh)
        check("dm_adam", zip(("M", "mu", "nu", "m'", "l'", "u'"), out_k, out_p), tag)
        if timed and not with_dh:
            results["rbar"]["ms"] = cuda_ms(lambda: fs._rbar(*args, with_dh=False), runs)
            results["rbar"]["plain_ms"] = cuda_ms(
                lambda: fs._rbar_plain(*args, with_dh=False), runs)
            results["dm_adam"]["ms"] = cuda_ms(lambda: fs._dm_adam(
                Mk, A, w, m, l, dY, dq, dh, r_p, muk, nuk, scalars, with_dh=False), runs)
            results["dm_adam"]["plain_ms"] = cuda_ms(lambda: fs._dm_adam_plain(
                Mp, A, w, m, l, dY, dq, dh, r_p, mup, nup, scalars, with_dh=False), runs)
        del Mk, muk, nuk, Mp, mup, nup, out_k, out_p
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------


def tutorial_pair():
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.datasets import synthetic_mapping_pair

    t0 = time.perf_counter()
    ad_sc, ad_sp = synthetic_mapping_pair(*SHAPE, random_state=0)
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp, time.perf_counter() - t0


def check_mapping(phase, ad_map, n_obs, n_spots, n_genes):
    X = np.asarray(ad_map.X)
    if X.shape != (n_obs, n_spots) or not np.isfinite(X).all():
        fail(f"{phase}: mapping has shape {X.shape} or non-finite values")
    row_err = float(np.abs(X.sum(axis=1, dtype=np.float64) - 1.0).max())
    if row_err > 1e-4:
        fail(f"{phase}: mapping rows sum to 1 only within {row_err:.2e}")
    hist = ad_map.uns["training_history"]
    main = np.asarray(hist["main_loss"])
    total = np.asarray(hist["total_loss"])
    if len(main) != EPOCHS or not (np.isfinite(main).all() and np.isfinite(total).all()):
        fail(f"{phase}: history has {len(main)} epochs or non-finite losses")
    if not main[-1] > main[0]:
        fail(f"{phase}: main_loss did not rise ({main[0]:.4f} -> {main[-1]:.4f})")
    df = ad_map.uns["train_genes_df"]
    if len(df) != n_genes or not np.isfinite(df["train_score"].to_numpy()).all():
        fail(f"{phase}: train_genes_df has {len(df)} rows or non-finite scores")
    say(phase, f"main_loss {main[0]:.4f} -> {main[-1]:.4f}; rows sum to 1 "
        f"within {row_err:.1e}; train_genes_df {len(df)} genes, median score "
        f"{float(df['train_score'].median()):.4f}")


def check_launches(phase, expect):
    from tangram_tpu_torch.ops.cuda_core import LAUNCHES

    counts = dict(LAUNCHES)
    say(phase, f"launch counts {counts} (expected {expect})")
    if counts != expect:
        fail(f"{phase}: the main path did not run through every kernel: {counts}")
    return counts


def mapper_for(ad_sc, ad_sp, dev, mode):
    """The Mapper that map_cells_to_space builds in ``mode`` with the
    rna_count_based prior (clusters by subclass_label)."""
    from tangram_tpu_torch.mapping import (
        _check_mapping_args, _densify, _resolve_density, _resolve_training_genes,
        adata_to_cluster_expression)
    from tangram_tpu_torch.models.mapper import Mapper

    label = "subclass_label" if mode == "clusters" else None
    lam = _check_mapping_args(mode, 1, 0, "rna_count_based", label, None, 1, 1)
    if mode == "clusters":
        ad_sc = adata_to_cluster_expression(ad_sc, label, True, add_density=True)
    genes = _resolve_training_genes(ad_sc, ad_sp, None)
    S = _densify(ad_sc[:, genes].X)
    G = _densify(ad_sp[:, genes].X)
    prior = _resolve_density(mode, "rna_count_based", lam, ad_sc, ad_sp)
    return Mapper(S, G, d=prior.d, d_source=prior.d_source,
                  lambda_d=prior.lambda_d, device=dev, random_state=0)


def step_ms(mapper, impl, warm, steps):
    """Steady-state ms per training step: ``warm`` steps untimed, then
    ``steps`` steps between two CUDA events."""
    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping

    M = mapper.M.clone()
    _, opt_state, _ = fit_mapping(M, mapper.data, mapper.lw, warm, impl=impl,
                                  return_opt_state=True)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fit_mapping(M, mapper.data, mapper.lw, steps, impl=impl, opt_state=opt_state)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / steps


def profile_steps(mapper, steps=5):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tangram_tpu_torch.models.mapper import fit_mapping

    M = mapper.M.clone()
    _, opt_state, _ = fit_mapping(M, mapper.data, mapper.lw, 2, impl="kernels",
                                  return_opt_state=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_mapping(M, mapper.data, mapper.lw, steps, impl="kernels",
                    opt_state=opt_state)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of 5 fused steps")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "tangram_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tangram_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    say("device", f"{kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say("device", f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    from tangram_tpu_torch.ops import cuda_core
    from tangram_tpu_torch.ops._build import load_kernels

    results = {name: {} for name in REPLACES}
    launches = None

    if "build" in phases:
        t0 = time.perf_counter()
        lib = load_kernels()
        say("build", f"{lib.path.name} in {lib.build_seconds:.1f} s of nvcc "
            f"({time.perf_counter() - t0:.1f} s with loading)")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("build", "ptxas " + line.strip().removeprefix("ptxas info    : "))

    if "kernels" in phases:
        for shape, timed in ((RAGGED, False), (CLUSTERS, False), (SHAPE, True)):
            t0 = time.perf_counter()
            compare_kernels(shape, dev, results, timed)
            say("kernels", f"{shape} checked in {time.perf_counter() - t0:.1f} s")
        for name, r in results.items():
            say("kernels", f"{name}: kernel {r['ms']:.3f} ms, twin "
                f"{r['plain_ms']:.3f} ms at {SHAPE} ({card})")

    if {"cells", "clusters", "reference"} & set(phases):
        ad_sc, ad_sp, secs = tutorial_pair()
        say("cells", f"synthetic pair {SHAPE} + pp_adatas in {secs:.1f} s")

    if "cells" in phases:
        import tangram_tpu_torch as tgt

        torch.cuda.synchronize()
        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(
            ad_sc, ad_sp, mode="cells", density_prior="rna_count_based",
            num_epochs=EPOCHS, random_state=0)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        launches = check_launches(
            "cells", {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS,
                      "dm_adam": EPOCHS})
        check_mapping("cells", ad_map, SHAPE[0], SHAPE[1], SHAPE[2])
        t0 = time.perf_counter()
        ad_ge = tgt.project_genes(ad_map, ad_sc)
        report = tgt.compare_spatial_geneexp(ad_ge, ad_sp, ad_sc)
        t_eval = time.perf_counter() - t0
        if ad_ge.X.shape != (SHAPE[1], SHAPE[2]) or not np.isfinite(report["score"]).all():
            fail("cells: project_genes / compare_spatial_geneexp output is wrong")
        say("cells", f"map_cells_to_space {t_map:.2f} s for {EPOCHS} epochs; "
            f"project_genes + compare_spatial_geneexp {t_eval:.2f} s; median "
            f"gene score {float(report['score'].median()):.4f}")

    if "clusters" in phases:
        import tangram_tpu_torch as tgt

        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(
            ad_sc, ad_sp, mode="clusters", cluster_label="subclass_label",
            num_epochs=EPOCHS, random_state=0)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        check_launches("clusters", {"rowstats": 1, "project": EPOCHS,
                                    "rbar": EPOCHS, "dm_adam": EPOCHS})
        n_clusters = ad_map.X.shape[0]
        check_mapping("clusters", ad_map, n_clusters, SHAPE[1], SHAPE[2])
        ms_c = step_ms(mapper_for(ad_sc, ad_sp, dev, "clusters"), "kernels",
                       warm=5, steps=50)
        say("clusters", f"{n_clusters} clusters, {EPOCHS} epochs in {t_map:.2f} s; "
            f"steady-state {ms_c:.3f} ms/step ({card})")

    if "reference" in phases:
        from tangram_tpu_torch.models.mapper import HISTORY_KEYS, fit_mapping

        mapper = mapper_for(ad_sc, ad_sp, dev, "cells")
        runs = {}
        for impl in ("kernels", "reference"):
            M = mapper.M.clone()
            M, hist = fit_mapping(M, mapper.data, mapper.lw, 10, impl=impl)
            runs[impl] = (M, {k: v.cpu().numpy() for k, v in hist.items()})
        (Mk, hk), (Mr, hr) = runs["kernels"], runs["reference"]
        for key in HISTORY_KEYS:
            a, b = hk[key], hr[key]
            if np.isnan(b).all() and np.isnan(a).all():
                continue
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            say("reference", f"{key}: max rel diff {rel:.2e} over 10 epochs "
                f"(tol {LOSS_RTOL:.0e})")
            if not rel <= LOSS_RTOL:
                fail(f"reference: {key} of the kernels and the reference loop differ")
        m_err = float((Mk - Mr).abs().max())
        p_err = float((torch.softmax(Mk, 1) - torch.softmax(Mr, 1)).abs().max())
        say("reference", f"logits max abs diff {m_err:.2e} (tol {M_ATOL:.0e}); "
            f"softmax maps max abs diff {p_err:.2e} (tol {MAP_ATOL:.0e})")
        if not (m_err <= M_ATOL and p_err <= MAP_ATOL):
            fail("reference: the kernels' and the reference loop's mappings differ")
        del Mk, Mr, runs
        ms_k = step_ms(mapper, "kernels", warm=5, steps=20)
        ms_r = step_ms(mapper, "reference", warm=2, steps=10)
        say("reference", f"steady-state ms/step at {SHAPE}: kernels {ms_k:.2f}, "
            f"reference loop {ms_r:.2f} ({card})")
        if args.profile:
            profile_steps(mapper)

    say("done", f"{time.perf_counter() - t_start:.1f} s in all")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": None if launches is None else launches[name],
         "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
         "plain_ms": r.get("plain_ms")}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    if list(phases) != list(PHASES):
        say("done", "partial run: the ok line is printed only when every phase runs")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
