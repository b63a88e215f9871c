#!/usr/bin/env python3
"""Drive the PyTorch port's mapping paths once on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --phases device,build,kernels   # a subset
    python3 chip_smoke.py --phases device,build,kernels --shapes ragged,clusters
    python3 chip_smoke.py --profile        # also a torch.profiler table and the
                                           # tensor-core kernels' phase shares

Phases (each prints its own lines; any failure exits non-zero before the
last line):

1. device     the card's name and power limit; TF32 off for matmul and cuDNN
2. build      nvcc builds tangram_tpu_torch/csrc/*.cu for sm_90a
3. kernels    each CUDA kernel against its plain PyTorch twin on seeded
              inputs at the tutorial shape (26,000 cells x 9,852 spots x 249
              genes), at its clusters-mode shape (22 x 9,852 x 249), at a
              ragged small shape with one padding sentinel in M and at a
              deep one (k = 300 > 256: A in two panels, dm_backward's output
              in two column panels; odd s: the bf16 element path), with and
              without the entropy cotangent and the L1/L2 terms (their λ
              scaled to each case's gradient, and each norm case shown to
              miss a twin with the norm gradient dropped or sign-flipped);
              one forward + backward of the kernels' MapperCore against
              autograd through the materialized core (tutorial shape, f32
              and a bf16 M, each with its launch counts);
              median times from CUDA events, each kernel's bound (the least
              time the card could take for its work; an f32 contraction
              at the faster of the FMA pipes and 3xTF32 on the tensor
              cores) and the cuBLAS f32 GEMM time at each contraction's
              shape (torch.logsumexp's beside the row stats); at every
              shape the f32-accuracy witness of the tensor-core kernels
              (rbar, dm_adam, gsq's vr and vc, dm_adafactor's M,
              dm_backward's dM, dA and dw; project's Y and q):
              against float64 twins the kernel errs at most 4x what the f32
              twin errs, and a twin with A and dY (P) rounded once to TF32
              misses it by more than 10x that; --shapes picks the
              shapes (ragged, clusters, tutorial). At the ragged and
              clusters shapes every buffer a kernel writes sits between two
              bands of sentinel words that must stay intact (out-of-bounds
              writes), and each kernel run three times on the same inputs
              must give the same bits (races: the kernels reduce in a fixed
              order, with no atomics). Then the bf16 variants of rows 1-9
              the same way (bf16 M, mu, nu, A and dY; the backward's with a
              bf16 M and f32 A and dY; the updates rounding to nearest and
              stochastically; stored values within 1 bf16 ulp of the
              twin's)
4. cells      synthetic tutorial pair -> pp_adatas -> map_cells_to_space
              (cells mode, Adam, 100 epochs) -> project_genes ->
              compare_spatial_geneexp, with the kernels' launch counts and
              the peak device memory
5. clusters   map_cells_to_space in clusters mode (22 clusters), 100 epochs,
              and its steady step time
6. adafactor  map_cells_to_space with optimizer="adafactor" and the L1/L2
              terms in cells mode, then Adafactor in clusters mode (the
              other orientation of its factored statistics), 100 epochs
              each, with launch counts; the Adafactor and Adam steady step
              times and peak device memory
7. constrained map_cells_to_space in constrained mode (target_count = one
              cell per spot), 100 epochs with Adam (the fused constrained
              step) and with Adafactor (autograd through MapperCore: the
              backward_rbar and dm_backward kernels), with launch counts,
              the filter F_out, steady step times and peak device memory
8. bf16       map_cells_to_space with bf16 logits, Adam moments and
              contraction inputs, 100 epochs each: (a) cells, Adam,
              stochastic rounding; (b) as (a) rounding to nearest; (c)
              constrained, Adam, stochastic; (d) cells, Adafactor + L1/L2,
              stochastic; each beside its f32 run from the same seed (that
              of phase 4, 7 or 6), with launch counts, rows summing to 1,
              final score, ms/step and peak device memory; then two 10-step
              runs from one start that must store the same bits, for f32
              Adam, f32 Adafactor + L1/L2, constrained Adam (M and F),
              constrained Adafactor (the autograd loop) and (a); and the
              f32 Adam and Adafactor + L1/L2 fits in a child process that
              makes the pair and the mapper anew from the same seeds
              (--fit-bits): the start, the data and both fits must hash
              the same
9. reference  10 epochs of the kernels against the materialized reference
              loop at the tutorial shape for Adam, Adam + L1/L2, Adafactor
              + L1/L2 (also stepped one epoch at a time, with one kernel
              step from the reference loop's own state at each, beside the
              reference loop started 1 ulp away and on permuted data),
              fused=False Adam (MapperCore), constrained Adam and
              constrained Adafactor, and the Adam step times
10. spatial   the five graph terms (the JAX bench's stack: neighborhood 0.5,
              cell-type islands, Getis-Ord, Moran and Geary 0.3 each, the
              islands by the pair's 22 subclasses): project, rbar and
              dm_adam at the islands width (A = [S | one-hot], k = 271:
              project on two column panels, the dP tile's A past its
              resident panel) against their twins and by the f32-accuracy
              witness, timed beside k = 249 with their bounds; the stack
              through map_cells_to_space (cells, Adam, 100 epochs) on dense
              and on k-NN spot graphs with launch counts, rows, a rising
              score and the peak memory; steady ms/step of the dense and
              k-NN stacks beside the plain step, each stack's graph terms
              finite; 10 epochs of the k-NN stack against the reference
              loop; two 10-step k-NN runs from one start stored bit for bit
              (M and every term); clusters mode (22) with the k-NN stack,
              launch counts and ms/step
11. cv        the 249-fold batched LOO (clusters, 1000 epochs) on the fixture
              of data/NB_REFERENCE_TORCH.json, each of its 25 recorded torch
              scores, their mean and the all-fold mean within 1e-3, seconds
              and peak memory; the loop path (fused kernels, launch counts)
              on two of its folds against the batched scores, and its
              seconds per fold extrapolated to 249; cells-mode 10-fold CV at
              the tutorial shape with fold_batch_size="auto" (peak per fold
              against the formula and the budget; ms/step per fold beside
              the fused step's); a cosine_lr vector on the fused Adam,
              Adafactor and constrained loops against chained one-epoch
              runs, bit for bit; early stopping against an unstopped run,
              and train_checkpointed cut and resumed against an unbroken
              run, bit for bit; init_method="auto" at 33,000 x 33,000
              drawn on the card
12. downstream the modules that consume the mapping, at the tutorial shape:
              (a) map_cells_to_space (cells, Adam, 100 epochs) inside
              profiling.record_phases, its phases and launch counts; (b)
              projected_expression on the card (one spot chunk and chunks
              of 4,096) and on the host against a float64 product, within
              4·sqrt(cells)·2^-24 of its largest entry, with a TF32 product
              of centered expression shown to err more than 10x what the
              f32 device product errs, and the side backend="auto" takes; (c) the deconvolution chain on a
              synthetic segmentation (Poisson(5) objects per spot), each step
              against numpy; (d) cell_sampling and svg; (e) plot_cell_annotation
              and plot_training_scores to an Agg canvas when matplotlib
              (seaborn) is installed; (f) profiling.benchmark_mapping on the
              card beside the steady step; host seconds of each
13. tuner     mapping_hyperparameter_tuning on the tutorial pair aggregated
              to its 22 subclass means (22 x 9,852 x 249, the port's
              6-neighbour spot graph): (a) the JAX bench's sobol sweep, 32
              trials x 3 repeats x 1000 epochs in one batch, a warm call
              and a timed one (seconds, trials/s, peak memory), and the
              population trainer's ms/step; (b) one config's repeat cube:
              the device metrics against the float64 host functions; (c)
              the population trainer against fit_mapping(impl="reference")
              from each repeat's init, 100 epochs, plain and with the
              neighborhood, islands and Getis-Ord terms; (d) a config alone
              against its row in the batch; (e) the three graph lambdas in
              the space, ms/step and the dense s x s products' share of the
              device time (torch.profiler); (f) adaptive, halving (carried
              state, then rungs restarted under a forced-down budget) and
              adaptive+halving; (g) a sobol and an adaptive sweep resumed
              from a journal cut to its first batch, frames equal; (h) the
              sweep of (a) twice, the same bits; (i) no kernel launched
14. mesh      training over a mesh of processes (tangram_tpu_torch.
              parallel): (a) a world of one NCCL rank at the tutorial
              shape: Mapper(mesh=make_mesh(1, 1)).train and
              fit_mapping_fused_sharded on a ("cell",) mesh with L1/L2,
              100 epochs each, the same bits as the single-device fused
              loop, with launch counts (rowstats or rowstats_norms 1,
              project, rbar, dm_adam 100), ms/step beside one device's
              (CUDA events around each step) and peak memory; (d) in the
              same world: the batched LOO of phase cv (100 epochs, every
              fold in one batch) on a ("fold", "cell") mesh of 1 x 1 and
              an 8-trial sobol tuner sweep (100 epochs) on the tuner
              phase's pair on a ("trial",) mesh of 1, each the same bits
              as without a mesh, ms/step of both from CUDA events around
              the trainer; (c) 10 steps of fit_mapping(fused=False) Adam on
              a bf16 M (optax's update in bf16) beside f32, scores within
              3e-2, ms/step, the bf16 kernels' launches; (b) two gloo ranks
              time-sharing the card (GLOO_TAKES_CUDA), 10 steps on a
              ("cell",) mesh of 2 and a ("cell", "spot") mesh of 1 x 2,
              within M_ATOL of one device, ms/step; (e) two gloo ranks:
              the LOO of (d) on ("fold",) = 2 (248 folds split, one
              whole) and the tuner of (d) on ("trial",) = 2 against (d)'s
              single-device runs (1e-5 per fold, 2e-3 per metric), the
              cells-mode 10-fold CV at the tutorial shape on ("fold",
              "cell") = 1 x 2 (batches of 2, 5 epochs) against one device
              (1e-5) with each rank's peak memory beside one device's;
              both ranks the same results, each trainer handed the folds,
              trials and cells the layout gives it

The last three lines are a JSON object with every kernel's numbers, the
card's name and power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``; the last is printed only when every
phase ran and passed. Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "cells", "clusters", "adafactor", "constrained",
          "bf16", "reference", "spatial", "cv", "downstream", "tuner", "mesh")
SHAPE = (26_000, 9_852, 249)      # the reference tutorial workload
CLUSTERS = (22, 9_852, 249)       # its clusters mode: 22 subclasses
RAGGED = (37, 53, 7)
DEEP = (150, 301, 300)            # k > 256 and an odd s
KERNEL_SHAPES = {"ragged": RAGGED, "deep": DEEP, "clusters": CLUSTERS, "tutorial": SHAPE}
EPOCHS = 100
SOURCE = "tangram_tpu_torch/csrc/mapper_kernels.cu"
# the kernels of the tensor-core dP tile have their own source
TENSOR_SOURCE = "tangram_tpu_torch/csrc/dp_tensor_kernels.cu"
TENSOR_KERNELS = ("rbar", "dm_adam", "backward_rbar", "gsq", "dm_adafactor", "dm_backward",
                  "rbar.bf16", "dm_adam.bf16", "gsq.bf16", "dm_adafactor.bf16",
                  "backward_rbar.bf16", "dm_backward.bf16")
# and so has the projection on the tensor cores
PROJECT_SOURCE = "tangram_tpu_torch/csrc/project_tc_kernels.cu"
PROJECT_KERNELS = ("project", "project.bf16")
REPLACES = {
    "rowstats": "tangram_tpu/ops/pallas_core.py:97",
    "project": "tangram_tpu/ops/pallas_core.py:159",
    "rbar": "tangram_tpu/ops/fused_step.py:386",
    "dm_adam": "tangram_tpu/ops/fused_step.py:307",
    "rowstats_norms": "tangram_tpu/ops/fused_step.py:105",
    "backward_rbar": "tangram_tpu/ops/pallas_core.py:303",
    "dm_backward": "tangram_tpu/ops/pallas_core.py:314",
    "gsq": "tangram_tpu/ops/fused_step.py:470",
    "dm_adafactor": "tangram_tpu/ops/fused_step.py:574",
}
# the bf16 variants (bf16 M, and mu, nu, A or dY where the kernel takes
# them; the updates also with stochastic rounding; the backward's with f32
# A and dY, as MapperCore hands them): the same TPU functions, on their
# bf16 branches
BF16_KERNELS = ("rowstats", "project", "rbar", "dm_adam", "rowstats_norms", "gsq",
                "dm_adafactor", "backward_rbar", "dm_backward")
REPLACES.update({f"{name}.bf16": REPLACES[name] for name in BF16_KERNELS})
# the kernels that the Adafactor + L1/L2 run carries, and those that the
# constrained Adafactor run carries (their launch counts come from those
# runs; the others' from the Adam cells run)
ADAFACTOR_KERNELS = ("rowstats_norms", "gsq", "dm_adafactor")
BACKWARD_KERNELS = ("backward_rbar", "dm_backward")
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# HBM bytes/s, f32 FMA-pipe flop/s outside the tensor cores, and the tensor
# cores' TF32 and bf16 flop/s (f32 accumulation). A kernel's bound is the
# largest of its bytes over the first and its flops of each type over that
# type's rate (the pipes run side by side). An f32 contraction may run on
# either pipe at f32 accuracy: as FMAs, or as three TF32 products of split
# operands (3xTF32) on the tensor cores; its time is the smaller of the two,
# whatever the kernel does.
HBM_BYTES_PER_S, F32_FLOPS_PER_S, BF16_FLOPS_PER_S = 3.35e12, 67e12, 989e12
TF32_FLOPS_PER_S, TF32_PASSES = 495e12, 3

# L1/L2 strengths of the adafactor phase and of the reference phase's
# L1/L2 runs; the adafactor phase prints how large their gradient is
# against the softmax gradient's at the start (0.10 of it at the tutorial
# shape). The kernel phase's norm cases take their own, scaled to each
# case's gradient (NORM_SHARE).
LAMBDA_L1, LAMBDA_L2 = 1e-10, 5e-11
# kernel phase: λ₁ = NORM_SHARE[0]·rms(g), λ₂ = NORM_SHARE[1]·rms(g), with g
# the softmax gradient of the case's inputs; for N(0, 1) logits the mean
# |λ₁·sign(M) + 2λ₂·M| is then 0.9·rms(g), so a kernel that dropped the
# norm gradient or flipped its sign is off by far more than RTOL (each norm
# case checks that against the twin run so)
NORM_SHARE = (0.5, 0.25)
PAD = -1e25  # a padding sentinel (below PAD_GUARD) planted at the small shape
# guard bands of the kernel phase's small shapes: GUARD words on each side of
# every buffer a kernel writes, holding a NaN payload no arithmetic produces
GUARD, GUARD_BITS = 4096, 0x7FA1DEAD
# kernel vs twin: max |kernel - twin| <= RTOL * max |twin|, per output.
# Both sides are IEEE f32; they differ only in summation order (the kernels
# reduce per thread, then across lanes; the twins through cuBLAS and
# PyTorch's reductions). Row stats sum 9,852 positive terms; the
# contractions sum 26,000 (project), 250 (the dP tile) or 9,852
# (dm_backward's dA and dw) terms, so order alone moves the last ~4 bits of
# the largest values. MapperCore's gradients are held to dm_backward's.
# The dP tile forms A dY^T (and dm_backward P [dY | dq]), and project
# P^T [A | w], on the tensor cores from TF32 parts of the f32 operands
# (3xTF32), which keeps f32 accuracy; F32_WITNESS holds them to it beside
# RTOL.
RTOL = {"rowstats": 1e-5, "project": 1e-4, "rbar": 1e-4, "dm_adam": 1e-4,
        "rowstats_norms": 1e-5, "backward_rbar": 1e-4, "dm_backward": 1e-4,
        "gsq": 1e-4, "dm_adafactor": 1e-4}
# the bf16 variants' f32 outputs, as their f32 kernels': they read the same
# bf16 values on both sides. Two exceptions. Y from a bf16 A takes P
# rounded to bf16; kernel and twin form P by one formula but not the same
# exp, so an entry of P a few f32 ulps from a bf16 rounding midpoint may
# round to the other neighbour: Y is held to Y_BF16_RTOL of max |twin|
# beyond the most such entries can move it (cc.project_rounding_slack).
# That limit is set from the gap measured on the H100 (3.4e-7 of max |Y|
# at the tutorial shape, 0 at the small ones; the f32 project's 2.0e-6),
# and a twin that leaves P in f32 must miss by more than it, so that the
# check sees the rounding. The next stats of an update come from the
# stored bf16 M (where a stored logit is one bf16 ulp apart, m moves by at
# most that ulp, l and u by as much of one term): 2**-7.
RTOL.update({f"{name}.bf16": RTOL[name] for name in BF16_KERNELS})
Y_BF16_RTOL, NEXT_STATS_BF16_RTOL = 2e-5, 2.0 ** -7
# The f32-accuracy witness of the tensor-core dP tile (rbar's r; dm_adam's
# M, mu, nu and next stats; gsq's vr and vc; dm_adafactor's stored M;
# dm_backward's dM, dA and dw; entropy cotangent off, the timed case),
# against a float64 twin of
# the same function on the same f32 inputs: the kernel's largest error is
# at most F32_WITNESS[0] times the f32 twin's largest error (both differ
# from float64 by f32 rounding and summation order only), and a twin whose
# A and dY (and for dm_backward's second product P and [dY | dq]) are
# rounded once to TF32, the fault a single tensor-core pass would be,
# misses the kernel by more than F32_WITNESS[1] times that margin on r, mu,
# Adafactor's M and dM, dA, dw (where the products enter linearly; a CPU
# estimate at the tutorial depth on 1,000 cells put that miss at 15-34
# times the threshold) and on gsq's vr and vc with dq = 0 (where g comes
# from the product alone), so the check can see the fault it exists for.
# project's Y and q (a sum over all c cells) are held the same way against a float64 projection, beside
# a twin whose P was rounded once to TF32: on the kernel phase's counts plus
# a fraction (every term >= 0, where a truncated running sum on the tensor
# cores would show as a one-sided bias) for accuracy alone, since at 26,000
# cells one TF32 rounding of P averages out to about the error of an f32 sum
# itself; and on the same operands made signed (A centred per column, w of
# random sign), where it does not, for accuracy and for the rounded twin.
F32_WITNESS = (4.0, 10.0)
WITNESS_PARTS = ("adam", "adafactor", "gsq", "project")
# bf16 stores of the updates: every stored value within BF16_ULPS of the
# twin's beyond what the f32 kernel's tolerance allows (RTOL of the largest
# value; it matters where the update cancels, as mu near 0), and at most
# BF16_SHARE of them apart (or one value). Both round the same f32 value,
# up to summation order, to nearest or with the same random bits (the keys
# depend on no tiling), so they part only where that order moves the f32
# value across a rounding boundary.
BF16_ULPS, BF16_SHARE = 1.0, 1e-3
# fused kernels vs the reference loop over 10 epochs: the loss terms agree
# to LOSS_RTOL (the reference materializes P and sums in another order) and
# the logits to M_ATOL (Adam's normalized step is ~lr = 0.1 per epoch, so
# 1e-3 is 1% of one step after 10 of them), and the softmax maps to MAP_ATOL:
# a logit error e moves P = softmax(M) by at most about 2e·P, and P <= 1
LOSS_RTOL, M_ATOL, MAP_ATOL = 1e-4, 1e-3, 2e-3
# The L1 gradient jumps by 2 lambda_l1 where a logit crosses 0, so a logit
# near 0 that the two runs round to opposite signs takes a different Adam
# step: with L1 on, up to KINK_FRACTION of the logits may differ by more
# than M_ATOL, and only within KINK_REACH of 0 (10 steps of about lr from a
# crossing). Measured on the H100 at the tutorial shape: 8 of 2.56e8 logits
# beyond 1e-3, the largest 3.0e-3 at a logit of -0.045.
KINK_FRACTION, KINK_REACH = 1e-6, 1.0
# The Moran and Geary similarities of the graph terms divide by each gene's
# spread of predicted expression over the spots, which is small while P is
# near uniform (the first epochs), so rounding in Y reaches the logits
# amplified: after 10 epochs of the k-NN stack the reference loop run on
# its cells in another order (only the order of its sums over cells
# changes) lands up to 6.4e-4 from itself, the kernels' twins 4.7e-4 and
# the reference from logits 1 ulp away 1.0e-3 (measured on the CPU at 3,000
# x 1,500 x 249; the plain Adam loss gives 9e-6, the Moran or Geary term
# alone 2e-4 and 1e-3). So with the graph terms the logits are held to
# GRAPH_SPREAD times that permuted reference's distance from the reference
# (M_ATOL where that is larger), beside MAP_ATOL on the maps and LOSS_RTOL on
# every loss term. The cell-type-island penalty needs no rule: its
# max(., 0) is off on every entry here (a spot's binary neighbor sum
# outweighs its own type mass), the penalty is 0 on both sides.
GRAPH_SPREAD = 4.0
# Adafactor's update u = g rowf colf is linear in the gradient and, with
# no update clipping (the JAX package's configuration), moves a few logits
# by tens per step at the tutorial shape, where the factored second moment
# underestimates their own: a rounding difference on those grows until
# single rows differ. The reference loop does it to itself: started from
# logits 1 ulp away, it differs by 2e-3 to 4e-2 after two steps and 4e1
# to 1.9e2 after ten (measured on the H100 at the tutorial shape), as the
# kernels and the reference do (3e-2 to 6e-2, 1.1e2 to 1.8e2); and one
# kernel step from the reference loop's own state lands up to 0.3 from
# its step on a few logits from step 3 on. So, as the JAX package's own
# Adafactor tests do (tests/test_adafactor.py:177-191), the losses are
# held to rtol = atol = 5e-3 over ten steps, and the logits after step 1
# to M_ATOL in the max; then in 2-norm, where a few logits weigh little
# and a fault in the carry or the decay (in use from step 2 on), moving
# every update by a tenth or more, weighs a lot: one kernel step from the
# reference loop's own state (logits and carried statistics) within
# AF_STEP_RTOL of that step's norm over the first AF_FORCED_STEPS steps
# (measured at most 1.7e-4; it does not accumulate), and the free-running
# kernels within AF_NORM_RTOL of |M_ref - M_0| over the first
# AF_FREE_STEPS (at most 1.7e-5; by step 3 single logits have moved by up
# to 1.7, 2.7e-4 of the norm); after ten, the median to M_ATOL. A 10%
# error in one decay factor moves both by about 7e-3 and 3.6e-3 (a
# deliberately broken copy, CPU, small shape). The reference loop with its
# spots and genes permuted, which changes only its rounding, is printed
# beside the forced kernel step as the measure of what rounding does.
AF_LOSS_TOL, AF_NORM_RTOL, AF_STEP_RTOL = 5e-3, 1e-3, 2e-3
AF_FORCED_STEPS, AF_FREE_STEPS = 3, 2

# the bf16 phase: bf16 logits, Adam moments and contraction inputs, in four
# configurations (label, rounding, map_cells_to_space options, launches of
# the bf16 variants over EPOCHS), each beside its f32 run. (d) carries the
# adafactor phase's L1/L2 terms, so that the norm kernel's bf16 variant
# runs too. The final score is held a priori to the JAX package's bf16
# tolerance on main_loss (tests/test_fused_step.py:201-204): 3e-2.
BF16_STORAGE = dict(param_dtype="bfloat16", moment_dtype="bfloat16",
                    compute_dtype="bfloat16")
BF16_ADAM = {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS, "dm_adam": EPOCHS}
# map_cells_to_space options of the configurations that have an f32 run in
# the earlier phases and a bf16 run in the bf16 phase
CELLS = dict(mode="cells")
CONSTRAINED = dict(mode="constrained", target_count=SHAPE[1])
CELLS_ADAFACTOR_NORMS = dict(mode="cells", optimizer="adafactor", lambda_l1=LAMBDA_L1,
                             lambda_l2=LAMBDA_L2)
BF16_CONFIGS = (
    ("(a) cells, Adam, stochastic", "stochastic", CELLS, BF16_ADAM),
    ("(b) cells, Adam, nearest", "nearest", CELLS, BF16_ADAM),
    ("(c) constrained, Adam, stochastic", "stochastic", CONSTRAINED, BF16_ADAM),
    ("(d) cells, Adafactor + L1/L2, stochastic", "stochastic", CELLS_ADAFACTOR_NORMS,
     {"rowstats_norms": 1, "project": EPOCHS, "rbar": EPOCHS, "gsq": EPOCHS,
      "dm_adafactor": EPOCHS}),
)
BF16_SCORE_TOL = 3e-2
# the mapping runs' seed: truthy, since the reference seeds numpy only for
# a truthy random_state; with 0 each run draws its init from wherever the
# global stream stands. With one seed, the cells, adafactor and constrained
# phases' f32 runs start where the bf16 phase's runs do, and serve as their
# f32 baselines.
SEED = 1


def kernel_work(name, c, s, k):
    """(bytes, elementwise f32 flops, f32 contraction flops, bf16
    contraction flops) that kernel ``name`` must move and do at (c, s, k):
    each input read once and each output written once, and its contractions
    at 2 flops per multiply-add (the dP tile [A|w] [dY|dq]ᵀ, or project's
    Pᵀ [A|w], 2·c·s·(k+1); dm_backward adds P [dY | dq]). A ".bf16"
    variant, as the main path runs it (all three dtypes bf16), moves M, mu,
    nu, A and dY in 2 bytes; the A·dY (or bf16(P)ᵀA) part of its
    contraction has bf16 operands with f32 accumulation, the tensor cores'
    type, and only the rank-one w ⊗ dq (or wP) part, 2·c·s, stays f32, on
    the FMA pipes; the backward's (backward_rbar, dm_backward) take a bf16
    M and dM with f32 A and dY, so their products stay f32. The
    elementwise work per (cell, spot) entry (exp, the
    gradient, the optimizer update, rounding: 5-30 flops) is counted only
    where there is no contraction (the row stats); beside an f32
    contraction it adds little, and a bf16 variant's bytes outweigh it."""
    base, _, variant = name.partition(".")
    bf16 = variant == "bf16"
    e = 2 if bf16 else 4  # bytes per element of M, mu, nu and dM
    bf16_ops = bf16 and base not in BACKWARD_KERNELS
    eo = 2 if bf16_ops else 4  # of A and dY
    cs, K1 = c * s, k + 1
    # M, [A|w], [dY|dq], dh, m, l
    dp_in = e * cs + eo * (c * k + s * k) + 4 * (c + s + 3 * c)
    ops = (2 * cs, 0, 2 * cs * k) if bf16_ops else (0, 2 * cs * K1, 0)
    twice = tuple(2 * n for n in ops)
    work = {
        "rowstats": (e * cs + 12 * c, 4 * cs, 0, 0),
        "rowstats_norms": (e * cs + 20 * c, 7 * cs, 0, 0),
        "project": (e * cs + e * c * k + 4 * (c + 2 * c + s * K1), *ops),
        "rbar": (dp_in + 4 * c, *ops),
        "backward_rbar": (dp_in + 4 * c, *ops),
        # r; M/mu/nu read and written (M's read is in dp_in)
        "dm_adam": (dp_in + 5 * e * cs + 4 * (c + 3 * c), *ops),
        "gsq": (dp_in + 4 * (c + c + s), *ops),
        "dm_adafactor": (dp_in + e * cs + 4 * (c + c + s + 3 * c), *ops),
        "dm_backward": (dp_in + 4 * c + e * cs + 4 * c * K1, *twice),
    }
    return work[base]


def bound_ms(name, shape):
    """(the least ms the card could take for kernel ``name`` at ``shape``;
    "bytes" or "operations": which sets it; the pipe behind "operations").
    An f32 contraction counts at the faster of the FMA pipes and 3xTF32 on
    the tensor cores, whichever the kernel uses."""
    nbytes, f32_ops, f32_dot, bf16_dot = kernel_work(name, *shape)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops, pipe = max(
        (f32_ops / F32_FLOPS_PER_S, "f32 FMA"),
        min((f32_dot / F32_FLOPS_PER_S, "f32 FMA"),
            (TF32_PASSES * f32_dot / TF32_FLOPS_PER_S, "3xTF32 tensor cores")),
        (bf16_dot / BF16_FLOPS_PER_S, "bf16 tensor cores"))
    if t_bytes >= t_ops * 1e3:
        return t_bytes, "bytes", "HBM"
    return t_ops * 1e3, "operations", pipe


def dp_l2_bytes(c, s, k, sm_count, gsq=False):
    """Bytes the tensor-core dP tile (rbar, gsq, dm_adam, dm_adafactor) moves
    through L2 per launch for its operands, as its design reckons them:
    every block streams its spot tiles' dY rows whole (Kp f32 each), and
    copies its 64 resident A rows once (once per spot tile when K is deeper
    than one panel of 256); with ``gsq``, also its (2 ceil(c / 64), s) f32
    column partial, written once and read once by col_sum."""
    from tangram_tpu_torch.ops import cuda_core as cc

    Kp = -(-k // 32) * 32
    groups, nsplit = math.ceil(c / 64), cc.dp_splits(c, s, sm_count)
    a_loads = nsplit if Kp <= 256 else math.ceil(s / 128)
    partial = 2 * (2 * groups * s * 4) if gsq else 0
    return groups * (s * Kp * 4 + a_loads * 64 * Kp * 4) + partial


def project_l2_bytes(c, s, k):
    """Bytes the project kernel moves through L2 per launch for its X =
    [A | w] operand, as its design reckons them: every 64-spot tile reads
    every cell's row of X (k + 1 rounded up to 4 columns, f32) once."""
    return math.ceil(s / 64) * c * (-(-(k + 1) // 4) * 4) * 4


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


def kernel_inputs(c, s, k, seed, dev, pad=False):
    """Seeded inputs at the magnitudes of the main path: N(0, 1) logits
    (with one padding sentinel when ``pad``), Poisson counts for A, the
    uniform cell weight, small cotangents and Adam moments a few steps in."""
    import torch

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    M = rng.standard_normal((c, s), dtype=np.float32)
    if pad:
        M[0, 1] = PAD
    return dict(
        M=t(M),
        A=t(rng.poisson(1.0, (c, k))),
        w=t(np.full(c, 1.0 / c)),
        dY=t(rng.standard_normal((s, k), dtype=np.float32) * 1e-4),
        dq=t(rng.standard_normal(s, dtype=np.float32)),
        dh=t(np.full(c, -0.05) + rng.standard_normal(c) * 1e-3),
        mu=t(rng.standard_normal((c, s), dtype=np.float32) * 1e-6),
        nu=t(rng.random((c, s), dtype=np.float32) * 1e-10),
    )


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|); a padding sentinel does not
    set the scale, but its own error counts."""
    err = float((got - ref).abs().max())
    real = ref.abs() < 1e20
    scale = float(ref[real].abs().max()) if bool(real.any()) else 0.0
    return err, err / scale if scale else err


def check_f32_accuracy(shape, x, m, l, scalars, parts=WITNESS_PARTS, fraction_cols=None,
                       phase="kernels"):
    """The f32-accuracy witness of the tensor-core kernels (F32_WITNESS):
    rbar's r and dm_adam's M, mu, nu and next stats against float64 twins of
    the same functions on the same f32 inputs, beside the f32 twins and
    beside f32 twins whose A and dY were rounded once to TF32; then gsq's
    vr and vc (the rounded twin: gsq_tf32_plain's single pass; held to the
    margin with dq = 0), dm_adafactor's stored M and dm_backward's dM, dA
    and dw the same way
    (dm_backward's rounded twin also rounds P and [dY | dq] once in its
    second product); then project's Y and q, beside a twin whose P was
    rounded once. A takes a
    seeded fraction on top of the kernel phase's counts: small integers are
    exact in TF32 and would leave the rounded twin only dY's error to show
    (real expression matrices are normalized floats). nu is kept away from
    0 (half its scale added): where nu and the gradient both vanish, Adam's
    normalized step divides two roundings, a few entries in 2.6e8 move by
    1e-4 on either side, and the largest error says where those fell, not
    how accurate the product is. ``parts`` picks the witnesses (of
    WITNESS_PARTS: rbar and dm_adam; dm_adafactor, dm_backward and gsq;
    gsq with dq = 0; project); only A's first ``fraction_cols`` columns take
    the fraction when it is given (the rest, a one-hot encoding, stay
    exact)."""
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs

    M, A, w, dY, dq, dh = x["M"], x["A"], x["w"], x["dY"], x["dq"], x["dh"]
    gen = torch.Generator(device=A.device).manual_seed(17)
    fraction = torch.rand(A.shape, generator=gen, device=A.device)
    if fraction_cols is not None:
        fraction[:, fraction_cols:] = 0.0
    A = A + fraction
    A_t, dY_t = cc.tf32_split(A)[0], cc.tf32_split(dY)[0]
    r_p = cc._rbar_plain(M, A, w, m, l, dY, dq, dh, False)
    nu = x["nu"] + 0.5 * float(x["nu"].max())
    f32 = np.float32
    lr, bc1, bc2 = scalars
    b1, b2 = float(f32(fs.BETA1)), float(f32(fs.BETA2))
    omb1, omb2 = float(f32(1.0 - fs.BETA1)), float(f32(1.0 - fs.BETA2))
    inv_bc1, inv_bc2 = float(f32(1.0) / f32(bc1)), float(f32(1.0) / f32(bc2))
    eps = float(f32(fs.ADAM_EPS))

    bad = []

    def judge(name, err_k, err_p, miss, seen, rounded):
        margin = F32_WITNESS[0] * err_p
        say(phase, f"f32 accuracy {shape} {name}: against float64 the kernel errs by "
            f"{err_k:.3e}, the f32 twin by {err_p:.3e} (kernel must stay within "
            f"{F32_WITNESS[0]:.0f}x: {margin:.3e}); a twin with {rounded} rounded to TF32 "
            f"misses the kernel by {miss:.3e}"
            + (f" (must exceed {F32_WITNESS[1]:.0f}x the margin: "
               f"{F32_WITNESS[1] * margin:.3e})" if seen else ""))
        if not err_k <= margin:
            bad.append(f"{name}: the kernel is less accurate than f32")
        if seen and not miss > F32_WITNESS[1] * margin:
            bad.append(f"{name}: the check cannot see a single TF32 pass")

    if "adam" in parts:
        # the float64 twins: P, dP, r, then the Adam update and the next stats
        Md = M.double()
        P = torch.exp(Md - m.double()) / l.double()
        dP = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
        want = {"r": (P * dP).sum(dim=1, keepdim=True)}
        g = P * (dP - r_p.double())
        del P, dP
        mu64 = b1 * x["mu"].double() + omb1 * g
        nu64 = b2 * nu.double() + omb2 * (g * g)
        del g
        M64 = Md - lr * (mu64 * inv_bc1) / (torch.sqrt(nu64 * inv_bc2) + eps)
        del Md
        m64 = M64.amax(dim=1, keepdim=True)
        e = torch.exp(M64 - m64)
        want.update({"M": M64, "mu": mu64, "nu": nu64, "m'": m64,
                     "l'": e.sum(dim=1, keepdim=True),
                     "u'": (e * M64).sum(dim=1, keepdim=True)})
        del e

        def adam(run, A_in, dY_in):
            out = run(M.clone(), A_in, w, m, l, dY_in, dq, dh, r_p, x["mu"].clone(),
                      nu.clone(), scalars, False)
            return dict(zip(("M", "mu", "nu", "m'", "l'", "u'"), out))

        sides = {}
        for side, rbar, run, A_in, dY_in in (
                ("kernel", fs._rbar, fs._dm_adam, A, dY),
                ("f32 twin", cc._rbar_plain, fs._dm_adam_plain, A, dY),
                ("TF32 twin", cc._rbar_plain, fs._dm_adam_plain, A_t, dY_t)):
            sides[side] = dict(adam(run, A_in, dY_in),
                               r=rbar(M, A_in, w, m, l, dY_in, dq, dh, False))

        for name, ref in want.items():
            real = ref.abs() < 1e20  # a padding sentinel's own rounding aside
            err_k, err_p = (float((sides[side][name].double() - ref)[real].abs().max())
                            for side in ("kernel", "f32 twin"))
            miss = float((sides["TF32 twin"][name] - sides["kernel"][name])[real].abs().max())
            seen = name in ("r", "mu")
            judge(name, err_k, err_p, miss, seen, "A and dY")
        del want, sides

    if "adafactor" in parts:
        # dm_adafactor's stored M at the factors of the twin's own statistics,
        # and dm_backward's dM, dA, dw: the products enter each linearly
        c, s = M.shape
        vr, vc = fs._gsq_plain(M, A, w, m, l, dY, dq, dh, r_p, 0.0, 0.0, with_dh=False)
        _, _, rowf, colf = fs.factored_rms_vectors(
            0, torch.zeros_like(vr), torch.zeros_like(vc), vr, vc, c, s)
        Md = M.double()
        P = torch.exp(Md - m.double()) / l.double()
        dP = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
        g = P * (dP - r_p.double())
        del dP
        lr = float(f32(0.1))
        want = {"adafactor M": Md - lr * (g * rowf.double()[:, None] * colf.double()[None, :]),
                "dM": g, "dA": P @ dY.double(), "dw": P @ dq.double()}
        del Md, P
        g = g * g
        want.update({"gsq vr": g.sum(dim=1), "gsq vc": g.sum(dim=0)})
        del g
        back = (M, A, w, m, l, dY, dq, dh, r_p)
        gsq_args = (M, A, w, m, l, dY, dq, dh, r_p, 0.0, 0.0)
        sides = {}
        for side, adafactor, backward, gsq, A_in, dY_in in (
                ("kernel", fs._dm_adafactor, cc._dm_backward, fs._gsq, A, dY),
                ("f32 twin", fs._dm_adafactor_plain, cc._dm_backward_plain, fs._gsq_plain, A, dY),
                ("TF32 twin", fs._dm_adafactor_plain,
                 lambda *a, with_dh: cc.dm_backward_tf32_plain(*a, with_dh=with_dh, terms=1),
                 lambda *a, with_dh: fs.gsq_tf32_plain(*a, with_dh=with_dh, terms=1),
                 A_t, dY_t)):
            out = adafactor(M.clone(), A_in, w, m, l, dY_in, dq, dh, r_p, rowf, colf, 0.1,
                            0.0, 0.0, False, with_dh=False)
            sides[side] = dict(zip(("dM", "dA", "dw"), backward(*back, with_dh=False)),
                               **{"adafactor M": out[0]},
                               **dict(zip(("gsq vr", "gsq vc"), gsq(*gsq_args, with_dh=False))))
        for name, ref in want.items():
            real = ref.abs() < 1e20
            err_k, err_p = (float((sides[side][name].double() - ref)[real].abs().max())
                            for side in ("kernel", "f32 twin"))
            miss = float((sides["TF32 twin"][name] - sides["kernel"][name])[real].abs().max())
            judge(name, err_k, err_p, miss, not name.startswith("gsq"),
                  "A and dY" if name in ("adafactor M", "gsq vr", "gsq vc")
                  else "A, dY, P and [dY | dq]")
        del want, sides

    if "gsq" in parts:
        # gsq again with dq = 0, g from the product alone. w (x) dq is added
        # exactly on every side; where it outweighs A dY^T (w = 1/c: 18 times
        # at c = 22) a single TF32 pass moves g too little for the rounded twin
        # to show on vr (measured on the H100 at the clusters shape: 0.73 of
        # the margin), so the rounded twin is held to the margin here
        dq0 = torch.zeros_like(dq)
        r0 = cc._rbar_plain(M, A, w, m, l, dY, dq0, dh, False)
        P = torch.exp(M.double() - m.double()) / l.double()
        g = (P * (A.double() @ dY.double().T - r0.double())) ** 2
        del P
        want = {"gsq vr (dq = 0)": g.sum(dim=1), "gsq vc (dq = 0)": g.sum(dim=0)}
        del g
        gsq_args = (M, A, w, m, l, dY, dq0, dh, r0, 0.0, 0.0)
        sides = {side: gsq(*gsq_args, with_dh=False) for side, gsq in (
            ("kernel", fs._gsq), ("f32 twin", fs._gsq_plain),
            ("TF32 twin", lambda *a, with_dh: fs.gsq_tf32_plain(*a, with_dh=with_dh, terms=1)))}
        for i, (name, ref) in enumerate(want.items()):
            err_k, err_p = (float((sides[side][i].double() - ref).abs().max())
                            for side in ("kernel", "f32 twin"))
            miss = float((sides["TF32 twin"][i] - sides["kernel"][i]).abs().max())
            judge(name, err_k, err_p, miss, True, "A and dY")
        del want, sides

    if "project" in parts:
        # project: Y and q against a float64 projection (F32_WITNESS's note)
        c = M.shape[0]
        P64 = torch.exp(M.double() - m.double()) / l.double()
        P_t = cc.tf32_split(torch.exp(M - m) * (1.0 / l))[0]
        sign = torch.where(torch.rand(c, generator=gen, device=A.device) < 0.5, -1.0, 1.0)
        for data, A_in, w_in, seen in (("counts", A, w, False),
                                       ("signed", A - A.mean(dim=0), w * sign, True)):
            want = dict(zip("Yq", (P64.T @ A_in.double(), w_in.double() @ P64)))
            sides = {"kernel": cc._project(M, A_in, w_in, m, l),
                     "f32 twin": cc._project_plain(M, A_in, w_in, m, l),
                     "TF32 twin": (P_t.T @ A_in, w_in @ P_t)}
            for i, name in enumerate("Yq"):
                err_k, err_p = (float((sides[side][i].double() - want[name]).abs().max())
                                for side in ("kernel", "f32 twin"))
                miss = float((sides["TF32 twin"][i] - sides["kernel"][i]).abs().max())
                judge(f"project {name} ({data})", err_k, err_p, miss, seen, "P")
            del want, sides
    if bad:
        fail(f"f32-accuracy witness at {shape}: " + "; ".join(bad))


def compare_kernels(shape, dev, results, timed):
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs

    c, s, k = shape
    x = kernel_inputs(c, s, k, seed=11, dev=dev, pad=shape == RAGGED)
    M, A, w, dY, dq, dh = x["M"], x["A"], x["w"], x["dY"], x["dq"], x["dh"]
    M_host = M.cpu()  # every kernel and twin below leaves M as it is
    scalars = fs.adam_scalars(3, 0.1)
    runs = 10

    def check(name, pairs, tag):
        pairs = list(pairs)
        worst_abs, worst_rel = 0.0, 0.0
        for what, got, ref in pairs:
            a, r = rel_err(got, ref)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
            say("kernels", f"{name} {tag} {what}: max_abs_err={a:.3e} "
                f"rel={r:.3e} (tol rel {RTOL[name]:.0e})")
            if not r <= RTOL[name]:
                at = int((got - ref).abs().argmax())
                fail(f"{name} {what} disagrees with its twin at {shape}: rel {r:.3e}; "
                     f"at flat index {at} kernel {float(got.flatten()[at]):.6g}, twin "
                     f"{float(ref.flatten()[at]):.6g}; max |twin| at flat index "
                     f"{int(ref.abs().argmax())}; M intact: "
                     f"{torch.equal(M.cpu(), M_host)}")
        entry = results[name]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), worst_abs)
        return [got for _, got, _ in pairs]

    def check_catches(name, got, wrong_twin, lam, tag):
        """Fail unless the kernel's outputs ``got`` (run at ``lam``) miss,
        by more than RTOL on some output, the twin run with the norm
        gradient dropped (λ = 0) and with its sign flipped (-λ): the case
        can see either fault. ``wrong_twin(l1, l2)`` returns the twin's
        outputs at those λ."""
        for fault, lam_w in (("dropped", (0.0, 0.0)),
                             ("sign-flipped", (-lam[0], -lam[1]))):
            miss = max(rel_err(g, ref)[1] for g, ref in zip(got, wrong_twin(*lam_w)))
            say("kernels", f"{name} {tag}: against a twin with the norm gradient "
                f"{fault}, rel {miss:.3e} (must exceed {RTOL[name]:.0e})")
            if not miss > RTOL[name]:
                fail(f"{name} norm case at {shape} cannot see a {fault} norm gradient")

    def time_pair(name, kernel, twin):
        results[name]["ms"] = cuda_ms(kernel, runs)
        results[name]["plain_ms"] = cuda_ms(twin, runs)

    # rowstats, with and without the L1/L2 norms
    tag = f"{shape} ({cc.rowstats_load_bytes(M)}-byte loads)"
    got, ref = cc._rowstats(M), cc._rowstats_plain(M)
    check("rowstats", zip("mlu", got, ref), tag)
    m, l, u = ref
    got, ref = fs._rowstats_norms(M), fs._rowstats_norms_plain(M)
    check("rowstats_norms", zip(("m", "l", "u", "s1", "s2"), got, ref), tag)
    if timed:
        time_pair("rowstats", lambda: cc._rowstats(M), lambda: cc._rowstats_plain(M))
        time_pair("rowstats_norms", lambda: fs._rowstats_norms(M),
                  lambda: fs._rowstats_norms_plain(M))
        logsumexp_note(M, runs)

    # project
    got, ref = cc._project(M, A, w, m, l), cc._project_plain(M, A, w, m, l)
    check("project", zip("Yq", got, ref), f"{shape}")
    if timed:
        time_pair("project", lambda: cc._project(M, A, w, m, l),
                  lambda: cc._project_plain(M, A, w, m, l))

    # the operands of the tensor-core dP tile, built once as a fused step
    # builds them (its A operand once per fit); the checks below let the
    # wrappers build their own, the timed calls take these
    ops = cc.dp_operands(A, dY)
    bops = cc.backward_operands(A, dY, dq)  # the unfused backward's, once per backward
    if timed:
        say("kernels", f"dP-tile operands at {shape}: A's {cuda_ms(lambda: cc.dp_operand(A), runs):.3f} "
            f"ms (once per unconstrained fit), dY's "
            f"{cuda_ms(lambda: cc.dp_operand(dY), runs):.3f} ms (once per step); "
            f"{(ops.A_op.numel() + ops.dY_op.numel()) * 4 / 2**30:.3f} GiB; the "
            f"backward's A and [dY | dq] "
            f"{cuda_ms(lambda: cc.backward_operands(A, dY, dq), runs):.3f} ms (once per "
            f"backward)")
    for with_dh in (False, True):
        tag = f"{shape} with_dh={with_dh}"
        args = (M, A, w, m, l, dY, dq, dh)
        r_k = fs._rbar(*args, with_dh=with_dh)
        r_p = cc._rbar_plain(*args, with_dh=with_dh)
        check("rbar", [("r", r_k, r_p)], tag)
        if timed and not with_dh:
            # as the fused steps call it: the step's operands built once
            time_pair("rbar", lambda: fs._rbar(*args, with_dh=False, operands=ops),
                      lambda: cc._rbar_plain(*args, with_dh=False))

        # the norm cases' λ, scaled to this case's softmax gradient
        vr0, _ = fs._gsq_plain(*args, r_p, 0.0, 0.0, with_dh=with_dh)
        g_rms = float((vr0.sum() / (c * s)).sqrt())
        lam = (NORM_SHARE[0] * g_rms, NORM_SHARE[1] * g_rms)
        say("kernels", f"{tag}: softmax gradient rms {g_rms:.3e}; norm cases at "
            f"lambda_l1={lam[0]:.3e}, lambda_l2={lam[1]:.3e}")
        del vr0

        # dm_adam without and with the L1/L2 terms
        norms = dict(lam_l1=lam[0], lam_l2=lam[1], with_norms=True)
        for kw, names in (({}, ("M", "mu", "nu", "m'", "l'", "u'")),
                          (norms, ("M", "mu", "nu", "m'", "l'", "u'", "s1'", "s2'"))):
            Mk, muk, nuk = M.clone(), x["mu"].clone(), x["nu"].clone()
            Mp, mup, nup = M.clone(), x["mu"].clone(), x["nu"].clone()
            out_k = fs._dm_adam(Mk, A, w, m, l, dY, dq, dh, r_p, muk, nuk, scalars,
                                with_dh=with_dh, **kw)
            out_p = fs._dm_adam_plain(Mp, A, w, m, l, dY, dq, dh, r_p, mup, nup,
                                      scalars, with_dh, **kw)
            got = check("dm_adam", zip(names, out_k, out_p), tag + (" norms" if kw else ""))
            if kw:
                check_catches("dm_adam", got[:3], lambda l1, l2: fs._dm_adam_plain(
                    M.clone(), A, w, m, l, dY, dq, dh, r_p, x["mu"].clone(),
                    x["nu"].clone(), scalars, with_dh, l1, l2, True)[:3], lam,
                    tag + " norms")
            if timed and not with_dh:
                kernel = lambda: fs._dm_adam(  # noqa: E731
                    Mk, A, w, m, l, dY, dq, dh, r_p, muk, nuk, scalars,
                    with_dh=False, operands=ops, **kw)
                twin = lambda: fs._dm_adam_plain(  # noqa: E731
                    Mp, A, w, m, l, dY, dq, dh, r_p, mup, nup, scalars, False, **kw)
                if kw:
                    say("kernels", f"dm_adam with L1/L2: kernel {cuda_ms(kernel, runs):.3f} "
                        f"ms, twin {cuda_ms(twin, runs):.3f} ms at {shape}")
                else:
                    time_pair("dm_adam", kernel, twin)
            del Mk, muk, nuk, Mp, mup, nup, out_k, out_p

        # gsq and dm_adafactor without and with the L1/L2 terms, at the
        # factors of the twin's own statistics (count 0)
        for lam_c in ((0.0, 0.0), lam):
            with_norms = lam_c != (0.0, 0.0)
            ntag = tag + (" norms" if with_norms else "")
            vr_k, vc_k = fs._gsq(*args, r_p, *lam_c, with_dh=with_dh)
            vr_p, vc_p = fs._gsq_plain(*args, r_p, *lam_c, with_dh=with_dh)
            check("gsq", [("vr", vr_k, vr_p), ("vc", vc_k, vc_p)], ntag)
            if with_norms:
                check_catches("gsq", (vr_k, vc_k), lambda l1, l2: fs._gsq_plain(
                    *args, r_p, l1, l2, with_dh=with_dh), lam, ntag)
            _, _, rowf, colf = fs.factored_rms_vectors(
                0, torch.zeros_like(vr_p), torch.zeros_like(vc_p), vr_p, vc_p, c, s)
            Mk, Mp = M.clone(), M.clone()
            out_k = fs._dm_adafactor(Mk, A, w, m, l, dY, dq, dh, r_p, rowf, colf, 0.1,
                                     *lam_c, with_norms=with_norms, with_dh=with_dh)
            out_p = fs._dm_adafactor_plain(Mp, A, w, m, l, dY, dq, dh, r_p, rowf,
                                           colf, 0.1, *lam_c, with_norms, with_dh)
            names = ("M", "m'", "l'", "u'", "s1'", "s2'")[:len(out_p)]
            got = check("dm_adafactor", zip(names, out_k, out_p), ntag)
            if with_norms:
                check_catches("dm_adafactor", got[:1], lambda l1, l2: fs._dm_adafactor_plain(
                    M.clone(), A, w, m, l, dY, dq, dh, r_p, rowf, colf, 0.1, l1, l2,
                    True, with_dh)[:1], lam, ntag)
            if timed and not with_dh and with_norms:  # the adafactor phase's case
                # as the fused step calls them: the step's operands built once
                time_pair("gsq", lambda: fs._gsq(*args, r_p, *lam, with_dh=False,
                                                 operands=ops),
                          lambda: fs._gsq_plain(*args, r_p, *lam, with_dh=False))
                time_pair("dm_adafactor", lambda: fs._dm_adafactor(
                    Mk, A, w, m, l, dY, dq, dh, r_p, rowf, colf, 0.1, *lam,
                    with_norms=True, with_dh=False, operands=ops),
                    lambda: fs._dm_adafactor_plain(
                    Mp, A, w, m, l, dY, dq, dh, r_p, rowf, colf, 0.1, *lam, True,
                    False))
            del Mk, Mp, out_k, out_p

        # the unfused backward: its rbar pass (always with the entropy
        # cotangent, as pallas_core._backward), then dM, dA, dw; timed as
        # _backward calls them, on the backward's operands built once
        if with_dh:
            r_k = cc._rbar(*args, with_dh=True, counter="backward_rbar")
            check("backward_rbar", [("r", r_k, r_p)], tag)
            if timed:
                time_pair("backward_rbar",
                          lambda: cc._rbar(*args, with_dh=True, counter="backward_rbar",
                                           operands=bops),
                          lambda: cc._rbar_plain(*args, with_dh=True))
        out_k = cc._dm_backward(*args, r_p, with_dh=with_dh)
        out_p = cc._dm_backward_plain(*args, r_p, with_dh=with_dh)
        check("dm_backward", zip(("dM", "dA", "dw"), out_k, out_p), tag)
        del out_k, out_p
        if timed and with_dh:  # the constrained path's case (dh from λ_r·Σh)
            time_pair("dm_backward",
                      lambda: cc._dm_backward(*args, r_p, with_dh=True, operands=bops),
                      lambda: cc._dm_backward_plain(*args, r_p, with_dh=True))

    del bops
    check_f32_accuracy(shape, x, m, l, scalars)
    if shape == SHAPE:
        check_mapper_core(x, results)
    if timed:
        time_gemms(x)
    torch.cuda.synchronize()
    if not torch.equal(M.cpu(), M_host):
        fail(f"a kernel or twin at {shape} wrote into its input M")


def bf16_ulp(ref):
    """The bf16 spacing at each value of ``ref`` (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(ref.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def compare_bf16_kernels(shape, dev, results, timed):
    """The bf16 variants of rows 1-9 against their twins on the same bf16
    inputs: rowstats and rowstats_norms of a bf16 M; project with a bf16 M
    and a bf16 A (the fused steps) or an f32 A (the validation metrics);
    rbar, dm_adam (bf16 M, mu, nu), gsq and dm_adafactor with bf16 M, A
    and dY, the updates rounding to nearest and stochastically;
    backward_rbar and dm_backward with a bf16 M and f32 A and dY (and at
    the tutorial shape MapperCore on a bf16 M). Timed at the tutorial shape
    in the bf16 phase's configurations."""
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs

    c, s, k = shape
    bf = torch.bfloat16
    x = kernel_inputs(c, s, k, seed=13, dev=dev, pad=shape == RAGGED)
    x = {key: v.to(bf) if key in ("M", "A", "dY", "mu", "nu") else v
         for key, v in x.items()}
    M, A, w, dY, dq, dh = x["M"], x["A"], x["w"], x["dY"], x["dq"], x["dh"]
    M_host = M.cpu()
    runs = 10

    def check(name, pairs, tag, rtol=None):
        rtol = RTOL[name] if rtol is None else rtol
        worst = 0.0
        for what, got, ref in pairs:
            a, r = rel_err(got, ref)
            worst = max(worst, a)
            say("kernels", f"{name} {tag} {what}: max_abs_err={a:.3e} rel={r:.3e} "
                f"(tol rel {rtol:.1e})")
            if not r <= rtol:
                fail(f"{name} {what} disagrees with its twin at {shape} ({tag}): "
                     f"rel {r:.3e}")
        results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0.0), worst)

    def check_update(name, names, got, ref, n_store, tag, rest_rtol=NEXT_STATS_BF16_RTOL):
        """Stored bf16 outputs within BF16_ULPS of the twin's beyond the
        f32 kernel's own tolerance, apart in at most BF16_SHARE of the
        entries; the other outputs (an update's next stats) within
        ``rest_rtol``."""
        for what, g, r in zip(names[:n_store], got[:n_store], ref[:n_store]):
            if g.dtype != bf or r.dtype != bf:
                fail(f"{name} {what} at {shape} is stored as {g.dtype}, not bf16")
            gf, rf = g.float(), r.float()
            diff, ulp = (gf - rf).abs(), bf16_ulp(rf)
            apart = int((diff > 0).sum())
            share = apart / diff.numel()
            err = float(diff.max())
            scale = float(rf[rf.abs() < 1e20].abs().max())
            # where the update cancels (mu near 0), the f32 kernel's own
            # tolerance already allows more than one ulp of the stored value
            over = float(((diff - RTOL[name] * scale).clamp_min(0) / ulp).max())
            say("kernels", f"{name} {tag} {what}: {share:.2e} of entries apart "
                f"({apart}), max {float((diff / ulp).max()):.0f} bf16 ulp, {over:.2f} "
                f"ulp beyond the f32 tolerance (tol {BF16_ULPS:.0f} ulp beyond "
                f"{RTOL[name]:.0e} of max |twin|, on at most {BF16_SHARE:.0e} of the "
                f"entries or one)")
            if not (over <= BF16_ULPS and apart <= max(1, BF16_SHARE * diff.numel())):
                fail(f"{name} {what} stored values disagree with the twin's at {shape} "
                     f"({tag})")
            results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0.0), err)
        check(name, list(zip(names[n_store:], got[n_store:], ref[n_store:])), tag,
              rtol=rest_rtol)

    def time_pair(name, kernel, twin):
        results[name]["ms"] = cuda_ms(kernel, runs)
        results[name]["plain_ms"] = cuda_ms(twin, runs)

    tag = f"{shape} ({cc.rowstats_load_bytes(M)}-byte loads)"
    got, ref = cc._rowstats(M), cc._rowstats_plain(M)
    check("rowstats.bf16", zip("mlu", got, ref), tag)
    m, l, _ = ref
    got, ref = fs._rowstats_norms(M), fs._rowstats_norms_plain(M)
    check("rowstats_norms.bf16", zip(("m", "l", "u", "s1", "s2"), got, ref), tag)

    def check_rounded_y(Y, Yp):
        """Y of a bf16 A within Y_BF16_RTOL of max |twin| beyond the slack
        of P's rounding; a twin with P left in f32 must miss by more."""
        slack = cc.project_rounding_slack(M, A, m, l)
        P = torch.exp(M.float() - m) * (1.0 / l)
        Y_f32 = P.T @ A.float()
        del P
        scale = float(Yp.abs().max())
        beyond = float(((Y - Yp).abs() - slack).max()) / scale
        miss = float(((Y - Y_f32).abs() - slack).max()) / scale
        say("kernels", f"project.bf16 {shape} bf16 A Y: max_abs_err="
            f"{float((Y - Yp).abs().max()):.3e}, beyond the rounding slack (max "
            f"{float(slack.max()) / scale:.1e} of max |Y|) rel={beyond:.3e} (tol rel "
            f"{Y_BF16_RTOL:.0e}); a twin with P left in f32 misses by rel {miss:.3e} "
            f"(must exceed {Y_BF16_RTOL:.0e})")
        if not beyond <= Y_BF16_RTOL:
            fail(f"project.bf16 Y disagrees with its twin at {shape} (bf16 A): rel "
                 f"{beyond:.3e}")
        if not miss > Y_BF16_RTOL:
            fail(f"project.bf16 at {shape} cannot tell whether Y takes P rounded to bf16")
        results["project.bf16"]["max_abs_err"] = max(
            results["project.bf16"].get("max_abs_err", 0.0), float((Y - Yp).abs().max()))

    for A_in, tag in ((A, "bf16 A"), (A.float(), "f32 A")):
        (Y, q), (Yp, qp) = cc._project(M, A_in, w, m, l), cc._project_plain(M, A_in, w, m, l)
        if A_in.dtype == bf:
            check_rounded_y(Y, Yp)
        else:
            check("project.bf16", [("Y", Y, Yp)], f"{shape} {tag}")
        check("project.bf16", [("q", q, qp)], f"{shape} {tag}")
        del Y, Yp
    if timed:
        time_pair("rowstats.bf16", lambda: cc._rowstats(M), lambda: cc._rowstats_plain(M))
        time_pair("rowstats_norms.bf16", lambda: fs._rowstats_norms(M),
                  lambda: fs._rowstats_norms_plain(M))
        logsumexp_note(M, runs)
        time_pair("project.bf16", lambda: cc._project(M, A, w, m, l),
                  lambda: cc._project_plain(M, A, w, m, l))

    lam = (1e-3, 1e-3)
    ops = cc.dp_operands(A, dY)  # bf16 values, one exact product
    if ops.split:
        fail("bf16 A and dY must take the single exact product")
    for with_dh in (False, True):
        args = (M, A, w, m, l, dY, dq, dh)
        r_k, r_p = fs._rbar(*args, with_dh=with_dh), cc._rbar_plain(*args, with_dh=with_dh)
        check("rbar.bf16", [("r", r_k, r_p)], f"{shape} with_dh={with_dh}")
        if timed and not with_dh:
            time_pair("rbar.bf16", lambda: fs._rbar(*args, with_dh=False, operands=ops),
                      lambda: cc._rbar_plain(*args, with_dh=False))
        for rounding in ("nearest", "stochastic"):
            tag = f"{shape} with_dh={with_dh} {rounding}"
            kw = dict(rounding=rounding, step=3)
            for norms in ({}, dict(lam_l1=lam[0], lam_l2=lam[1], with_norms=True)):
                names = ("M", "mu", "nu", "m'", "l'", "u'", "s1'", "s2'")
                k_state = [t.clone() for t in (M, x["mu"], x["nu"])]
                p_state = [t.clone() for t in (M, x["mu"], x["nu"])]
                scalars = fs.adam_scalars(3, 0.1)
                out_k = fs._dm_adam(k_state[0], *args[1:], r_p, *k_state[1:], scalars,
                                    with_dh=with_dh, **norms, **kw)
                out_p = fs._dm_adam_plain(p_state[0], *args[1:], r_p, *p_state[1:],
                                          scalars, with_dh, **norms, **kw)
                check_update("dm_adam.bf16", names, out_k, out_p, 3,
                             tag + (" norms" if norms else ""))
                if timed and not with_dh and not norms and rounding == "stochastic":
                    time_pair("dm_adam.bf16", lambda: fs._dm_adam(
                        k_state[0], *args[1:], r_p, *k_state[1:], scalars, with_dh=False,
                        operands=ops, **kw), lambda: fs._dm_adam_plain(
                        p_state[0], *args[1:], r_p, *p_state[1:], scalars, False, **kw))
                del k_state, p_state, out_k, out_p
            for lam_c in ((0.0, 0.0), lam):
                with_norms = lam_c != (0.0, 0.0)
                ntag = tag + (" norms" if with_norms else "")
                vr_p, vc_p = fs._gsq_plain(*args, r_p, *lam_c, with_dh=with_dh)
                if rounding == "nearest":  # gsq does not round
                    vr_k, vc_k = fs._gsq(*args, r_p, *lam_c, with_dh=with_dh)
                    check("gsq.bf16", [("vr", vr_k, vr_p), ("vc", vc_k, vc_p)], ntag)
                _, _, rowf, colf = fs.factored_rms_vectors(
                    0, torch.zeros_like(vr_p), torch.zeros_like(vc_p), vr_p, vc_p, c, s)
                Mk, Mp = M.clone(), M.clone()
                out_k = fs._dm_adafactor(Mk, *args[1:], r_p, rowf, colf, 0.1, *lam_c,
                                         with_norms=with_norms, with_dh=with_dh, **kw)
                out_p = fs._dm_adafactor_plain(Mp, *args[1:], r_p, rowf, colf, 0.1,
                                               *lam_c, with_norms, with_dh, **kw)
                check_update("dm_adafactor.bf16", ("M", "m'", "l'", "u'", "s1'", "s2'"),
                             out_k, out_p, 1, ntag)
                if timed and not with_dh and with_norms and rounding == "stochastic":
                    time_pair("gsq.bf16", lambda: fs._gsq(*args, r_p, *lam, with_dh=False,
                                                          operands=ops),
                              lambda: fs._gsq_plain(*args, r_p, *lam, with_dh=False))
                    time_pair("dm_adafactor.bf16", lambda: fs._dm_adafactor(
                        Mk, *args[1:], r_p, rowf, colf, 0.1, *lam, with_norms=True,
                        with_dh=False, **kw), lambda: fs._dm_adafactor_plain(
                        Mp, *args[1:], r_p, rowf, colf, 0.1, *lam, True, False, **kw))
                del Mk, Mp, out_k, out_p

    # the unfused backward on a bf16 M with f32 A and dY, as MapperCore
    # hands them: dM stored in bf16, dA and dw f32; timed as _backward calls
    # them, on the backward's operands built once
    A32, dY32 = A.float(), dY.float()
    bops = cc.backward_operands(A32, dY32, dq)
    for with_dh in (False, True):
        tag = f"{shape} with_dh={with_dh}"
        args = (M, A32, w, m, l, dY32, dq, dh)
        r_p = cc._rbar_plain(*args, with_dh=with_dh)
        r_k = cc._rbar(*args, with_dh=with_dh, counter="backward_rbar")
        check("backward_rbar.bf16", [("r", r_k, r_p)], tag)
        out_k = cc._dm_backward(*args, r_p, with_dh=with_dh)
        out_p = cc._dm_backward_plain(*args, r_p, with_dh=with_dh)
        check_update("dm_backward.bf16", ("dM", "dA", "dw"), out_k, out_p, 1, tag,
                     rest_rtol=RTOL["dm_backward.bf16"])
        del out_k, out_p
        if timed and with_dh:
            time_pair("backward_rbar.bf16", lambda: cc._rbar(
                *args, with_dh=True, counter="backward_rbar", operands=bops),
                lambda: cc._rbar_plain(*args, with_dh=True))
            time_pair("dm_backward.bf16", lambda: cc._dm_backward(
                *args, r_p, with_dh=True, operands=bops),
                lambda: cc._dm_backward_plain(*args, r_p, with_dh=True))
    del bops
    if shape == SHAPE:
        check_mapper_core(dict(x, A=A32, dY=dY32), results)
    torch.cuda.synchronize()
    if not torch.equal(M.cpu(), M_host):
        fail(f"a bf16 kernel or twin at {shape} wrote into its input M")


def core_gradients(core, M, A, w, cts):
    """(dM, dA, dw) of Σ Y⊙gY + Σ q⊙gq + Σ h⊙gh through ``core``."""
    import torch

    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (M, A, w)]
        outs = core(*leaves)
        loss = sum((o * g).sum() for o, g in zip(outs, cts))
        return torch.autograd.grad(loss, leaves)


def check_mapper_core(x, results):
    """One forward + backward of mapper_core(impl="kernels") (rowstats,
    project, backward_rbar, dm_backward) against autograd through the
    materialized core, with the kernel phase's cotangents (dY, dq, dh). The
    launch counts are set to 0 before and read after: each kernel once, its
    .bf16 variant with a bf16 M (no training loop takes a bf16 M through
    MapperCore, so this run gives the kernels line the launches of
    backward_rbar.bf16 and dm_backward.bf16). Each gradient within
    dm_backward's RTOL; a bf16 M's dM, stored in bf16, within one bf16 ulp
    beyond that of the reference's f32 gradient of the same bf16 values."""
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops.core import mapper_core, mapper_core_reference

    M, A, w = x["M"], x["A"], x["w"]
    bf16 = M.dtype == torch.bfloat16
    names = [n + (".bf16" if bf16 else "")
             for n in ("rowstats", "project", "backward_rbar", "dm_backward")]
    cts = (x["dY"], x["dq"], x["dh"])
    torch.cuda.synchronize()
    cc.reset_launches()
    got = core_gradients(lambda *t: mapper_core(*t, "kernels"), M, A, w, cts)
    torch.cuda.synchronize()
    ran = {n: v for n, v in cc.LAUNCHES.items() if v}
    if ran != dict.fromkeys(names, 1):
        fail(f"mapper_core(impl='kernels') launched {ran}")
    if bf16:
        for name in names[2:]:
            results[name]["launches"] = ran[name]
    want = core_gradients(mapper_core_reference, M.float(), A, w, cts)
    tag = "bf16 M" if bf16 else "f32"
    for what, g, ref in zip(("dM", "dA", "dw"), got, want):
        a, r = rel_err(g.float(), ref)
        say("kernels", f"MapperCore {SHAPE} {tag} {what} against autograd through the "
            f"materialized core: max_abs_err={a:.3e} rel={r:.3e} "
            f"(tol rel {RTOL['dm_backward']:.0e}" + (", then 1 bf16 ulp)"
                                                      if bf16 and what == "dM" else ")"))
        if bf16 and what == "dM":
            over = ((g.float() - ref).abs() - RTOL["dm_backward"] * float(ref.abs().max()))
            if g.dtype != M.dtype or not float((over / bf16_ulp(ref)).max()) <= BF16_ULPS:
                fail(f"MapperCore's bf16 dM disagrees with autograd through the reference core")
        elif not r <= RTOL["dm_backward"]:
            fail(f"MapperCore's {what} disagrees with autograd through the reference core")


def logsumexp_note(M, runs):
    """torch.logsumexp over M's rows, timed beside the row stats as a note:
    a library one-pass reduction over the same bytes, but not the same
    function (it returns no u and no norms), so not their library call."""
    import torch

    ms = cuda_ms(lambda: torch.logsumexp(M, dim=1), runs)
    say("kernels", f"torch.logsumexp(M, dim=1) on the {str(M.dtype).removeprefix('torch.')} "
        f"M of {tuple(M.shape)}: {ms:.3f} ms (a note beside the row stats)")


def time_gemms(x):
    """cuBLAS f32 (TF32 off) GEMM times at each contraction's shape: a note
    beside the kernels (each also forms P, dP and its epilogue), not the
    library call of the same function, which none of them has."""
    import torch

    M, A_ext = x["M"], torch.cat([x["A"], x["w"][:, None]], dim=1)
    dY_ext = torch.cat([x["dY"], x["dq"][:, None]], dim=1)
    gemm = {"project": cuda_ms(lambda: M.T @ A_ext, 10),            # (s×c)(c×k+1)
            "dP": cuda_ms(lambda: A_ext @ dY_ext.T, 10),            # (c×k+1)(k+1×s)
            "P dY": cuda_ms(lambda: M @ dY_ext, 10)}                # (c×s)(s×k+1)
    say("kernels", f"cuBLAS f32 GEMMs at the contraction shapes of {SHAPE}: "
        f"PᵀA_ext (project) {gemm['project']:.3f} ms, A_ext dY_extᵀ (every dP "
        f"tile) {gemm['dP']:.3f} ms, P dY_ext (dm_backward's second) "
        f"{gemm['P dY']:.3f} ms")


@contextlib.contextmanager
def guarded_allocations(dev, where):
    """While active, every contiguous f32 tensor on ``dev`` that
    ``torch.empty``, ``torch.empty_like`` or ``Tensor.clone`` makes (each
    kernel's outputs and scratch, and the operands the checks copy for the
    in-place kernels) is the middle of a buffer with GUARD sentinel words on
    each side, and starts as sentinel NaNs. On exit, fails if a guard word
    changed: a write out of bounds by up to GUARD words, which is what
    compute-sanitizer's memcheck would report. (A kernel that leaves part of
    its output unwritten shows as NaNs in the twin comparisons.)"""
    import torch

    empty, empty_like, clone = torch.empty, torch.empty_like, torch.Tensor.clone
    live = []
    # a bf16 buffer's guards: the upper half of GUARD_BITS, a bf16 NaN
    word = {torch.float32: (torch.int32, GUARD_BITS),
            torch.bfloat16: (torch.int16, GUARD_BITS >> 16)}

    def ours(dtype, device):
        return ((torch.float32 if dtype is None else dtype) in word
                and device is not None and torch.device(device).type == dev.type)

    def guarded(shape, dtype):
        dtype = torch.float32 if dtype is None else dtype
        n = math.prod(shape)
        int_type, bits = word[dtype]
        buf = empty(n + 2 * GUARD, dtype=int_type, device=dev).fill_(bits)
        live.append((buf, n, bits, sys._getframe(2).f_code.co_name))
        return buf.view(dtype)[GUARD:GUARD + n].view(shape)

    def p_empty(*size, dtype=None, device=None, **kw):
        if kw or not ours(dtype, device):
            return empty(*size, dtype=dtype, device=device, **kw)
        return guarded(tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int)
                       else size, dtype)

    def p_empty_like(t, **kw):
        if kw or not ours(t.dtype, t.device):
            return empty_like(t, **kw)
        return guarded(tuple(t.shape), t.dtype)

    def p_clone(t, **kw):
        if kw or t.requires_grad or not t.is_contiguous() or not ours(t.dtype, t.device):
            return clone(t, **kw)
        return guarded(tuple(t.shape), t.dtype).copy_(t)

    torch.empty, torch.empty_like, torch.Tensor.clone = p_empty, p_empty_like, p_clone
    try:
        yield
    finally:
        torch.empty, torch.empty_like, torch.Tensor.clone = empty, empty_like, clone
    torch.cuda.synchronize()
    hit = {}
    for buf, n, bits, owner in live:
        bad = int((buf[:GUARD] != bits).sum() + (buf[GUARD + n:] != bits).sum())
        if bad:
            hit[owner] = hit.get(owner, 0) + bad
    if hit:
        fail(f"out-of-bounds writes at {where}: guard words changed around buffers made "
             f"by {hit}")
    n_bf16 = sum(buf.dtype == torch.int16 for buf, *_ in live)
    say("kernels", f"{where}: {len(live)} guarded buffers ({n_bf16} bf16) from "
        f"{sorted({owner for *_, owner in live})}: no write outside any "
        f"(guards of {GUARD} elements)")


def check_repeatable(shape, dev, repeats=3):
    """Each kernel, run ``repeats`` times on the same inputs (with the
    entropy cotangent and the L1/L2 terms on), gives the same bits. The
    kernels reduce in a fixed order with no atomics, so a difference is a
    race: what compute-sanitizer's racecheck would look for."""
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs

    c, s, k = shape
    x = kernel_inputs(c, s, k, seed=12, dev=dev, pad=shape == RAGGED)
    M, mu, nu = x["M"], x["mu"], x["nu"]
    m, l, _ = cc._rowstats_plain(M)
    args = (M, x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args)
    vr, vc = fs._gsq_plain(*args, r, 0.0, 0.0)
    _, _, rowf, colf = fs.factored_rms_vectors(
        0, torch.zeros_like(vr), torch.zeros_like(vc), vr, vc, c, s)
    lam = (1e-3, 1e-3)
    runs = {
        "rowstats": lambda: cc._rowstats(M),
        "rowstats_norms": lambda: fs._rowstats_norms(M),
        "project": lambda: cc._project(M, *args[1:5]),
        "rbar": lambda: (fs._rbar(*args),),
        "backward_rbar": lambda: (cc._rbar(*args, counter="backward_rbar"),),
        "dm_backward": lambda: cc._dm_backward(*args, r),
        "dm_adam": lambda: fs._dm_adam(
            M.clone(), *args[1:], r, mu.clone(), nu.clone(), fs.adam_scalars(3, 0.1),
            lam_l1=lam[0], lam_l2=lam[1], with_norms=True),
        "gsq": lambda: fs._gsq(*args, r, *lam),
        "dm_adafactor": lambda: fs._dm_adafactor(
            M.clone(), *args[1:], r, rowf, colf, 0.1, *lam, with_norms=True),
    }
    # the bf16 variants, the updates with stochastic rounding
    bf = torch.bfloat16
    Mb, mub, nub = M.to(bf), mu.to(bf), nu.to(bf)
    mb, lb, _ = cc._rowstats_plain(Mb)
    argsb = (Mb, x["A"].to(bf), x["w"], mb, lb, x["dY"].to(bf), x["dq"], x["dh"])
    rb = cc._rbar_plain(*argsb)
    rb32 = cc._rbar_plain(Mb, *args[1:3], mb, lb, *args[5:])
    vrb, vcb = fs._gsq_plain(*argsb, rb, 0.0, 0.0)
    _, _, rowfb, colfb = fs.factored_rms_vectors(
        0, torch.zeros_like(vrb), torch.zeros_like(vcb), vrb, vcb, c, s)
    sr = dict(rounding="stochastic", step=3)
    runs.update({
        "rowstats.bf16": lambda: cc._rowstats(Mb),
        "rowstats_norms.bf16": lambda: fs._rowstats_norms(Mb),
        "project.bf16": lambda: cc._project(*argsb[:5]),
        "rbar.bf16": lambda: (fs._rbar(*argsb),),
        "dm_adam.bf16": lambda: fs._dm_adam(
            Mb.clone(), *argsb[1:], rb, mub.clone(), nub.clone(), fs.adam_scalars(3, 0.1),
            lam_l1=lam[0], lam_l2=lam[1], with_norms=True, **sr),
        "gsq.bf16": lambda: fs._gsq(*argsb, rb, *lam),
        "dm_adafactor.bf16": lambda: fs._dm_adafactor(
            Mb.clone(), *argsb[1:], rb, rowfb, colfb, 0.1, *lam, with_norms=True, **sr),
        # the backward's on a bf16 M, with f32 A and dY
        "backward_rbar.bf16": lambda: (cc._rbar(Mb, *args[1:3], mb, lb, *args[5:],
                                                counter="backward_rbar"),),
        "dm_backward.bf16": lambda: cc._dm_backward(Mb, *args[1:3], mb, lb, *args[5:],
                                                    rb32),
    })
    for name, run in runs.items():
        first = [t.clone() for t in run()]
        for _ in range(repeats - 1):
            if not all(torch.equal(a, b) for a, b in zip(first, run())):
                fail(f"{name} at {shape} gave different bits on the same inputs")
    say("kernels", f"{shape}: each of the {len(runs)} kernels gave the same bits "
        f"{repeats} times")


# ---------------------------------------------------------------------------
# phases 4-7: the mapping paths
# ---------------------------------------------------------------------------


def tutorial_pair():
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.datasets import synthetic_mapping_pair

    t0 = time.perf_counter()
    ad_sc, ad_sp = synthetic_mapping_pair(*SHAPE, random_state=0)
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp, time.perf_counter() - t0


def check_mapping(phase, ad_map, n_obs, n_spots, n_genes, rising=True):
    """Fail unless the mapping is finite, row-stochastic and of the right
    shape, its history finite, its train_genes_df complete, and (when
    ``rising``) its gene-voxel score higher at the end than at the start."""
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
    if rising and not main[-1] > main[0]:
        fail(f"{phase}: main_loss did not rise ({main[0]:.4f} -> {main[-1]:.4f})")
    df = ad_map.uns["train_genes_df"]
    if len(df) != n_genes or not np.isfinite(df["train_score"].to_numpy()).all():
        fail(f"{phase}: train_genes_df has {len(df)} rows or non-finite scores")
    say(phase, f"main_loss {main[0]:.4f} -> {main[len(main) // 10]:.4f} -> "
        f"{main[len(main) // 2]:.4f} -> {main[-1]:.4f} (epochs 0, 10%, 50%, last); "
        f"total_loss {total[0]:.4f} -> {total[-1]:.4f}; rows sum to 1 "
        f"within {row_err:.1e}; train_genes_df {len(df)} genes, median score "
        f"{float(df['train_score'].median()):.4f}")


def check_launches(phase, expect):
    """Fail unless the launch counts since the last reset are ``expect``,
    with 0 for every kernel it does not name."""
    from tangram_tpu_torch.ops.cuda_core import LAUNCHES

    counts = dict(LAUNCHES)
    expect = {name: expect.get(name, 0) for name in LAUNCHES}
    say(phase, f"launch counts {counts} (expected {expect})")
    if counts != expect:
        fail(f"{phase}: the main path did not run through every kernel: {counts}")
    return counts


def mapper_for(ad_sc, ad_sp, dev, mode, mesh=None):
    """The Mapper (MapperConstrained in constrained mode, with one cell per
    spot as its target count) that map_cells_to_space builds in ``mode``
    with the rna_count_based prior (clusters by subclass_label), over
    ``mesh`` when one is given."""
    from tangram_tpu_torch.mapping import (
        _check_mapping_args, _densify, _resolve_density, _resolve_training_genes,
        adata_to_cluster_expression)
    from tangram_tpu_torch.models.mapper import Mapper, MapperConstrained

    label = "subclass_label" if mode == "clusters" else None
    lam = _check_mapping_args(mode, 1, 0, "rna_count_based", label, SHAPE[1], 1, 1)
    if mode == "clusters":
        ad_sc = adata_to_cluster_expression(ad_sc, label, True, add_density=True)
    genes = _resolve_training_genes(ad_sc, ad_sp, None)
    S = _densify(ad_sc[:, genes].X)
    G = _densify(ad_sp[:, genes].X)
    prior = _resolve_density(mode, "rna_count_based", lam, ad_sc, ad_sp)
    if mode == "constrained":
        return MapperConstrained(S, G, prior.d, lambda_d=prior.lambda_d,
                                 target_count=SHAPE[1], device=dev, random_state=SEED)
    return Mapper(S, G, d=prior.d, d_source=prior.d_source,
                  lambda_d=prior.lambda_d, device=dev, random_state=SEED, mesh=mesh)


def start_params(mapper, param_dtype=None):
    """A copy of the mapper's parameters as fit_mapping takes them: M (in
    ``param_dtype`` when given, made directly in that type), or (M, F) for
    a MapperConstrained, with fit_mapping's constrained flag."""
    import torch

    dtype = getattr(torch, param_dtype) if param_dtype else mapper.M.dtype
    M = mapper.M.clone() if dtype == mapper.M.dtype else mapper.M.to(dtype)
    F = getattr(mapper, "F", None)
    if F is None:
        return M, False
    return (M, F.clone()), True


def step_ms(mapper, impl, warm, steps, lw=None, optimizer="adam", fused=True, **low):
    """Steady-state ms per training step from the mapper's parameters (with
    the loss weights ``lw``, by default the mapper's, and fit_mapping's
    low-precision options ``low``): ``warm`` steps untimed, then ``steps``
    steps between two CUDA events."""
    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping

    lw = mapper.lw if lw is None else lw
    params, constrained = start_params(mapper, low.get("param_dtype"))
    params, opt_state, _ = fit_mapping(params, mapper.data, lw, warm, impl=impl,
                                       return_opt_state=True, optimizer=optimizer,
                                       constrained=constrained, fused=fused, **low)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fit_mapping(params, mapper.data, lw, steps, impl=impl, opt_state=opt_state,
                optimizer=optimizer, constrained=constrained, fused=fused, **low)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / steps


def norm_gradient_ratio(mapper):
    """Mean |L1/L2 gradient| over mean |softmax gradient| at the start of
    training (materialized autograd at λ = 0, and λ₁ + 2λ₂·mean|M|)."""
    import torch

    from tangram_tpu_torch.ops.losses import compute_loss

    with torch.enable_grad():
        Mv = mapper.M.detach().clone().requires_grad_()
        total, _ = compute_loss(Mv, mapper.data, mapper.lw, impl="reference")
        (g,) = torch.autograd.grad(total, (Mv,))
    g_soft = float(g.abs().mean())
    g_norm = LAMBDA_L1 + 2.0 * LAMBDA_L2 * float(mapper.M.abs().mean())
    del g, Mv
    return g_soft, g_norm


def adafactor_divergence(mapper, lw, label, steps=10):
    """Step three Adafactor runs one epoch at a time, the optimizer state
    carried: the kernels and the reference loop from the mapper's logits,
    and the reference loop from logits 1 ulp away (up or down at random,
    seeded). Before each step, two forced steps start from the reference
    loop's own state (logits and carried statistics): one of the kernels,
    and one of the reference loop on the same problem with its spots and
    genes in another order (seeded), so that every sum over spots or genes
    rounds otherwise. Prints how far each lands from the reference loop's
    step (max |ΔM|, and the 2-norm against that of the step), and how far
    the free-running kernels and perturbed reference are from the
    reference (max |ΔM|, and the 2-norm against |M_ref - M_0|); fails
    beyond the tolerances stated at AF_LOSS_TOL."""
    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping

    def step(M, state, impl, data=mapper.data):
        return fit_mapping(M, data, lw, 1, impl=impl, opt_state=state,
                           return_opt_state=True, optimizer="adafactor")[:2]

    def state_copy(state):
        return None if state is None else (state[0],) + tuple(v.clone() for v in state[1:])

    def diff(M, ref, scale):
        d = M - ref
        return float(d.abs().max()), float(d.norm()) / scale

    M0 = mapper.M
    gen = torch.Generator(device=M0.device).manual_seed(0)
    away = torch.full_like(M0, np.inf)
    away[torch.rand(M0.shape, generator=gen, device=M0.device) < 0.5] = -np.inf
    runs = [[M0.clone(), None, "kernels"], [M0.clone(), None, "reference"],
            [torch.nextafter(M0, away), None, "reference"]]
    del away
    perm = torch.randperm(M0.shape[1], generator=gen, device=M0.device)
    data = mapper.data
    genes = torch.randperm(data.S.shape[1], generator=gen, device=M0.device)
    data_perm = data._replace(
        S=data.S[:, genes], G=data.G[perm][:, genes],
        gene_mask=None if data.gene_mask is None else data.gene_mask[genes],
        d=None if data.d is None else data.d[perm])
    # per step: (max |dM|, relative 2-norm) of the forced kernel step, the
    # forced permuted reference step, the free kernels, the free 1-ulp reference
    errs = {"forced kernels": [], "forced permuted": [], "kernels": [], "1 ulp": []}
    for _ in range(steps):
        M_prev, state = runs[1][0].clone(), runs[1][1]
        state_perm = None if state is None else (state[0], state[1].clone(), state[2][perm])
        M_perm = step(M_prev[:, perm], state_perm, "reference", data_perm)[0]
        M_unperm = torch.empty_like(M_perm)
        M_unperm[:, perm] = M_perm
        del M_perm
        forced = (step(M_prev.clone(), state_copy(state), "kernels")[0], M_unperm)
        for run in runs:
            run[0], run[1] = step(run[0], run[1], run[2])
        Mk, Mr, Mp = (run[0] for run in runs)
        moved_step, moved = float((Mr - M_prev).norm()), float((Mr - M0).norm())
        for key, M in zip(errs, forced + (Mk, Mp)):
            errs[key].append(diff(M, Mr, moved_step if key.startswith("forced") else moved))
        del M_prev, forced, M_unperm, Mk, Mr, Mp
    del runs

    def series(xs):
        return " ".join(f"{x:.2e}" for x in xs)

    for key, what, norm in (
            ("forced kernels", "one kernel step from the reference loop's state",
             "the step"),
            ("forced permuted", "one reference step from its state with spots and "
             "genes permuted", "the step"),
            ("kernels", "free-running kernels", "|M_ref - M_0|"),
            ("1 ulp", "free-running reference loop from logits 1 ulp away",
             "|M_ref - M_0|")):
        say("reference", f"{label} logits, steps 1-{steps}, {what} vs the reference "
            f"loop: max |dM| {series(e[0] for e in errs[key])}; |dM| / {norm} "
            f"{series(e[1] for e in errs[key])}")
    say("reference", f"{label} logits tolerance: after step 1 max |dM| <= {M_ATOL:.0e}; "
        f"forced kernel steps |dM| <= {AF_STEP_RTOL:.0e} |step| over steps "
        f"1-{AF_FORCED_STEPS}; free-running |dM| <= {AF_NORM_RTOL:.0e} |M_ref - M_0| "
        f"over steps 1-{AF_FREE_STEPS}")
    if not errs["kernels"][0][0] <= M_ATOL:
        fail(f"reference: {label}: one step of the kernels and of the reference loop differ")
    if not max(e[1] for e in errs["forced kernels"][:AF_FORCED_STEPS]) <= AF_STEP_RTOL:
        fail(f"reference: {label}: a kernel step from the reference loop's state "
             "differs from its own")
    if not max(e[1] for e in errs["kernels"][:AF_FREE_STEPS]) <= AF_NORM_RTOL:
        fail(f"reference: {label}: the kernels and the reference loop differ within "
             f"{AF_FREE_STEPS} steps")


def first_step_check(mapper, lw, optimizer, label, fused):
    """One step of the kernels and of the reference loop from the same
    parameters: the logits within M_ATOL in the max (before rounding
    differences compound)."""
    from tangram_tpu_torch.models.mapper import fit_mapping

    out = []
    for impl in ("kernels", "reference"):
        params, constrained = start_params(mapper)
        params, _ = fit_mapping(params, mapper.data, lw, 1, impl=impl, optimizer=optimizer,
                                fused=fused, constrained=constrained)
        out.append(params[0] if constrained else params)
    err = float((out[0] - out[1]).abs().max())
    say("reference", f"{label} logits after step 1: max abs diff {err:.2e} "
        f"(tol {M_ATOL:.0e})")
    if not err <= M_ATOL:
        fail(f"reference: {label}: one step of the kernels and of the reference loop differ")


def permuted_reference_distance(mapper, lw, M_ref, epochs=10):
    """max |ΔM| between the reference loop's logits ``M_ref`` after
    ``epochs`` Adam steps and the same loop run on the mapper's cells in a
    seeded other order (the logits' rows and the data's per-cell rows
    permuted, the result put back in order): what rounding alone does
    (GRAPH_SPREAD)."""
    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping

    M0, data = mapper.M, mapper.data
    gen = torch.Generator(device=M0.device).manual_seed(0)
    perm = torch.randperm(M0.shape[0], generator=gen, device=M0.device)

    def rows(t):
        return None if t is None else t[perm]

    data = data._replace(S=data.S[perm], ct_encode=rows(data.ct_encode),
                         d_source=rows(data.d_source))
    M_perm, _ = fit_mapping(M0[perm].clone(), data, lw, epochs, impl="reference")
    M_back = torch.empty_like(M_perm)
    M_back[perm] = M_perm
    return float((M_back - M_ref).abs().max())


def compare_with_reference(mapper, lw, optimizer, label, expect, fused=True,
                           rounding_witness=False):
    """10 epochs of the kernels and of the materialized reference loop from
    the same parameters (the logits M, and the filter F of a
    MapperConstrained); fails beyond the stated tolerances, or unless the
    kernels' run launched ``expect``. ``fused=False`` runs the kernels'
    autograd loop through MapperCore. ``rounding_witness`` (Adam with the
    graph terms) holds the logits to GRAPH_SPREAD times the distance of the
    reference loop on permuted cells. Returns the kernels' history (numpy)."""
    import torch

    from tangram_tpu_torch.models.mapper import (
        CONSTRAINED_HISTORY_KEYS, TERM_KEYS, fit_mapping)
    from tangram_tpu_torch.ops import cuda_core

    adafactor = optimizer == "adafactor"
    loss_rtol, loss_atol = (AF_LOSS_TOL, AF_LOSS_TOL) if adafactor else (LOSS_RTOL, 0.0)
    constrained = start_params(mapper)[1]
    if adafactor and constrained:
        first_step_check(mapper, lw, optimizer, label, fused)
    elif adafactor:
        adafactor_divergence(mapper, lw, label)
    runs = {}
    for impl in ("kernels", "reference"):
        params, _ = start_params(mapper)
        torch.cuda.synchronize()
        cuda_core.reset_launches()
        params, hist = fit_mapping(params, mapper.data, lw, 10, impl=impl,
                                   optimizer=optimizer, fused=fused,
                                   constrained=constrained)
        torch.cuda.synchronize()
        if impl == "kernels":
            check_launches("reference", expect)
        runs[impl] = (params, {k: v.cpu().numpy() for k, v in hist.items()})
    (pk, hk), (pr, hr) = runs["kernels"], runs["reference"]
    for key in CONSTRAINED_HISTORY_KEYS if constrained else TERM_KEYS:
        a, b = hk[key], hr[key]
        if np.isnan(b).all() and np.isnan(a).all():
            continue
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
        bad = np.abs(a - b) > loss_rtol * np.abs(b) + loss_atol
        say("reference", f"{label} {key}: max rel diff {rel:.2e} over 10 epochs "
            f"(tol rtol {loss_rtol:.0e}, atol {loss_atol:.0e})")
        if bad.any():
            fail(f"reference: {label} {key} of the kernels and the reference loop differ")
    (Mk, Fk), (Mr, Fr) = (pk, pr) if constrained else ((pk, None), (pr, None))
    dM = (Mk - Mr).abs()
    m_err, m_med = float(dM.max()), float(dM.median())
    far = dM > M_ATOL
    n_far = int(far.sum())
    reach = float(Mr[far].abs().max()) if n_far else 0.0
    p_err = float((torch.softmax(Mk, 1) - torch.softmax(Mr, 1)).abs().max())
    f_err = float((Fk - Fr).abs().max()) if constrained else 0.0
    say("reference", f"{label} logits: max abs diff {m_err:.2e}, median {m_med:.2e}, "
        f"{n_far} beyond {M_ATOL:.0e}" + (f" (all within {reach:.3f} of 0)" if n_far
                                          else "") + f"; softmax maps max abs diff "
        f"{p_err:.2e}" + (f"; filter logits F max abs diff {f_err:.2e}" if constrained
                          else ""))
    if adafactor and constrained:
        ok, rule = True, "held after step 1 only (above)"
    elif adafactor:
        ok, rule = m_med <= M_ATOL, f"median <= {M_ATOL:.0e}"
    elif rounding_witness:
        spread = permuted_reference_distance(mapper, lw, Mr)
        limit = max(M_ATOL, GRAPH_SPREAD * spread)
        ok = m_err <= limit and p_err <= MAP_ATOL
        rule = (f"max <= {limit:.2e} ({GRAPH_SPREAD:.0f}x the {spread:.2e} by which the "
                f"reference loop on permuted cells lands from itself, or {M_ATOL:.0e}); "
                f"maps <= {MAP_ATOL:.0e}")
    elif lw.lambda_l1 != 0:
        ok = (n_far <= KINK_FRACTION * dM.numel() and reach <= KINK_REACH
              and p_err <= MAP_ATOL)
        rule = (f"at most {KINK_FRACTION:.0e} of the logits beyond {M_ATOL:.0e}, "
                f"within {KINK_REACH} of 0; maps <= {MAP_ATOL:.0e}")
    else:
        ok = m_err <= M_ATOL and p_err <= MAP_ATOL and f_err <= M_ATOL
        rule = f"max <= {M_ATOL:.0e} (F too); maps <= {MAP_ATOL:.0e}"
    say("reference", f"{label} logits tolerance: {rule}")
    if not ok:
        fail(f"reference: {label}: the kernels' and the reference loop's mappings differ")
    return hk


def baseline(f32_runs, opts):
    """The f32 numbers of the configuration ``opts`` that the bf16 phase
    compares with: final score ``main``, ``secs`` and ``peak`` (GiB above
    what was resident) of its map_cells_to_space, and ``ms`` per steady step
    and the GiB that training adds (``train``)."""
    return f32_runs.setdefault(json.dumps(opts, sort_keys=True), {})


def final_score(ad_map) -> float:
    return float(np.asarray(ad_map.uns["training_history"]["main_loss"])[-1])


def bf16_phase(ad_sc, ad_sp, dev, card, cells_mapper, norm_lw, f32_runs, con_mapper=None):
    """map_cells_to_space with bf16 logits, Adam moments and contraction
    inputs, 100 epochs in each configuration of BF16_CONFIGS beside its f32
    run: launch counts, rows summing to 1, the final score against the f32
    run's, steady ms/step, the peak device memory of the mapping and what
    training adds, both above what was resident. The f32 numbers come from
    ``f32_runs`` (the cells, adafactor and constrained phases', from the
    same seed); what they lack is measured here. Returns the bf16 variants' launch counts, each from the first
    configuration that runs it: (a) for rowstats, project, rbar and
    dm_adam, (d) for rowstats_norms, gsq and dm_adafactor."""
    import torch

    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.ops import cuda_core

    launches = {}

    def run(opts):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(ad_sc, ad_sp, density_prior="rna_count_based",
                                        num_epochs=EPOCHS, random_state=SEED, **opts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        return ad_map, secs, dict(cuda_core.LAUNCHES), peak

    def step_and_memory(opts, low):
        nonlocal con_mapper
        if opts == CONSTRAINED:
            con_mapper = con_mapper or mapper_for(ad_sc, ad_sp, dev, "constrained")
            mapper, lw = con_mapper, con_mapper.lw
        else:
            mapper = cells_mapper
            lw = norm_lw if "lambda_l1" in opts else cells_mapper.lw
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = step_ms(mapper, "kernels", warm=3, steps=10, lw=lw,
                     optimizer=opts.get("optimizer", "adam"), **low)
        return ms, (torch.cuda.max_memory_allocated() - base) / 2**30

    for label, rounding, opts, expect in BF16_CONFIGS:
        f32 = baseline(f32_runs, opts)
        if "main" not in f32:  # the f32 run of the same configuration
            ad_map, secs, _, peak = run(opts)
            f32.update(main=final_score(ad_map), secs=secs, peak=peak)
            del ad_map
        if "ms" not in f32:
            f32["ms"], f32["train"] = step_and_memory(opts, {})
        low = dict(BF16_STORAGE, rounding=rounding)
        ad_map, secs, counts, peak = run(dict(opts, **low))
        check_launches("bf16", {f"{name}.bf16": n for name, n in expect.items()})
        for name in expect:
            launches.setdefault(f"{name}.bf16", counts[f"{name}.bf16"])
        X = np.asarray(ad_map.X)
        if X.dtype != np.float32:
            fail(f"bf16 {label}: the mapping is {X.dtype}, not float32")
        check_mapping("bf16", ad_map, SHAPE[0], SHAPE[1], SHAPE[2],
                      rising=opts.get("optimizer", "adam") == "adam")
        main = final_score(ad_map)
        del ad_map
        ms, train_gib = step_and_memory(opts, low)
        say("bf16", f"{label}: final score {main:.4f} against f32 {f32['main']:.4f} "
            f"(|diff| {abs(main - f32['main']):.2e}, tol {BF16_SCORE_TOL:.0e}); "
            f"{ms:.2f} ms/step against f32 {f32['ms']:.2f}; peak of map_cells_to_space "
            f"{peak:.3f} GiB against f32 {f32['peak']:.3f}, training adds "
            f"{train_gib:.3f} GiB against f32 {f32['train']:.3f}, each above what was "
            f"resident; {secs:.1f} s against f32 {f32['secs']:.1f} s for {EPOCHS} "
            f"epochs ({card})")
        if not abs(main - f32["main"]) <= BF16_SCORE_TOL:
            fail(f"bf16 {label}: the final score strays from the f32 run's")

    return launches


def check_fit_repeats(cells_mapper, norm_lw, con_mapper, epochs=10):
    """Two fit_mapping runs of ``epochs`` steps from one start must store
    the same bits, in f32 Adam, f32 Adafactor + L1/L2, constrained Adam (M
    and F), constrained Adafactor (the autograd loop through MapperCore:
    backward_rbar and dm_backward) and bf16 Adam with stochastic rounding
    (configuration (a)): every
    kernel reduces in a fixed order and the loops draw nothing at random
    after the start, so a difference is a fault, not chance."""
    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping

    cases = (("f32 Adam", cells_mapper, cells_mapper.lw, "adam", {}),
             ("f32 Adafactor + L1/L2", cells_mapper, norm_lw, "adafactor", {}),
             ("constrained Adam", con_mapper, con_mapper.lw, "adam", {}),
             ("constrained Adafactor", con_mapper, con_mapper.lw, "adafactor", {}),
             ("(a) bf16 Adam, stochastic", cells_mapper, cells_mapper.lw, "adam",
              dict(BF16_STORAGE, rounding="stochastic")))
    for label, mapper, lw, opt, low in cases:
        runs = []
        for _ in range(2):
            params, constrained = start_params(mapper, low.get("param_dtype"))
            params, _ = fit_mapping(params, mapper.data, lw, epochs, impl="kernels",
                                    optimizer=opt, constrained=constrained, **low)
            runs.append([t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                         for t in (params if constrained else (params,))])
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"repeat: two {epochs}-step {label} runs from the same start differ")
        say("repeat", f"two {epochs}-step {label} runs from the same start stored the "
            f"same bits ({'M and F' if len(runs[0]) == 2 else 'M'})")
    check_fits_across_processes(cells_mapper, norm_lw, epochs)


def fit_bits(cells_mapper, norm_lw, epochs):
    """Hashes of the cells mapper's start (M and its data) and, for f32 Adam
    and f32 Adafactor + L1/L2, of M after an ``epochs``-step fit from it,
    with each step's total loss as a hex float (the first step that
    differs)."""
    import hashlib

    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    data = cells_mapper.data
    out = {"M0": digest(cells_mapper.M),
           "data": digest(*(t for t in data if isinstance(t, torch.Tensor)))}
    for label, lw, opt in (("f32 Adam", cells_mapper.lw, "adam"),
                           ("f32 Adafactor + L1/L2", norm_lw, "adafactor")):
        M, _ = start_params(cells_mapper)
        M, hist = fit_mapping(M, data, lw, epochs, impl="kernels", optimizer=opt)
        out[label] = {"M": digest(M),
                      "loss": [float(x).hex() for x in hist["total_loss"].tolist()]}
    return out


def fit_bits_child(epochs) -> int:
    """The child process of :func:`check_fits_across_processes`: the tutorial
    pair and the cells mapper made anew from their seeds, the fits of
    :func:`fit_bits`, their hashes printed as the last line."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    ad_sc, ad_sp, _ = tutorial_pair()
    mapper = mapper_for(ad_sc, ad_sp, torch.device("cuda"), "cells")
    norm_lw = dataclasses.replace(mapper.lw, lambda_l1=LAMBDA_L1, lambda_l2=LAMBDA_L2)
    print(json.dumps(fit_bits(mapper, norm_lw, epochs)))
    return 0


def check_fits_across_processes(cells_mapper, norm_lw, epochs):
    """The fits of :func:`fit_bits` in this process and in a child python3
    process that makes the tutorial pair, the mapper and its start anew from
    the same seeds, with another history of device allocations (every
    pointer-alignment choice of the kernels' wrappers made afresh): the
    hashes must agree."""
    t0 = time.perf_counter()
    here = fit_bits(cells_mapper, norm_lw, epochs)
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--fit-bits", str(epochs)],
                           capture_output=True, text=True, timeout=600, cwd=str(REPO))
    if child.returncode != 0:
        fail(f"repeat: the child process failed ({child.returncode}): "
             f"{child.stderr[-2000:]}")
    there = json.loads(child.stdout.strip().splitlines()[-1])
    for key in here:
        same = here[key] == there[key]
        detail = (here[key]["M"] if isinstance(here[key], dict) else here[key])
        if not same and isinstance(here[key], dict):
            steps = [t for t, (a, b) in enumerate(zip(here[key]["loss"],
                                                      there[key]["loss"])) if a != b]
            detail = (f"M {here[key]['M']} against {there[key]['M']}; the total "
                      f"loss first differs before step {steps[0] if steps else None}")
        elif not same:
            detail = f"{here[key]} against {there[key]}"
        say("repeat", f"across processes, {key}: {'same bits' if same else 'DIFFER'} "
            f"(sha256 {detail})")
        if not same:
            fail(f"repeat: {key} differs between this process and a fresh one")
    say("repeat", f"{epochs}-step f32 Adam and Adafactor + L1/L2 fits stored the same "
        f"bits in a fresh process ({time.perf_counter() - t0:.1f} s with the child)")


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


def profile_dp_tile(dev):
    """Where rbar, gsq, dm_adam, dm_adafactor (f32 and bf16), dm_backward
    (f32) and project (f32 and bf16) spend their cycles at
    the tutorial shape: a second build of the kernels with -DTG_DP_PROFILE
    counts, in two warps of every block (0 and 15 of the dP tile; of
    project, product warp 0 and forming warp 8), the clock cycles of each
    phase of the tile or chunk loop;
    printed as shares of their sum beside each kernel's time in that build
    (the counters cost a few percent). Then project's two sides each alone,
    from two more builds (their outputs meaningless): the copies and the
    forming with the product skipped, and the product with the copies and
    the forming skipped."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tangram_tpu_torch.ops import _build
    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs

    builds = (("-DTG_DP_PROFILE",), ("-DTG_PJ_FORM_ONLY",), ("-DTG_PJ_PRODUCT_ONLY",))
    with ThreadPoolExecutor(len(builds)) as pool:
        lib, form_only, product_only = pool.map(_build.load_kernels, builds)
    plain, _build.load_kernels = _build.load_kernels, lambda: lib
    try:
        x = kernel_inputs(*SHAPE, seed=11, dev=dev)
        m, l, _ = cc._rowstats_plain(x["M"])
        scalars = fs.adam_scalars(3, 0.1)
        bf = torch.bfloat16
        for tag, cast, kw in (("f32", lambda t: t, {}),
                              ("bf16", lambda t: t.to(bf),
                               dict(rounding="stochastic", step=3))):
            M, A, dY = cast(x["M"]), cast(x["A"]), cast(x["dY"])
            args = (M, A, x["w"], m, l, dY, x["dq"], x["dh"])
            ops = cc.dp_operands(A, dY)
            r = cc._rbar_plain(*args, with_dh=False)
            state = [M.clone(), cast(x["mu"]), cast(x["nu"])]
            vr, vc = fs._gsq_plain(*args, r, 0.0, 0.0, with_dh=False)
            _, _, rowf, colf = fs.factored_rms_vectors(
                0, torch.zeros_like(vr), torch.zeros_like(vc), vr, vc, *SHAPE[:2])
            runs = [("rbar", lambda: fs._rbar(*args, with_dh=False, operands=ops)),
                    ("gsq", lambda: fs._gsq(*args, r, 0.0, 0.0, with_dh=False,
                                            operands=ops)),
                    ("dm_adam", lambda: fs._dm_adam(
                        state[0], *args[1:], r, *state[1:], scalars, with_dh=False,
                        operands=ops, **kw)),
                    ("dm_adafactor", lambda: fs._dm_adafactor(
                        state[0], *args[1:], r, rowf, colf, 0.1, 0.0, 0.0, False,
                        with_dh=False, operands=ops, **kw))]
            if tag == "f32":
                bops = cc.backward_operands(A, dY, x["dq"])
                runs.append(("dm_backward", lambda: cc._dm_backward(
                    *args, r, with_dh=True, operands=bops)))
            for name, run in runs:
                clocks = (ctypes.c_ulonglong * 4)()
                lib.call("tg_dp_profile_read", clocks)  # clear
                ms = cuda_ms(run, 10)
                lib.call("tg_dp_profile_read", clocks)
                total = float(sum(clocks)) or 1.0
                shares = ", ".join(f"{what} {100 * n / total:.1f}%" for what, n in zip(
                    ("epilogue and loop", "waits and barriers", "issuing copies",
                     "product"), clocks))
                say("profile", f"{name} {tag} at {SHAPE}: {ms:.3f} ms with the "
                    f"counters; cycles of warps 0 and 15: {shares}")
            clocks = (ctypes.c_ulonglong * 10)()
            lib.call("tg_pj_profile_read", clocks)  # clear
            ms = cuda_ms(lambda: cc._project(M, A, x["w"], m, l), 10)
            lib.call("tg_pj_profile_read", clocks)

            def phase_shares(part, names):
                total = float(sum(part)) or 1.0
                return ", ".join(f"{what} {100 * n / total:.1f}%"
                                 for what, n in zip(names, part) if what)

            say("profile", f"project {tag} at {SHAPE}: {ms:.3f} ms with the counters; "
                "cycles of product warp 0: " + phase_shares(
                    clocks[:5], ("epilogue and loop", "waiting for a formed chunk", "", "",
                                 "product")) + "; of forming warp 8: " + phase_shares(
                    clocks[5:9], ("loop", "waits for copies, a free buffer and the "
                                  "other forming warps", "issuing copies",
                                  "forming P and X")))
            sides = []
            for side, side_lib in (("copies and forming alone", form_only),
                                   ("product alone", product_only)):
                _build.load_kernels = lambda side_lib=side_lib: side_lib
                sides.append(f"{side} {cuda_ms(lambda: cc._project(M, A, x['w'], m, l), 10):.3f}"
                             " ms")
            _build.load_kernels = lambda: lib
            say("profile", f"project {tag} at {SHAPE}, each side alone: " + ", ".join(sides))
    finally:
        _build.load_kernels = plain


# ---------------------------------------------------------------------------
# phase 10: the graph terms
# ---------------------------------------------------------------------------

# The JAX bench's full stack of graph terms (bench.py:240-244), the
# cell-type islands by the pair's 22 subclasses: A = [S | one-hot], k = 249
# + 22 = 271, so k + 1 = 272 > 256 puts project on two column panels and
# the dP tile's A operand (K padded to 288) past its resident panel.
GRAPH_TERMS = dict(lambda_neighborhood_g1=0.5, lambda_ct_islands=0.3,
                   lambda_getis_ord=0.3, lambda_moran=0.3, lambda_geary=0.3)
ISLANDS_LABEL = "subclass_label"
GRAPH_FORMATS = ("dense", "knn")
REPEAT_EPOCHS = 10
ADAM_LAUNCHES = {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS, "dm_adam": EPOCHS}


def with_graphs(mapper, ad_sc, ad_sp, graph_format):
    """The mapper's logits with its data and loss weights extended by the
    five graph terms as map_cells_to_space builds them for ``graph_format``:
    its spot graphs put on the mapper's device by the Mapper's own
    ``_to_weights``, the cell types of ``ad_sc`` (the mapper's rows: the
    cells, or the clusters of the aggregated AnnData) and the reference
    indicators of G. What fit_mapping, step_ms and compare_with_reference
    take."""
    import types

    import torch

    from tangram_tpu_torch.mapping import _build_spot_graphs
    from tangram_tpu_torch.ops.losses import spatial_local_indicators
    from tangram_tpu_torch.utils import one_hot_encoding

    lw = dataclasses.replace(mapper.lw, **GRAPH_TERMS)
    graphs = {slot: mapper._to_weights(W) for slot, W in
              _build_spot_graphs(ad_sp, GRAPH_TERMS, graph_format).items()}
    ct = one_hot_encoding(ad_sc.obs[ISLANDS_LABEL]).values.astype(np.float32)
    refs = spatial_local_indicators(mapper.data.G, graphs["spatial_weights"], lw)
    data = mapper.data._replace(
        ct_encode=torch.from_numpy(ct).to(mapper.M.device), getis_ord_ref=refs[0],
        moran_ref=refs[1], geary_ref=refs[2], **graphs)
    return types.SimpleNamespace(M=mapper.M, data=data, lw=lw)


def islands_width_kernels(dev, card, ad_sc):
    """project, rbar and dm_adam at the islands width (A = [S | the pair's
    one-hot cell types], k = 271) against their twins (RTOL) and by the
    f32-accuracy witness (the one-hot columns kept exact), then timed
    beside the same kernels at k = 249 on the kernel phase's inputs, each
    with its bound."""
    import torch

    from tangram_tpu_torch.ops import cuda_core as cc
    from tangram_tpu_torch.ops import fused_step as fs
    from tangram_tpu_torch.utils import one_hot_encoding

    c, s, g = SHAPE
    ct = one_hot_encoding(ad_sc.obs[ISLANDS_LABEL]).values.astype(np.float32)
    k = g + ct.shape[1]
    scalars = fs.adam_scalars(3, 0.1)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    times = {}
    for width in (g, k):
        x = kernel_inputs(c, s, width, seed=11, dev=dev)
        if width == k:
            x["A"][:, g:] = torch.from_numpy(ct).to(dev)
        M, A, w, dY, dq, dh = x["M"], x["A"], x["w"], x["dY"], x["dq"], x["dh"]
        m, l, _ = cc._rowstats_plain(M)
        args = (M, A, w, m, l, dY, dq, dh)
        r_p = cc._rbar_plain(*args, with_dh=False)
        Mk, muk, nuk = M.clone(), x["mu"].clone(), x["nu"].clone()
        adam_k = fs._dm_adam(Mk, A, w, m, l, dY, dq, dh, r_p, muk, nuk, scalars,
                             with_dh=False)
        adam_p = fs._dm_adam_plain(M.clone(), A, w, m, l, dY, dq, dh, r_p,
                                   x["mu"].clone(), x["nu"].clone(), scalars, False)
        for name, outs, got, ref in (
                ("project", "Yq", cc._project(*args[:5]), cc._project_plain(*args[:5])),
                ("rbar", ["r"], [fs._rbar(*args, with_dh=False)], [r_p]),
                ("dm_adam", ("M", "mu", "nu", "m'", "l'", "u'"), adam_k, adam_p)):
            for what, a, b in zip(outs, got, ref):
                err, rel = rel_err(a, b)
                say("spatial", f"{name} at k = {width} {what}: max_abs_err={err:.3e} "
                    f"rel={rel:.3e} (tol rel {RTOL[name]:.0e})")
                if not rel <= RTOL[name]:
                    fail(f"spatial: {name} at k = {width} disagrees with its twin ({what})")
        del adam_k, adam_p
        if width == k:
            check_f32_accuracy((c, s, k), x, m, l, scalars, parts=("adam", "project"),
                               fraction_cols=g, phase="spatial")
        ops = cc.dp_operands(A, dY)  # as a fused step builds them
        Mp, mup, nup = M.clone(), x["mu"].clone(), x["nu"].clone()
        times[width] = {name: (cuda_ms(kernel, 10), cuda_ms(twin, 10)) for name, kernel, twin in (
            ("project", lambda: cc._project(*args[:5]), lambda: cc._project_plain(*args[:5])),
            ("rbar", lambda: fs._rbar(*args, with_dh=False, operands=ops),
             lambda: cc._rbar_plain(*args, with_dh=False)),
            ("dm_adam", lambda: fs._dm_adam(Mk, A, w, m, l, dY, dq, dh, r_p, muk, nuk,
                                            scalars, with_dh=False, operands=ops),
             lambda: fs._dm_adam_plain(Mp, A, w, m, l, dY, dq, dh, r_p, mup, nup,
                                       scalars, False)))}
        say("spatial", f"the dP tile's A and dY operands at k = {width} move "
            f"{dp_l2_bytes(c, s, width, sm_count) / 1e9:.2f} GB through L2 per launch; "
            f"project's [A | w] {project_l2_bytes(c, s, width) / 1e9:.2f} GB, as "
            f"reckoned from the tile shapes")
        del x, M, A, dY, Mk, muk, nuk, Mp, mup, nup, ops, args
        gc.collect()
    for name in times[g]:
        (ms_g, twin_g), (ms_k, twin_k) = times[g][name], times[k][name]
        bounds = [bound_ms(name, (c, s, width))[0] for width in (g, k)]
        say("spatial", f"{name}: k = {g} {ms_g:.3f} ms (twin {twin_g:.3f}, bound "
            f"{bounds[0]:.3f}), k = {k} {ms_k:.3f} ms (twin {twin_k:.3f}, bound "
            f"{bounds[1]:.3f}); {ms_k / ms_g:.3f}x for {(k + 1) / (g + 1):.3f}x the "
            f"columns ({card})")


def islands_where_they_bite(mapper, ad_sc, ad_sp):
    """The mapper with the cell-type-island term alone on k-NN graphs, its
    neighbourhood filter standardized (each spot's neighbours' mean, as the
    CPU tests use) in place of the reference's binary one: with the binary
    filter a spot's type mass never exceeds its neighbours' sum at this
    shape, so max(·, 0) is off on every entry and the term has no gradient
    (ROADMAP queue C)."""
    import types

    from tangram_tpu_torch.spatial import neighbor_graph

    stack = with_graphs(mapper, ad_sc, ad_sp, "knn")
    lw = dataclasses.replace(mapper.lw, lambda_ct_islands=GRAPH_TERMS["lambda_ct_islands"])
    data = stack.data._replace(
        neighborhood_filter=mapper._to_weights(neighbor_graph(ad_sp, True, False)))
    return types.SimpleNamespace(M=mapper.M, data=data, lw=lw)


def check_graph_terms_finite(hist, label):
    from tangram_tpu_torch.models.mapper import GRAPH_TERM_KEYS

    for key in GRAPH_TERM_KEYS:
        vals = hist[key].cpu().numpy()
        if not np.isfinite(vals).all():
            fail(f"spatial: {label}: the {key} history is not finite")


def spatial_phase(dev, card, ad_sc, ad_sp, cells_mapper, profile=False):
    """Phase 10: the five graph terms at the tutorial shape (module
    docstring); ``profile`` adds a torch.profiler table of five steps of
    each stack."""
    import torch

    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.mapping import adata_to_cluster_expression
    from tangram_tpu_torch.models.mapper import GRAPH_TERM_KEYS, fit_mapping
    from tangram_tpu_torch.ops import cuda_core

    t0 = time.perf_counter()
    islands_width_kernels(dev, card, ad_sc)

    # the stack through the public entry point, dense and k-NN
    for fmt in GRAPH_FORMATS:
        with device_peak() as peak:
            cuda_core.reset_launches()
            ad_map, secs = cuda_seconds(lambda: tgt.map_cells_to_space(
                ad_sc, ad_sp, density_prior="rna_count_based", num_epochs=EPOCHS,
                random_state=SEED, cluster_label=ISLANDS_LABEL, graph_format=fmt,
                **GRAPH_TERMS))
        check_launches("spatial", ADAM_LAUNCHES)
        check_mapping("spatial", ad_map, *SHAPE)
        say("spatial", f"{fmt} five-term stack: map_cells_to_space {secs:.2f} s for "
            f"{EPOCHS} epochs (graphs built on the host included); peak device memory "
            f"{peak['gib']:.3f} GiB above what was resident ({card})")
        del ad_map

    # steady step times in one call, the plain step beside the two stacks,
    # and each stack's graph terms finite over ten steps
    stacks = {fmt: with_graphs(cells_mapper, ad_sc, ad_sp, fmt) for fmt in GRAPH_FORMATS}
    ms = {}
    for label, mapper in (("no graph term", cells_mapper), ("dense stack", stacks["dense"]),
                          ("k-NN stack", stacks["knn"]), ("no graph term again", cells_mapper)):
        with device_peak() as peak:
            ms[label] = step_ms(mapper, "kernels", warm=5, steps=20)
        say("spatial", f"{label}: steady {ms[label]:.3f} ms/step at {SHAPE}; training adds "
            f"{peak['gib']:.3f} GiB ({card})")
    for fmt, mapper in stacks.items():
        _, hist = fit_mapping(mapper.M.clone(), mapper.data, mapper.lw, REPEAT_EPOCHS,
                              impl="kernels")
        check_graph_terms_finite(hist, f"{fmt} stack")
        say("spatial", f"{fmt} stack, {REPEAT_EPOCHS} steps: " + ", ".join(
            f"{key} {float(hist[key][0]):.4f} -> {float(hist[key][-1]):.4f}"
            for key in GRAPH_TERM_KEYS))
        if profile:
            say("spatial", f"torch.profiler, five steps of the {fmt} stack:")
            profile_steps(mapper)

    # the k-NN stack against the materialized reference loop, and repeated
    knn = stacks["knn"]
    compare_with_reference(knn, knn.lw, "adam", "five-term k-NN stack",
                           {"rowstats": 1, "project": 10, "rbar": 10, "dm_adam": 10},
                           rounding_witness=True)
    runs = []
    for _ in range(2):
        M, hist = fit_mapping(knn.M.clone(), knn.data, knn.lw, REPEAT_EPOCHS,
                              impl="kernels")
        runs.append([M.view(torch.int32)] + [hist[key].view(torch.int32) for key in hist])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"spatial: two {REPEAT_EPOCHS}-step k-NN stack runs from the same start differ")
    say("spatial", f"two {REPEAT_EPOCHS}-step k-NN stack runs from the same start stored "
        "the same bits (M and every term of the history)")
    del stacks, knn, runs

    # the island term where its max(·, 0) bites, against the reference loop
    islands = islands_where_they_bite(cells_mapper, ad_sc, ad_sp)
    hist = compare_with_reference(islands, islands.lw, "adam",
                                  "islands, standardized filter",
                                  {"rowstats": 1, "project": 10, "rbar": 10, "dm_adam": 10},
                                  rounding_witness=True)
    penalty = hist["ct_island_penalty"]
    if not (np.isfinite(penalty).all() and (penalty > 0).all()):
        fail(f"spatial: the island penalty with a standardized filter is not positive: "
             f"{penalty}")
    say("spatial", f"islands, standardized filter: ct_island_penalty {penalty[0]:.4e} -> "
        f"{penalty[-1]:.4e} over 10 steps (non-zero: max(·, 0) is on)")
    del islands

    # clusters mode: the islands' encoding is the identity of the clusters
    cuda_core.reset_launches()
    ad_map, secs = cuda_seconds(lambda: tgt.map_cells_to_space(
        ad_sc, ad_sp, mode="clusters", cluster_label=ISLANDS_LABEL, num_epochs=EPOCHS,
        random_state=SEED, graph_format="knn", **GRAPH_TERMS))
    check_launches("spatial", ADAM_LAUNCHES)
    n_clusters = ad_map.X.shape[0]
    check_mapping("spatial", ad_map, n_clusters, SHAPE[1], SHAPE[2])
    clusters = mapper_for(ad_sc, ad_sp, dev, "clusters")
    aggregated = adata_to_cluster_expression(ad_sc, ISLANDS_LABEL, True, add_density=True)
    stack = with_graphs(clusters, aggregated, ad_sp, "knn")
    ms_c = step_ms(stack, "kernels", warm=5, steps=50)
    ms_plain = step_ms(clusters, "kernels", warm=5, steps=50)
    say("spatial", f"clusters ({n_clusters}), k-NN five-term stack: {EPOCHS} epochs in "
        f"{secs:.2f} s; steady {ms_c:.3f} ms/step, {ms_plain:.3f} without the graph "
        f"terms ({card})")
    say("spatial", f"phase done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: cross-validation, schedules, early stop, checkpoints, init draws
# ---------------------------------------------------------------------------

# the recorded LOO fixture of data/NB_REFERENCE_TORCH.json["loo_cv"]:
# synthetic_mapping_pair(1320, 9852, 249, 22 types, random_state=5),
# clusters mode, 1000 epochs, lr 0.1, seed 42
LOO_PAIR = (1_320, 9_852, 249)
LOO_KW = dict(cluster_label="subclass_label", mode="clusters", cv_mode="loo",
              num_epochs=1000, learning_rate=0.1, random_state=42)
LOO_TOL = 1e-3          # per recorded gene, their mean, and the all-fold mean
LOOP_FOLDS = 2          # folds of the loop path held against the batched path
CV_CELLS_EPOCHS = 10    # the cells-mode 10-fold CV at the tutorial shape
SCHEDULE_EPOCHS = 12    # the cosine_lr vector against chained constant runs
EARLY_STOP = dict(early_stop_tol=3e-2, early_stop_window=50)
EARLY_STOP_BUDGET = 300
INIT_SIDE = 33_000      # 33,000² > 2^30 entries: init_method="auto" draws on the card


def cuda_seconds(fn):
    """(result, host seconds) of ``fn()`` ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def device_peak():
    """Yields a dict that gets ``"gib"``: max_memory_allocated above what was
    resident when the block began, in GiB."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    yield out
    torch.cuda.synchronize()
    out["bytes"] = torch.cuda.max_memory_allocated() - base
    out["gib"] = out["bytes"] / 2**30


def loo_pair():
    """The fixture of data/NB_REFERENCE_TORCH.json's LOO, preprocessed."""
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.datasets import synthetic_mapping_pair

    ad_sc, ad_sp = synthetic_mapping_pair(*LOO_PAIR, n_types=22, random_state=5)
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


def cv_loo(dev, card, problems, profile=False):
    """The 249-fold batched LOO against the recorded torch scores, then the
    loop path (fused kernels) on LOOP_FOLDS of its folds against it."""
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.evaluation import _fold_bytes, _loop_fold
    from tangram_tpu_torch.mapping import adata_to_cluster_expression
    from tangram_tpu_torch.ops import cuda_core

    ref = json.loads((REPO / "data" / "NB_REFERENCE_TORCH.json").read_text())["loo_cv"]
    ad_sc, ad_sp = loo_pair()
    genes = list(ad_sc.uns["training_genes"])
    if profile:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            cuda_seconds(lambda: tgt.cross_val(
                ad_sc, ad_sp, device=dev, fold_batch_size=len(genes), verbose=False,
                **{**LOO_KW, "num_epochs": 3}))
        say("cv", "torch.profiler, the batched LOO for 3 epochs (init and scoring "
            "included), by device time:\n" + prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=25))
    n_types = ad_sc.obs["subclass_label"].nunique()
    with device_peak() as peak:
        (cv, _, df), secs = cuda_seconds(lambda: tgt.cross_val(
            ad_sc, ad_sp, device=dev, fold_batch_size=len(genes), return_gene_pred=True,
            verbose=False, **LOO_KW))
    epochs = LOO_KW["num_epochs"]
    say("cv", f"batched LOO: {len(genes)} folds x {epochs} epochs at {n_types} x "
        f"{LOO_PAIR[1]} x {len(genes)} in one batch: {secs:.2f} s "
        f"({secs / epochs * 1e3:.2f} ms/step for all folds, "
        f"{secs / epochs / len(genes) * 1e3:.4f} per fold); peak device memory "
        f"{peak['gib']:.3f} GiB above what was resident (the fold-bytes formula: "
        f"{len(genes) * _fold_bytes(n_types, LOO_PAIR[1], len(genes)) / 2**30:.3f} GiB) "
        f"({card})")
    recorded = ref["torch_per_gene"]
    deltas = {g: float(df.loc[g, "score"]) - v for g, v in recorded.items()}
    worst = max(deltas, key=lambda g: abs(deltas[g]))
    mean25 = float(np.mean([df.loc[g, "score"] for g in recorded]))
    say("cv", f"the {len(recorded)} recorded genes: max |delta| {abs(deltas[worst]):.2e} "
        f"({worst}: {float(df.loc[worst, 'score']):.5f} vs {recorded[worst]}); mean "
        f"{mean25:.5f} vs {ref['reference_torch_avg_test_score']}; all-fold mean "
        f"{cv['avg_test_score']:.5f} vs {ref['rebuild_avg_test_score_all_folds']} "
        f"(tolerance {LOO_TOL:g}); avg train score {cv['avg_train_score']:.5f}")
    if abs(deltas[worst]) > LOO_TOL:
        problems.append(f"LOO: {worst} scored {float(df.loc[worst, 'score']):.5f}, "
                        f"recorded {recorded[worst]}")
    if abs(mean25 - ref["reference_torch_avg_test_score"]) > LOO_TOL:
        problems.append(f"LOO: mean of the recorded genes {mean25:.5f}")
    if abs(cv["avg_test_score"] - ref["rebuild_avg_test_score_all_folds"]) > LOO_TOL:
        problems.append(f"LOO: all-fold mean {cv['avg_test_score']:.5f}")

    sc_scored = adata_to_cluster_expression(ad_sc, LOO_KW["cluster_label"], True)
    map_kw = dict(mode="clusters", device=dev, learning_rate=LOO_KW["learning_rate"],
                  num_epochs=epochs, cluster_label=LOO_KW["cluster_label"], scale=True,
                  lambda_d=0, lambda_g1=1, lambda_g2=0, lambda_r=0, lambda_count=1,
                  lambda_f_reg=1, target_count=None,
                  random_state=LOO_KW["random_state"], density_prior=None)
    cuda_core.reset_launches()
    t0 = time.perf_counter()
    for gene in list(recorded)[:LOOP_FOLDS]:
        fold, _ = _loop_fold(ad_sc, ad_sp, sc_scored, [g for g in genes if g != gene],
                             [gene], **map_kw)
        delta = fold["test_score"] - float(df.loc[gene, "score"])
        say("cv", f"loop path, fold {gene}: test score {fold['test_score']:.5f}, "
            f"batched {float(df.loc[gene, 'score']):.5f} (|delta| {abs(delta):.2e}); "
            f"train score {fold['train_score']:.5f}")
        if abs(delta) > LOO_TOL:
            problems.append(f"loop path: fold {gene} scored {fold['test_score']:.5f}, "
                            f"the batched path {float(df.loc[gene, 'score']):.5f}")
    per_fold = (time.perf_counter() - t0) / LOOP_FOLDS
    try:
        check_launches("cv", {"rowstats": LOOP_FOLDS, "project": LOOP_FOLDS * epochs,
                              "rbar": LOOP_FOLDS * epochs, "dm_adam": LOOP_FOLDS * epochs})
    except RuntimeError as err:
        problems.append(str(err))
    say("cv", f"loop path: {per_fold:.2f} s per fold of {epochs} epochs through the "
        f"fused kernels; {per_fold * len(genes):.1f} s extrapolated to {len(genes)} "
        f"folds, against {secs:.2f} s batched ({card})")


def cv_cells(dev, card, ad_sc, ad_sp, cells_mapper, problems):
    """Cells-mode 10-fold CV at the tutorial shape with fold_batch_size="auto":
    the chosen batch, the measured peak per fold against the formula and
    the budget, and the batched step's ms per fold beside the fused step's."""
    import torch

    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.evaluation import _fit_folds, _fold_bytes, auto_fold_batch_size
    from tangram_tpu_torch.ops.losses import LossWeights, MapperData
    from tangram_tpu_torch.utils import device_memory_budget

    batch = auto_fold_batch_size(*SHAPE, dev)
    budget = device_memory_budget(dev)
    formula = _fold_bytes(*SHAPE)
    with device_peak() as peak:
        cv, secs = cuda_seconds(lambda: tgt.cross_val(
            ad_sc, ad_sp, mode="cells", cv_mode="10fold", num_epochs=CV_CELLS_EPOCHS,
            random_state=SEED, device=dev, fold_batch_size="auto", verbose=False))
    say("cv", f"cells 10-fold at {SHAPE}, {CV_CELLS_EPOCHS} epochs, fold_batch_size='auto' "
        f"-> {batch} folds per batch: {secs:.2f} s; avg test score "
        f"{cv['avg_test_score']:.4f}, train {cv['avg_train_score']:.4f}; peak "
        f"{peak['gib']:.3f} GiB above what was resident, {peak['bytes'] / batch / 2**30:.3f} "
        f"GiB per fold against the formula's {formula / 2**30:.3f}; budget "
        f"{budget / 2**30:.3f} GiB ({card})")
    if peak["bytes"] > budget:
        problems.append(f"cells CV: peak {peak['gib']:.3f} GiB above the budget "
                        f"{budget / 2**30:.3f}")
    if peak["bytes"] / batch > formula:
        problems.append(f"cells CV: {peak['bytes'] / batch / 2**30:.3f} GiB per fold, "
                        f"more than the formula's {formula / 2**30:.3f}")
    if not all(0 < cv[k] < 1 for k in cv):
        problems.append(f"cells CV: scores {cv}")

    data = MapperData(S=cells_mapper.data.S, G=cells_mapper.data.G)
    masks = torch.ones((batch, SHAPE[2]), device=dev)
    masks[:, :SHAPE[2] // 10] = 0
    _fit_folds(cells_mapper.M, data, masks, LossWeights(), 1, 0.1, False)
    steps = 5
    _, secs = cuda_seconds(lambda: _fit_folds(cells_mapper.M, data, masks, LossWeights(),
                                              steps, 0.1, False))
    ms_fused = step_ms(cells_mapper, "kernels", warm=3, steps=10, lw=LossWeights())
    say("cv", f"batched cells-mode step: {secs / steps * 1e3:.2f} ms for {batch} folds, "
        f"{secs / steps / batch * 1e3:.2f} ms per fold, against the fused Adam step's "
        f"{ms_fused:.2f} ms ({card})")


def cv_schedules(dev, ad_sc, ad_sp, cells_mapper, problems):
    """A cosine_lr vector on the fused Adam, Adafactor and constrained loops
    against chained one-epoch constant runs with the state carried: bit for
    bit when the vector run is sliced at the same epochs (Mapper.train's
    print chunks; each fit starts from row stats the rowstats kernel
    computes), and the one-call run's distance from them (within a call the
    row stats come from the update kernel's merge, in another order)."""
    import torch

    from tangram_tpu_torch import cosine_lr
    from tangram_tpu_torch.models.mapper import _train_chunked, fit_mapping

    lrs = cosine_lr(0.1, SCHEDULE_EPOCHS, end=0.01, warmup=2)
    con_mapper = mapper_for(ad_sc, ad_sp, dev, "constrained")
    for label, mapper, opt in (("adam", cells_mapper, "adam"),
                               ("adafactor", cells_mapper, "adafactor"),
                               ("constrained adam", con_mapper, "adam")):
        _, constrained = start_params(mapper)
        kw = dict(impl="kernels", optimizer=opt, constrained=constrained)

        def run_chunk(params, state, chunk, lr_chunk, epoch):
            return fit_mapping(params, mapper.data, mapper.lw, chunk, lr_chunk,
                               opt_state=state, return_opt_state=True, **kw)

        sliced, _ = _train_chunked(run_chunk, start_params(mapper)[0], SCHEDULE_EPOCHS,
                                   lrs, 1, None)
        one_call, _ = fit_mapping(start_params(mapper)[0], mapper.data, mapper.lw,
                                  SCHEDULE_EPOCHS, lrs, **kw)
        params, state, two = start_params(mapper)[0], None, None
        for t in range(SCHEDULE_EPOCHS):
            params, state, _ = fit_mapping(params, mapper.data, mapper.lw, 1,
                                           float(lrs[t]), opt_state=state,
                                           return_opt_state=True, **kw)
            if t == 1:
                two = fit_mapping(start_params(mapper)[0], mapper.data, mapper.lw, 2,
                                  lrs[:2], **kw)[0]
                first = params.clone() if not constrained else params[0].clone()

        def leaves(p):
            return p if constrained else (p,)

        same = all(torch.equal(a, b) for a, b in zip(leaves(sliced), leaves(params)))
        err = max(float((a - b).abs().max())
                  for a, b in zip(leaves(one_call), leaves(params)))
        err2 = float((leaves(two)[0] - first).abs().max())
        say("cv", f"cosine_lr over {SCHEDULE_EPOCHS} epochs, {label}: the vector sliced "
            f"per epoch against {SCHEDULE_EPOCHS} chained one-epoch constant runs: "
            f"{'the same bits' if same else 'DIFFERENT'}; the vector in one call: max "
            f"|diff| {err:.3e} (after 2 epochs {err2:.3e})")
        if not same:
            problems.append(f"schedule: {label}: the sliced vector run and the chained "
                            "constant runs differ")
    del con_mapper


def cv_early_stop_and_checkpoint(dev, ad_sc, ad_sp, cells_mapper, problems):
    """Early stopping at the tutorial shape against an unstopped run of its
    length, then train_checkpointed stopped and resumed against an unbroken
    run (clusters mode, a cosine schedule)."""
    import tempfile

    import torch

    from tangram_tpu_torch import checkpoint, cosine_lr
    from tangram_tpu_torch.ops import cuda_core

    start = cells_mapper.M.clone()
    cuda_core.reset_launches()
    (_, hist), secs = cuda_seconds(lambda: cells_mapper.train(
        EARLY_STOP_BUDGET, print_each=None, **EARLY_STOP))
    n_run = len(hist["main_loss"])
    window = EARLY_STOP["early_stop_window"]
    stopped = cells_mapper.M.clone()
    try:
        check_launches("cv", {"rowstats": n_run // window, "project": n_run,
                              "rbar": n_run, "dm_adam": n_run})
    except RuntimeError as err:
        problems.append(str(err))
    cells_mapper.M = start.clone()
    _, full = cells_mapper.train(n_run, print_each=window)
    same = (torch.equal(stopped, cells_mapper.M)
            and all(np.array_equal(hist[k], full[k]) for k in ("main_loss", "total_loss")))
    bests = [max(hist["main_loss"][i:i + window]) for i in range(0, n_run, window)]
    say("cv", f"early stop (tol {EARLY_STOP['early_stop_tol']:g}, window {window}, budget "
        f"{EARLY_STOP_BUDGET}): stopped after {n_run} epochs in {secs:.2f} s; best score "
        f"per window {', '.join(f'{b:.4f}' for b in bests)}; against an unstopped "
        f"{n_run}-epoch run: {'the same bits' if same else 'DIFFERENT'}")
    if not (0 < n_run < EARLY_STOP_BUDGET and n_run % window == 0 and same):
        problems.append(f"early stop: {n_run} epochs, prefix identical: {same}")
    cells_mapper.M = start

    mapper = mapper_for(ad_sc, ad_sp, dev, "clusters")
    lrs = cosine_lr(0.1, 30, end=0.01)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        whole, h_whole = checkpoint.train_checkpointed(
            mapper.M.clone(), mapper.data, mapper.lw, 30, lrs, Path(tmp) / "whole",
            checkpoint_every=10, impl="kernels")
        checkpoint.train_checkpointed(mapper.M.clone(), mapper.data, mapper.lw, 20,
                                      lrs[:20], Path(tmp) / "cut", checkpoint_every=10,
                                      impl="kernels")
        resumed, h_res = checkpoint.train_checkpointed(
            mapper.M.clone(), mapper.data, mapper.lw, 30, lrs, Path(tmp) / "cut",
            checkpoint_every=10, impl="kernels")
    same = torch.equal(whole, resumed) and all(
        np.array_equal(h_whole[k], h_res[k], equal_nan=True) for k in h_whole)
    say("cv", f"train_checkpointed, clusters, cosine_lr, 30 epochs in chunks of 10, cut "
        f"after 20 and resumed: {'the same bits' if same else 'DIFFERENT'} as the unbroken "
        f"run ({len(h_res['total_loss'])} epochs of history)")
    if not same:
        problems.append("checkpoint: the resumed run differs from the unbroken one")


def cv_init_draw(dev, card, problems):
    """init_method="auto" above 2^30 entries draws on the card."""
    import torch

    from tangram_tpu_torch.models.mapper import DEVICE_DRAW_ENTRIES, init_logits

    n = INIT_SIDE
    M, secs = cuda_seconds(lambda: init_logits(n, n, SEED, "auto", device=dev))
    mean = float(torch.mean(M, dtype=torch.float64))
    std = float(torch.std(M))
    same = torch.equal(M, init_logits(n, n, SEED, "jax", device=dev))
    say("cv", f"init_method='auto' at {n} x {n} ({n * n / DEVICE_DRAW_ENTRIES:.3f} x 2^30 "
        f"entries): on {M.device}, {secs * 1e3:.1f} ms; mean {mean:.2e}, std {std:.6f}; "
        f"{'the' if same else 'NOT the'} device draw ({card})")
    if not (M.is_cuda and same and abs(mean) <= 1e-3 and abs(std - 1) <= 1e-3):
        problems.append(f"init: device {M.device}, device draw {same}, mean {mean}, "
                        f"std {std}")


def cv_phase(dev, card, ad_sc, ad_sp, cells_mapper, profile=False):
    """Phase 11; any of its checks failing fails the phase after all ran.
    ``profile`` adds a torch.profiler table of the batched LOO."""
    problems = []
    t0 = time.perf_counter()
    cv_loo(dev, card, problems, profile)
    cv_cells(dev, card, ad_sc, ad_sp, cells_mapper, problems)
    cv_schedules(dev, ad_sc, ad_sp, cells_mapper, problems)
    cv_early_stop_and_checkpoint(dev, ad_sc, ad_sp, cells_mapper, problems)
    cv_init_draw(dev, card, problems)
    say("cv", f"phase done in {time.perf_counter() - t0:.1f} s")
    if problems:
        fail("cv: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# phase 12: the downstream modules on the mapping
# ---------------------------------------------------------------------------

PROJECT_GENES = 2_048   # the width of the device product's expression matrix
PROJECT_CHUNK = 4_096   # a spot chunk below the spot count: three chunks
TF32_MISS = 10.0        # a TF32 product must err more than this times the f32 one
OBJECTS_PER_SPOT = 5    # Poisson mean of the synthetic segmentation
BENCH_EPOCHS = 20


def projection_error(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def projection_tol(n_cells: int) -> float:
    """The tolerance of an f32 product summed over ``n_cells`` terms, as a
    fraction of its largest entry: 4·sqrt(n)·2^-24, four times the typical
    error of an f32 sum of n terms taken one after another, as a GEMM on
    the card sums its K axis (3.8e-5 at 26,000 cells)."""
    return 4.0 * math.sqrt(n_cells) * 2.0**-24


def downstream_mapping(dev, card, ad_sc, ad_sp):
    """(a) The main path inside profiling.record_phases: its phases and the
    launch counts of rows 1-4."""
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.ops import cuda_core

    cuda_core.reset_launches()
    with tgt.profiling.record_phases() as phases:
        ad_map, secs = cuda_seconds(lambda: tgt.map_cells_to_space(
            ad_sc, ad_sp, density_prior="rna_count_based", num_epochs=EPOCHS,
            random_state=SEED, **CELLS))
    check_launches("downstream", ADAM_LAUNCHES)
    check_mapping("downstream", ad_map, *SHAPE)
    want = {"preprocess", "mapper_init", "train_dispatch", "train_execute_history",
            "mapping_fetch", "gene_report"}
    if set(phases) != want:
        fail(f"downstream: record_phases recorded {sorted(phases)}, not {sorted(want)}")
    say("downstream", f"(a) map_cells_to_space {secs:.3f} s for {EPOCHS} epochs; "
        "record_phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
        + f" ({card})")
    return ad_map


def downstream_projection(dev, card, M, S):
    """(b) projected_expression on the card (one chunk, and PROJECT_CHUNK
    chunks) and on the host against a float64 product on the card, TF32
    off, within projection_tol; on centered (signed) expression a TF32
    product errs more than TF32_MISS times the f32 device product."""
    import torch

    from tangram_tpu_torch.evaluation import _projects_on_device, projected_expression

    rng = np.random.default_rng(SEED)
    cols = rng.integers(0, S.shape[1], PROJECT_GENES)
    X = (S[:, cols] * rng.uniform(0.5, 1.5, PROJECT_GENES)).astype(np.float32)
    M_dev = torch.from_numpy(M).to(dev)

    def float64_product(X):
        return (M_dev.double().T @ torch.from_numpy(X).to(dev).double()).cpu().numpy()

    ref = float64_product(X)
    tol = projection_tol(M.shape[0])
    errs, secs = {}, {}
    for label, kw in (("device", dict(backend="device")),
                      (f"device, spot_chunk={PROJECT_CHUNK}",
                       dict(backend="device", spot_chunk=PROJECT_CHUNK)),
                      ("host", dict(backend="host"))):
        out, secs[label] = cuda_seconds(lambda: projected_expression(M, X, **kw))
        errs[label] = projection_error(out, ref)
    say("downstream", f"(b) projected_expression M {M.shape} x X {X.shape}: " + ", ".join(
        f"{k} {secs[k]:.3f} s, rel err {errs[k]:.2e}" for k in errs)
        + f" against float64, as a fraction of its largest entry (tol {tol:.2e}) ({card})")
    if not all(e <= tol for e in errs.values()):
        fail("downstream: projected_expression misses the float64 product")

    # the witness: the same product with TF32 on misses the tolerance (on
    # counts, one TF32 rounding per entry averages out over 26,000 cells;
    # on centered expression the sum cancels and it does not)
    Xc = (X - X.mean(axis=0, dtype=np.float64)).astype(np.float32)
    ref_c = float64_product(Xc)
    err_f32 = projection_error(projected_expression(M, Xc, backend="device"), ref_c)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err_tf32 = projection_error(
            (M_dev.T @ torch.from_numpy(Xc).to(dev)).cpu().numpy(), ref_c)
        err_tf32_counts = projection_error(
            (M_dev.T @ torch.from_numpy(X).to(dev)).cpu().numpy(), ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    say("downstream", f"(b) centered X: device f32 rel err {err_f32:.2e}, a TF32 product "
        f"{err_tf32:.2e} ({err_tf32 / err_f32:.1f}x the f32 error, {err_tf32 / tol:.1f}x "
        f"the tolerance; on the counts {err_tf32_counts:.2e})")
    if not (err_f32 <= tol and err_tf32 > TF32_MISS * err_f32):
        fail("downstream: the f32 device product is not held apart from a TF32 one")
    on_device = _projects_on_device("auto", M.size, None)
    say("downstream", f"(b) backend='auto' at {M.size:.3e} entries of M (threshold "
        f"2^28 = {2**28:.3e}) takes the {'device' if on_device else 'host'}")
    if on_device:
        fail("downstream: backend='auto' took the device below 2^28 entries")


def segmentation(ad_sp, rng):
    """squidpy-style image features: Poisson(OBJECTS_PER_SPOT) objects per
    spot, centroids within a quarter pitch of the spot's coordinates."""
    import pandas as pd

    xy = np.asarray(ad_sp.obsm["spatial"], dtype=float)
    counts = rng.poisson(OBJECTS_PER_SPOT, len(xy))
    offsets = rng.uniform(-0.25, 0.25, (int(counts.sum()), 2))
    owner = np.repeat(np.arange(len(xy)), counts)
    cent = xy[owner][:, ::-1] + offsets  # (y, x) pairs, as squidpy stores them
    bounds = np.concatenate([[0], np.cumsum(counts)])
    per_spot = [list(map(tuple, cent[bounds[i]:bounds[i + 1]])) for i in range(len(xy))]
    return pd.DataFrame({"segmentation_label": counts,
                         "segmentation_centroid": pd.Series(per_spot, index=ad_sp.obs.index)},
                        index=ad_sp.obs.index)


def downstream_deconvolution(card, ad_map, ad_sc, ad_sp):
    """(c) The deconvolution chain on a synthetic segmentation, each step
    held to a numpy computation of what it must give."""
    import tangram_tpu_torch as tgt

    rng = np.random.default_rng(SEED)
    ad_sp.obsm["image_features"] = segmentation(ad_sp, rng)
    n_objects = ad_sp.obsm["image_features"]["segmentation_label"].to_numpy()
    M = np.asarray(ad_map.X)
    label = ISLANDS_LABEL
    secs = {}
    _, secs["create_segment_cell_df"] = cuda_seconds(lambda: tgt.create_segment_cell_df(ad_sp))
    _, secs["project_cell_annotations"] = cuda_seconds(
        lambda: tgt.project_cell_annotations(ad_map, ad_sp, annotation=label))
    onehot = tgt.one_hot_encoding(ad_map.obs[label])
    pred = ad_sp.obsm["tangram_ct_pred"]
    want_pred = M.T @ onehot.to_numpy(dtype=float)
    if list(pred.columns) != list(onehot.columns) or not np.allclose(
            pred.to_numpy(), want_pred, rtol=1e-12, atol=0):
        fail("downstream: project_cell_annotations is not M^T onehot")
    _, secs["count_cell_annotations"] = cuda_seconds(
        lambda: tgt.count_cell_annotations(ad_map, ad_sc, ad_sp, annotation=label))
    counts = ad_sp.obsm["tangram_ct_count"][list(onehot.columns)].to_numpy()
    top = np.bincount(M.argmax(axis=1), minlength=M.shape[1])
    if not np.array_equal(counts.sum(axis=1), top):
        fail("downstream: count_cell_annotations' per-spot sums are not the argmax counts")
    segment, secs["deconvolve_cell_annotations"] = cuda_seconds(
        lambda: tgt.deconvolve_cell_annotations(ad_sp))
    want_rows = int(np.minimum(top, n_objects).sum())
    if segment.n_obs != want_rows or segment.obsm["spatial"].shape != (want_rows, 2):
        fail(f"downstream: deconvolve_cell_annotations has {segment.n_obs} objects, not "
             f"{want_rows}")
    ad_map.obs["cell_types"] = ad_map.obs[label]
    _, secs["cell_type_mapping"] = cuda_seconds(lambda: tgt.cell_type_mapping(ad_map))
    ct_map = ad_map.varm["ct_map"].to_numpy()
    if not (np.isfinite(ct_map).all() and ct_map.min() >= 0 and ct_map.max() <= 1):
        fail("downstream: cell_type_mapping leaves [0, 1]")
    say("downstream", f"(c) {int(n_objects.sum())} segmented objects over {len(n_objects)} "
        f"spots; {segment.n_obs} assigned a type (= sum of min(argmax count, objects)); "
        "seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f" ({card})")


def downstream_selection(card, ad_sc, ad_sp):
    """(d) cell_sampling and svg at the tutorial shape."""
    import tangram_tpu_torch as tgt

    sampled, secs_cs = cuda_seconds(lambda: tgt.cell_selection.cell_sampling(
        ad_sc, ad_sp, cell_type_key=ISLANDS_LABEL))
    info = sampled.uns["cell_sampling"]
    totals = np.asarray(sampled.X).sum(axis=1)
    fractions = np.array(list(info["cell_type_fractions"].values()))
    if not (sampled.n_obs > 0 and totals.max() <= 1500 and abs(fractions.sum() - 1) < 1e-9
            and set(sampled.obs[ISLANDS_LABEL]) <= set(ad_sc.obs[ISLANDS_LABEL])):
        fail("downstream: cell_sampling's output is wrong")
    found, secs_svg = cuda_seconds(lambda: tgt.gene_selection.svg(ad_sp))
    res = ad_sp.uns["svg_results"]
    if not (len(res) == ad_sp.n_vars and np.isfinite(res["moran_i"]).all()
            and res["padj"].between(0, 1).all()):
        fail("downstream: svg's results are wrong")
    say("downstream", f"(d) cell_sampling: {sampled.n_obs} cells for "
        f"{info['number_of_cells']} estimated, {secs_cs:.3f} s; svg: {len(found)} of "
        f"{ad_sp.n_vars} genes at padj < 0.05, Moran's I in "
        f"[{res['moran_i'].min():.3f}, {res['moran_i'].max():.3f}], {secs_svg:.3f} s ({card})")


def downstream_plots(card, ad_map, ad_sp):
    """(e) Two plots to an Agg canvas, when matplotlib (and for the score
    dashboard seaborn) is installed."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "seaborn")}
    say("downstream", f"(e) installed: {have}")
    if not have["matplotlib"]:
        say("downstream", "(e) no matplotlib: plotting not run")
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    import tangram_tpu_torch as tgt

    xy = np.asarray(ad_sp.obsm["spatial"])
    ad_map.var["x"], ad_map.var["y"] = xy[:, 0], xy[:, 1]
    fig, secs = cuda_seconds(lambda: tgt.plot_cell_annotation(
        ad_map, ad_sp, annotation=ISLANDS_LABEL, nrows=5, ncols=5))
    fig.canvas.draw()
    drawn = [len(ax.collections[0].get_offsets()) for ax in fig.axes if ax.collections]
    n_types = ad_sp.obsm["tangram_ct_pred"].shape[1]
    if drawn != [ad_sp.n_obs] * n_types:
        fail(f"downstream: plot_cell_annotation drew {drawn}")
    msg = f"(e) plot_cell_annotation: {n_types} panels of {ad_sp.n_obs} spots, {secs:.3f} s"
    if have["seaborn"]:
        fig, secs = cuda_seconds(lambda: tgt.plot_training_scores(ad_map))
        fig.canvas.draw()
        msg += f"; plot_training_scores {secs:.3f} s"
    plt.close("all")
    say("downstream", msg + f" ({card})")


def downstream_phase(dev, card, ad_sc, ad_sp, cells_mapper):
    """Phase 12: the modules downstream of the mapping, on the mapping of
    the main path at the tutorial shape (module docstring)."""
    import tangram_tpu_torch as tgt

    t0 = time.perf_counter()
    from tangram_tpu_torch.mapping import _densify

    ad_map = downstream_mapping(dev, card, ad_sc, ad_sp)
    S = _densify(ad_sc[:, ad_map.uns["train_genes_df"].index].X)
    downstream_projection(dev, card, np.asarray(ad_map.X), S)
    downstream_deconvolution(card, ad_map, ad_sc, ad_sp)
    downstream_selection(card, ad_sc, ad_sp)
    downstream_plots(card, ad_map, ad_sp)
    bench = tgt.profiling.benchmark_mapping(*SHAPE, num_epochs=BENCH_EPOCHS, device=dev)
    ms = step_ms(cells_mapper, "kernels", warm=5, steps=20)
    say("downstream", f"(f) benchmark_mapping at {SHAPE}, {BENCH_EPOCHS} epochs on "
        f"{bench['backend']}: {bench['ms_per_step']:.3f} ms/step ({bench['seconds']:.3f} s); "
        f"phase cells' steady step {ms:.3f} ms ({card})")
    for key in ("tangram_ct_pred", "tangram_ct_count", "tangram_spot_centroids",
                "image_features"):
        ad_sp.obsm.pop(key, None)
    for key in ("tangram_cell_segmentation", "svg_results"):
        ad_sp.uns.pop(key, None)
    say("downstream", f"phase done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the hyperparameter tuner
# ---------------------------------------------------------------------------

TUNER_LABEL = "subclass_label"
# (a) the JAX bench's sweep (bench.py:475-560): 32 configs x 3 repeats in one
# batch of 96 members, 1000 epochs; its search space leaves lambda_g1 out,
# which the JAX tuner reads as 0, so the members train the density term
TUNER_TRIALS, TUNER_EPOCHS, TUNER_SEED = 32, 1000, 1
TUNER_LR = (10 ** -1.7, 10 ** -0.3)
TUNER_METRIC = ["gene_expr_correctness", "cell_map_consistency"]
TUNER_STEPS = 20        # steps timed by CUDA events for ms/step
# (b) device metrics against the float64 host functions on one cube: the
# same formulas in f32 over 6.5e5 (cells x spots) or 1.6e5 (genes x spots)
# entries per run
TUNER_HOST_TOL = 1e-5
# (d) a config trained alone against the same config inside the batch of
# 96: the same arithmetic per member, but the batched products and sums may
# take other cuBLAS and reduction paths, so rounding may differ and grow
# over 1000 Adam steps; stated before the first card run
TUNER_BATCH_TOL = 1e-4
# (c) the population trainer against fit_mapping(impl="reference") from the
# same start: plain Adam's M_ATOL and MAP_ATOL, the graph config by the
# permuted-reference witness (GRAPH_SPREAD) where it needs it
TUNER_CHECK_EPOCHS = 100
TUNER_GRAPH = dict(lambda_neighborhood_g1=0.5, lambda_ct_islands=0.3, lambda_getis_ord=0.3)
# (e) the three graph lambdas in the search space
TUNER_GRAPH_TRIALS, TUNER_GRAPH_EPOCHS, TUNER_PROFILE_STEPS = 4, 100, 3
# (f) the other search modes: (trials, batch, epochs)
TUNER_ADAPTIVE = (16, 4, 200)
TUNER_HALVING = (27, 9, 300)
TUNER_BOHB = (12, 4, 300)
# (g) resume: (trials, batch, epochs); SKILL step 10's rtol
TUNER_RESUME = (8, 4, 100)
TUNER_RESUME_RTOL = 1e-5


def tuner_setup(ad_cl, ad_sp, dev):
    """The tuner's _PopulationSetup for the pair, built as
    mapping_hyperparameter_tuning builds it (every gene trains and
    validates; the rna_count_based prior; the three dense spot graphs; the
    one-hot cluster labels). Run 0's init continues numpy's stream."""
    from tangram_tpu_torch import spatial as sw
    from tangram_tpu_torch import tuning
    from tangram_tpu_torch.deconv import one_hot_encoding
    from tangram_tpu_torch.mapping import _densify

    genes = ad_cl.uns["overlap_genes"]
    idx = list(range(len(genes)))
    return tuning._PopulationSetup(
        _densify(ad_cl[:, genes].X), _densify(ad_sp[:, genes].X),
        np.asarray(ad_sp.obs["rna_count_based_density"], dtype=np.float32),
        sw.spatial_weights(ad_sp, standardized=True, self_inclusion=True),
        sw.spatial_weights(ad_sp, standardized=False, self_inclusion=False),
        one_hot_encoding(ad_cl.obs[TUNER_LABEL]).values,
        sw.spatial_weights(ad_sp, standardized=False, self_inclusion=True),
        idx, idx, device=dev)


def train_alone(setup, configs, epochs, active):
    """(logits (configs, repeats, c, s), device metrics) of ``configs``
    trained from the repeat inits by the tuner's population trainer."""
    import torch

    from tangram_tpu_torch import tuning

    n = len(configs)
    lam = setup.lam_matrix(configs, range(n))
    peaks, ends = setup.lr_vectors(configs, range(n))
    M = setup.M0s.expand(n, *setup.M0s.shape).clone()
    count = torch.zeros(M.shape[:2], dtype=torch.int32, device=M.device)
    with tuning._full_f32():
        mets = setup._train(lam, peaks, ends, M, count, torch.zeros_like(M),
                            torch.zeros_like(M), 0, epochs, epochs, active)
    return M, {k: v.cpu().numpy().astype(np.float64) for k, v in mets.items()}


def tuner_step_ms(setup, configs, active, steps):
    """ms per step of the population trainer on ``configs`` (CUDA events
    around ``steps`` steps, after a warm call of 2)."""
    import torch

    train_alone(setup, configs, 2, active)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    train_alone(setup, configs, steps, active)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / steps


def device_time_profile(fn, is_part=lambda shapes: False, top=5):
    """The device time of ``fn()`` under torch.profiler: a dict with the
    total ms, the ms of the aten::mm/bmm calls with ``is_part(input_shapes)``
    and the ``top`` aten ops by the device time of the kernels each
    launches itself; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total") if self_only
                     else ("device_time_total", "cuda_time_total")):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    # every kernel counts once, under the op that launched it
    ops = {e.key: device_us(e, True) for e in prof.key_averages()
           if e.key.startswith("aten::")}
    total = sum(ops.values())
    if total <= 0:
        return None
    part = sum(device_us(e, False) for e in prof.key_averages(group_by_input_shape=True)
               if e.key in ("aten::mm", "aten::bmm")
               and is_part(getattr(e, "input_shapes", None) or []))
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return {"total": total / 1e3, "part": part / 1e3,
            "top": [(k, v / 1e3) for k, v in ranked]}


def profile_line(prof, steps):
    """The top ops of :func:`device_time_profile` as one line."""
    if prof is None:
        return "not measured (the profiler saw no device time)"
    return (f"{prof['total']:.1f} ms of device time over {steps} steps: " + ", ".join(
        f"{k} {100 * v / prof['total']:.1f}%" for k, v in prof["top"]))


def tuner_frames(pair, **kw):
    import tangram_tpu_torch as tgt

    return tgt.mapping_hyperparameter_tuning(*pair, **kw).get_results().get_dataframe()


def tuner_sweep(dev, card, pair, setup):
    """(a) the JAX bench's sweep twice from one ambient seed: seconds,
    trials/s, peak memory; (h) the two frames bit for bit. Returns the
    second frame and its search space."""
    from tangram_tpu_torch import tuning

    config = {"learning_rate": tuning.loguniform(*TUNER_LR),
              "lambda_d": tuning.uniform(0.0, 1.0), "num_epochs": TUNER_EPOCHS}
    kw = dict(metric=TUNER_METRIC, config=config, tuner_num_samples=TUNER_TRIALS,
              population_batch_size=TUNER_TRIALS, random_state=TUNER_SEED,
              cluster_label=TUNER_LABEL, device=dev)
    frames = []
    for call in ("warm", "timed"):
        np.random.seed(SEED)
        with device_peak() as peak:
            df, secs = cuda_seconds(lambda: tuner_frames(pair, **kw))
        frames.append(df)
        say("tuner", f"(a) {call} sobol sweep: {TUNER_TRIALS} trials x {tuning.N_REPEATS} "
            f"repeats x {TUNER_EPOCHS} epochs in one batch at {pair[0].n_obs} x "
            f"{pair[1].n_obs} x {len(pair[0].uns['overlap_genes'])}: {secs:.2f} s, "
            f"{TUNER_TRIALS / secs:.3f} trials/s; peak {peak['gib']:.3f} GiB above the "
            f"resident ({card})")
    metrics = frames[0][tuning.METRIC_KEYS].to_numpy()
    if not np.isfinite(metrics).all():
        fail("tuner: (a) the sweep's metrics are not finite")
    active = tuning._space_active_lambdas(
        {k: tuning._coerce_domain(v) for k, v in config.items()}, setup.lam_keys)
    configs = [{"learning_rate": float(lr), "lambda_d": float(ld), "num_epochs": TUNER_EPOCHS}
               for lr, ld in zip(frames[1]["config/learning_rate"], frames[1]["config/lambda_d"])]
    ms = tuner_step_ms(setup, configs, active, TUNER_STEPS)
    prof = device_time_profile(lambda: train_alone(setup, configs, TUNER_PROFILE_STEPS,
                                                   active))
    say("tuner", f"(a) population trainer: {ms:.2f} ms/step for {3 * TUNER_TRIALS} members "
        f"(active terms {sorted(active)}; CUDA events, {TUNER_STEPS} steps); torch.profiler: "
        f"{profile_line(prof, TUNER_PROFILE_STEPS)} ({card})")
    same = all(np.array_equal(frames[0][c].to_numpy(), frames[1][c].to_numpy())
               for c in frames[0].columns)
    say("tuner", f"(h) the two sweeps' frames: {'same bits' if same else 'DIFFER'}")
    if not same:
        fail("tuner: (h) the same sobol sweep twice gave different frames")
    return frames[1], configs, active


def tuner_cube_and_batch(setup, frame, configs, active):
    """(b) one config's repeat cube: the device metrics against the host
    float64 functions; (d) that config alone against the batch's row."""
    import torch

    from tangram_tpu_torch import tuning

    M, mets = train_alone(setup, configs[:1], TUNER_EPOCHS, active)
    cube = torch.softmax(M[0], dim=-1).double().cpu().numpy()
    # each run's val score in float64 (every gene trains and validates)
    S = setup.S_dev.double().cpu().numpy()
    G = setup.G_dev.double().cpu().numpy()
    preds = np.einsum("rcs,cg->rsg", cube, S)
    cos = (preds * G).sum(axis=1) / (np.linalg.norm(preds, axis=1) * np.linalg.norm(G, axis=0))
    host = setup.metrics_row(cube, cos.mean(axis=1))
    errs = {k: abs(float(mets[k][0]) - host[k]) for k in tuning.METRIC_KEYS}
    say("tuner", f"(b) cube {tuple(cube.shape)} of config 0: device metrics against float64 "
        "host ones, |diff| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {TUNER_HOST_TOL:.0e})")
    if max(errs.values()) > TUNER_HOST_TOL:
        fail("tuner: (b) the device metrics stray from the host functions")
    diffs = {k: abs(float(mets[k][0]) - float(frame[k][0])) for k in tuning.METRIC_KEYS}
    say("tuner", "(d) config 0 alone against config 0 in the batch of "
        f"{TUNER_TRIALS}: |diff| " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
        + f" (tol {TUNER_BATCH_TOL:.0e})")
    if max(diffs.values()) > TUNER_BATCH_TOL:
        fail("tuner: (d) a config's metrics depend on its batch")


def tuner_against_fit_mapping(setup):
    """(c) the population trainer against fit_mapping(impl="reference") from
    each repeat's init, plain and with the three graph terms."""
    import types

    import torch

    from tangram_tpu_torch import tuning
    from tangram_tpu_torch.models.mapper import fit_mapping
    from tangram_tpu_torch.ops.losses import LossWeights, MapperData

    (S, G, d, mask, voxel_w, nb_filter, ct, spatial_w, getis_ref) = setup.arrays
    data = MapperData(S=S, G=G, gene_mask=mask, d=d, voxel_weights=voxel_w,
                      neighborhood_filter=nb_filter, ct_encode=ct,
                      spatial_weights=spatial_w, getis_ord_ref=getis_ref)
    base = {"learning_rate": 0.1, "lambda_g1": 1.0, "lambda_d": 0.5,
            "num_epochs": TUNER_CHECK_EPOCHS}
    for label, cfg in (("plain", base), ("graph", dict(base, **TUNER_GRAPH))):
        active = tuning._active_lambdas([cfg], setup.lam_keys)
        M, _ = train_alone(setup, [cfg], TUNER_CHECK_EPOCHS, active)
        lw = LossWeights(**{k: v for k, v in cfg.items() if k.startswith("lambda")})
        for r in range(setup.M0s.shape[0]):
            M_ref, _ = fit_mapping(setup.M0s[r].clone(), data, lw, TUNER_CHECK_EPOCHS,
                                   learning_rate=0.1, impl="reference")
            m_err = float((M[0, r] - M_ref).abs().max())
            p_err = float((torch.softmax(M[0, r], -1) - torch.softmax(M_ref, -1)).abs().max())
            limit, rule = M_ATOL, f"{M_ATOL:.0e}"
            if label == "graph":
                spread = permuted_reference_distance(
                    types.SimpleNamespace(M=setup.M0s[r], data=data), lw, M_ref,
                    epochs=TUNER_CHECK_EPOCHS)
                if m_err > M_ATOL:
                    limit = GRAPH_SPREAD * spread
                    rule = f"{GRAPH_SPREAD:.0f}x the permuted reference's {spread:.2e}"
                else:
                    rule += f"; the permuted reference lands {spread:.2e} from itself"
            say("tuner", f"(c) {label} config, repeat {r}, {TUNER_CHECK_EPOCHS} epochs: "
                f"logits max |diff| {m_err:.2e} against fit_mapping(impl='reference') "
                f"(tol {rule}), maps {p_err:.2e} (tol {MAP_ATOL:.0e})")
            if m_err > limit or p_err > MAP_ATOL:
                fail(f"tuner: (c) the population trainer strays from fit_mapping ({label})")


def tuner_graph_terms(dev, card, pair, setup):
    """(e) the three graph lambdas in the search space: the sweep, ms/step,
    and the share of the s x s products in the step's device time."""
    from tangram_tpu_torch import tuning

    config = {"learning_rate": tuning.loguniform(*TUNER_LR), "lambda_g1": 1.0,
              "lambda_d": tuning.uniform(0.0, 1.0), "num_epochs": TUNER_GRAPH_EPOCHS,
              **{k: tuning.uniform(0.0, 1.0) for k in TUNER_GRAPH}}
    np.random.seed(SEED)
    df, secs = cuda_seconds(lambda: tuner_frames(
        pair, metric=TUNER_METRIC, config=config, tuner_num_samples=TUNER_GRAPH_TRIALS,
        population_batch_size=TUNER_GRAPH_TRIALS, random_state=TUNER_SEED,
        cluster_label=TUNER_LABEL, device=dev))
    if not np.isfinite(df[tuning.METRIC_KEYS].to_numpy()).all():
        fail("tuner: (e) the graph sweep's metrics are not finite")
    active = tuning._space_active_lambdas(
        {k: tuning._coerce_domain(v) for k, v in config.items()}, setup.lam_keys)
    configs = [{k.split("/", 1)[1]: float(v) for k, v in row.items()}
               for row in df[[c for c in df.columns if c.startswith("config/")]]
               .to_dict("records")]
    ms = tuner_step_ms(setup, configs, active, TUNER_STEPS // 2)
    s = pair[1].n_obs
    prof = device_time_profile(
        lambda: train_alone(setup, configs, TUNER_PROFILE_STEPS, active),
        lambda shapes: any(len(sh) >= 2 and list(sh[-2:]) == [s, s] for sh in shapes))
    share_msg = ("not measured (the profiler saw no device time)" if prof is None else
                 f"{100 * prof['part'] / prof['total']:.1f}% ({prof['part']:.1f} of "
                 f"{profile_line(prof, TUNER_PROFILE_STEPS)}, torch.profiler)")
    say("tuner", f"(e) graph lambdas in the space: {TUNER_GRAPH_TRIALS} trials x "
        f"{TUNER_GRAPH_EPOCHS} epochs in {secs:.2f} s; {ms:.2f} ms/step for "
        f"{3 * TUNER_GRAPH_TRIALS} members; the dense {s} x {s} products {share_msg} ({card})")


def tuner_modes(dev, card, pair):
    """(f) adaptive, halving (carried state, then rungs restarted under a
    forced-down budget) and adaptive+halving: seconds, trained epochs, the
    best trial's metrics finite."""
    import collections

    import tangram_tpu_torch.utils as tutils
    from tangram_tpu_torch import tuning

    def run(label, search, trials, batch, epochs):
        config = {"learning_rate": tuning.loguniform(*TUNER_LR),
                  "lambda_d": tuning.uniform(0.0, 1.0), "lambda_g1": 1.0,
                  "num_epochs": epochs}
        np.random.seed(SEED)
        df, secs = cuda_seconds(lambda: tuner_frames(
            pair, metric=TUNER_METRIC, config=config, tuner_num_samples=trials,
            population_batch_size=batch, random_state=TUNER_SEED, search=search,
            cluster_label=TUNER_LABEL, device=dev))
        best = tuning.TunerResult(df).get_results().get_best_result(metric=TUNER_METRIC)
        if not np.isfinite([best.metrics[k] for k in tuning.METRIC_KEYS]).all():
            fail(f"tuner: (f) {label}: the best trial's metrics are not finite")
        trained = (dict(sorted(collections.Counter(df["trained_epochs"]).items()))
                   if "trained_epochs" in df else {epochs: trials})
        say("tuner", f"(f) {label}: {trials} trials (batches of {batch}), {epochs} epochs in "
            f"{secs:.2f} s; trials per trained epochs {trained}; best "
            f"{', '.join(f'{k} {best.metrics[k]:.4f}' for k in TUNER_METRIC)} ({card})")
        return df

    run("adaptive", "adaptive", *TUNER_ADAPTIVE)
    carried = run("halving, carried state", "halving", *TUNER_HALVING)
    budget = tutils.device_memory_budget
    tutils.device_memory_budget = lambda *a, **k: 1.0
    try:
        restarted = run("halving, rungs restarted (budget forced to 1 byte)", "halving",
                        *TUNER_HALVING)
    finally:
        tutils.device_memory_budget = budget
    same = np.array_equal(carried["trained_epochs"], restarted["trained_epochs"])
    both = carried["trained_epochs"] == TUNER_HALVING[2]
    diff = float(np.abs(carried.loc[both, tuning.METRIC_KEYS].to_numpy()
                        - restarted.loc[both, tuning.METRIC_KEYS].to_numpy()).max())
    say("tuner", f"(f) halving restarted against carried: survivors "
        f"{'the same' if same else 'DIFFER'}; finalists' metrics max |diff| {diff:.2e}")
    run("adaptive+halving", "adaptive+halving", *TUNER_BOHB)


def tuner_resume(dev, pair):
    """(g) a Sobol and an adaptive sweep journaled, cut to the meta line and
    the first batch, resumed: the frames equal the unbroken ones."""
    import os
    import tempfile

    import pandas as pd

    from tangram_tpu_torch import tuning

    trials, batch, epochs = TUNER_RESUME
    config = {"learning_rate": tuning.loguniform(*TUNER_LR), "lambda_g1": 1.0,
              "lambda_d": tuning.uniform(0.0, 1.0), "num_epochs": epochs}
    with tempfile.TemporaryDirectory() as tmp:
        for search in ("sobol", "adaptive"):
            path = os.path.join(tmp, f"{search}.jsonl")
            kw = dict(metric=TUNER_METRIC, config=config, tuner_num_samples=trials,
                      population_batch_size=batch, random_state=TUNER_SEED, search=search,
                      cluster_label=TUNER_LABEL, device=dev, resume_path=path)
            np.random.seed(SEED)
            full = tuner_frames(pair, **kw)
            with open(path) as f:
                lines = f.read().splitlines()
            with open(path, "w") as f:
                f.write("\n".join(lines[:1 + batch]) + "\n")
            np.random.seed(SEED)
            resumed, secs = cuda_seconds(lambda: tuner_frames(pair, **kw))
            try:
                pd.testing.assert_frame_equal(full, resumed, rtol=TUNER_RESUME_RTOL)
            except AssertionError as err:
                fail(f"tuner: (g) the resumed {search} sweep differs: {err}")
            say("tuner", f"(g) {search}: {len(lines) - 1} journaled trials cut to {batch}, "
                f"resumed in {secs:.2f} s; frames equal (rtol {TUNER_RESUME_RTOL:.0e})")


def tuner_phase(dev, card, ad_sc, ad_sp):
    """Phase 13: the hyperparameter tuner on the tutorial pair aggregated to
    its subclass means (module docstring)."""
    from tangram_tpu_torch.mapping import adata_to_cluster_expression
    from tangram_tpu_torch.ops import cuda_core

    t0 = time.perf_counter()
    before = dict(cuda_core.LAUNCHES)
    ad_cl = adata_to_cluster_expression(ad_sc, TUNER_LABEL, scale=False, add_density=False)
    pair = (ad_cl, ad_sp)
    np.random.seed(SEED)
    setup = tuner_setup(ad_cl, ad_sp, dev)
    frame, configs, active = tuner_sweep(dev, card, pair, setup)
    tuner_cube_and_batch(setup, frame, configs, active)
    tuner_against_fit_mapping(setup)
    tuner_graph_terms(dev, card, pair, setup)
    tuner_modes(dev, card, pair)
    tuner_resume(dev, pair)
    after = dict(cuda_core.LAUNCHES)
    say("tuner", f"(i) kernel launch counts before the phase {before}, after {after}")
    if after != before:
        fail("tuner: (i) the tuner launched a kernel")
    say("tuner", f"phase done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: one mapping over a mesh of processes (torch.distributed)
# ---------------------------------------------------------------------------

MESH_STEPS = 10          # the gloo ranks' fits and the bf16 autograd fit
MESH_WARM = 5            # steps left out of a fit's ms/step
#: gloo takes CUDA tensors for all_reduce (SUM, MAX), all_gather_into_tensor
#: and broadcast on the H100 machine (torch 2.11, checked there by part (b)
#: of this phase; PERF.md); where it does not, parts (b) and (e) are skipped
GLOO_TAKES_CUDA = True
# (d), (e): data parallelism over whole problems (cross_val and the tuner
# on a fold or trial axis); the LOO's 1000-epoch run is phase cv's
MESH_LOO_EPOCHS = 100
MESH_LOO_SPLIT = 248     # (e): 248 folds over a fold axis of 2, the last one whole
MESH_CV_TOL = 1e-5       # (e): JAX's test_cross_val_fold_mesh bound
#: (e): the cells-mode 10-fold CV at the tutorial shape on ("fold", "cell") = 1 x 2
MESH_CELLS_CV = dict(mode="cells", cv_mode="10fold", num_epochs=5, random_state=SEED,
                     fold_batch_size=2, verbose=False)
MESH_TUNER = (8, 100)    # (d), (e): sobol trials x epochs, in one batch
MESH_TUNER_TOL = 2e-3    # (e): JAX's test_tuner_trial_mesh bound


@contextlib.contextmanager
def timed_calls(owner, name, describe=None):
    """While the block runs, every call of ``owner.name`` (a function that
    the main path looks up there: a training loop's step, a batch's
    trainer) runs between two CUDA events. Yields the list of calls, each
    ``(start, stop, describe(*args))``; :func:`calls_ms` reads them."""
    import torch

    fn = getattr(owner, name)
    calls = []

    def timed(*args, **kwargs):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args, **kwargs)
        stop.record()
        calls.append((start, stop, describe(*args) if describe else None))
        return out

    setattr(owner, name, timed)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def calls_ms(calls):
    import torch

    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop, _ in calls]


def steady_ms(calls):
    """The median ms of a loop's steps after its first MESH_WARM."""
    return float(np.median(calls_ms(calls)[MESH_WARM:]))


def steady_period_ms(calls):
    """The median ms between the starts of consecutive calls of a function
    that a loop calls once a step (one step each), after MESH_WARM steps:
    the step time of a loop whose step is no one function."""
    import torch

    torch.cuda.synchronize()
    starts = [start for start, _, _ in calls]
    return float(np.median([a.elapsed_time(b) for a, b in zip(starts, starts[1:])][MESH_WARM:]))


def release_cached_memory():
    """Hand the blocks that earlier phases left in PyTorch's cache back to
    the card: NCCL allocates its own buffers (after the whole script it
    found the card full: "Failed to CUDA calloc async 608 bytes"), and the
    gloo ranks are other processes."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    say("mesh", f"device memory: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")


def mesh_world_of_one(dev, card, ad_sc, ad_sp, cells_mapper, norm_lw, pairs, directory):
    """(a) and (d) in a world of one NCCL rank. Returns (a)'s start logits
    and the single-device loop's MESH_STEPS-step logits, which (b) is held
    to, and (d)'s single-device results, which (e) is held to."""
    import torch.distributed as dist

    from tangram_tpu_torch import parallel as par

    par.init_distributed("file://" + os.path.join(directory, "nccl"), 1, 0)
    try:
        M0, M_steps = mesh_world_of_one_runs(dev, card, ad_sc, ad_sp, cells_mapper, norm_lw)
        return M0, M_steps, mesh_population_world_of_one(dev, card, pairs)
    finally:
        # an errored communicator left alive holds the process at exit
        # until NCCL's watchdog gives up (ten minutes)
        dist.destroy_process_group()


def mesh_world_of_one_runs(dev, card, ad_sc, ad_sp, cells_mapper, norm_lw):
    """(a) Mapper(mesh=make_mesh(1, 1)).train (Adam) and
    fit_mapping_fused_sharded on a ("cell",) mesh with L1/L2, each against
    the single-device fused loop from the same logits, bit for bit; launch
    counts, ms/step (CUDA events around each step) and peak memory."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from tangram_tpu_torch import parallel as par
    from tangram_tpu_torch.models import mapper as mapper_mod
    from tangram_tpu_torch.models.mapper import fit_mapping
    from tangram_tpu_torch.ops import cuda_core
    from tangram_tpu_torch.parallel import fused_sharded

    say("mesh", f"(a) process group: backend {dist.get_backend()}, world size "
        f"{dist.get_world_size()}, torch {torch.__version__}")
    meshes = {"make_mesh(1, 1)": par.make_mesh(1, 1),
              '("cell",)': DeviceMesh(dev.type, torch.arange(1), mesh_dim_names=("cell",))}
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh_mapper = mapper_for(ad_sc, ad_sp, dev, "cells", mesh=meshes["make_mesh(1, 1)"])
    M0 = mesh_mapper.M.clone()
    if not torch.equal(M0, cells_mapper.M.cpu()):
        fail("mesh: (a) the mesh mapper's start differs from the single-device mapper's")
    cuda_core.reset_launches()
    with timed_calls(fused_sharded, "_step") as steps:
        _, hist = mesh_mapper.train(EPOCHS, print_each=None)
    check_launches("mesh", {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS,
                            "dm_adam": EPOCHS})
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    main = np.asarray(hist["main_loss"])
    if not (np.isfinite(main).all() and main[-1] > main[0]):
        fail(f"mesh: (a) the mesh mapper's score did not rise ({main[0]} -> {main[-1]})")
    runs = {"make_mesh(1, 1)": (cells_mapper.lw, mesh_mapper.M, steady_ms(steps))}
    cuda_core.reset_launches()
    with timed_calls(fused_sharded, "_step") as steps:
        M_cell = par.fit_mapping_fused_sharded(M0, cells_mapper.data, norm_lw, EPOCHS, 0.1,
                                               mesh=meshes['("cell",)'])[0]
    check_launches("mesh", {"rowstats_norms": 1, "project": EPOCHS, "rbar": EPOCHS,
                            "dm_adam": EPOCHS})
    runs['("cell",)'] = (norm_lw, M_cell, steady_ms(steps))
    for label, (lw, M_mesh, ms_mesh) in runs.items():
        with timed_calls(mapper_mod, "fused_unconstrained_step") as steps:
            M_one = fit_mapping(start_params(cells_mapper)[0], cells_mapper.data, lw, EPOCHS,
                                impl="kernels")[0].cpu()
        same = torch.equal(M_mesh, M_one)
        say("mesh", f"(a) {label}{' + L1/L2' if lw.lambda_l1 else ''}, {EPOCHS} epochs: "
            f"{'the same bits as' if same else 'NOT the same bits as'} the single-device "
            f"fused loop (max |dM| {float((M_mesh - M_one).abs().max()):.2e}); ms/step "
            f"{ms_mesh:.3f} on the mesh, {steady_ms(steps):.3f} on one device (median of "
            f"steps {MESH_WARM + 1}-{EPOCHS}, CUDA events around each step) ({card})")
        if not same:
            fail(f"mesh: (a) {label}: the world-of-one mesh fit differs from one device")
    say("mesh", f"(a) peak device memory of the mesh mapper's training {peak:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB resident ({card})")
    M_steps = fit_mapping(start_params(cells_mapper)[0], cells_mapper.data, cells_mapper.lw,
                          MESH_STEPS, impl="kernels")[0].cpu()
    return M0, M_steps


def population_pairs(ad_sc, ad_sp):
    """The inputs of (d) and (e): the LOO fixture, the tutorial pair and
    phase tuner's 22-subclass pair."""
    from tangram_tpu_torch.mapping import adata_to_cluster_expression

    ad_cl = adata_to_cluster_expression(ad_sc, TUNER_LABEL, scale=False, add_density=False)
    return {"loo": loo_pair(), "tutorial": (ad_sc, ad_sp), "tuner": (ad_cl, ad_sp)}


def loo_kw(fold_batch_size):
    return dict(LOO_KW, num_epochs=MESH_LOO_EPOCHS, fold_batch_size=fold_batch_size,
                return_gene_pred=True, verbose=False)


def mesh_tuner_kw():
    from tangram_tpu_torch import tuning

    trials, epochs = MESH_TUNER
    config = {"learning_rate": tuning.loguniform(*TUNER_LR),
              "lambda_d": tuning.uniform(0.0, 1.0), "num_epochs": epochs}
    return dict(metric=TUNER_METRIC, config=config, tuner_num_samples=trials,
                population_batch_size=trials, random_state=TUNER_SEED,
                cluster_label=TUNER_LABEL)


def fold_shapes(params0, data, masks, *args, **kwargs):
    """(folds, cells) that a call of the fold trainer was handed."""
    M0 = params0[0] if isinstance(params0, tuple) else params0
    return int(masks.shape[0]), int(M0.shape[0])


def population_shapes(setup, lam_mat, lr_peaks, lr_ends, M, *args, **kwargs):
    """(configs, cells) that a call of the population trainer was handed."""
    return int(M.shape[0]), int(M.shape[2])


def mesh_population_world_of_one(dev, card, pairs):
    """(d) the batched LOO (clusters, MESH_LOO_EPOCHS epochs, every fold in
    one batch) on a ("fold", "cell") mesh of 1 x 1 and the sobol tuner
    (MESH_TUNER) on a ("trial",) mesh of 1, each against the same call
    without a mesh: the same bits, and ms/step of both from CUDA events at
    each step (the fold trainer's one call of adam_scalars a step, the
    population trainer's one call of _tuner_loss). Returns the
    single-device results."""
    from torch.distributed.device_mesh import DeviceMesh

    import tangram_tpu_torch as tgt
    from tangram_tpu_torch import evaluation, tuning
    from tangram_tpu_torch.ops import fused_step

    meshes = {"loo": DeviceMesh(dev.type, [[0]], mesh_dim_names=("fold", "cell")),
              "tuner": DeviceMesh(dev.type, [0], mesh_dim_names=("trial",))}
    runs = {}
    for label, mesh in (("one device", None), ("mesh", meshes["loo"])):
        with timed_calls(evaluation, "_fit_folds", fold_shapes) as calls, \
                timed_calls(fused_step, "adam_scalars") as steps:
            (cv, ge, df), secs = cuda_seconds(lambda: tgt.cross_val(
                *pairs["loo"], device=dev, mesh=mesh, **loo_kw(LOO_PAIR[2])))
        runs[label] = dict(cv=cv, X=np.asarray(ge.X), scores=df["score"].to_numpy(),
                           secs=secs, ms=steady_period_ms(steps),
                           calls=[c[2] for c in calls])
    one, mesh = runs["one device"], runs["mesh"]
    same = (np.array_equal(one["scores"], mesh["scores"]) and np.array_equal(one["X"], mesh["X"])
            and one["cv"] == mesh["cv"])
    say("mesh", f"(d) batched LOO, {LOO_PAIR[2]} folds x {MESH_LOO_EPOCHS} epochs in one batch "
        f"at 22 x {LOO_PAIR[1]} x {LOO_PAIR[2]}: on (\"fold\", \"cell\") = 1 x 1 "
        f"{'the same bits as' if same else 'NOT the same bits as'} without a mesh (every "
        f"fold's score and prediction; max |diff| "
        f"{float(np.abs(one['scores'] - mesh['scores']).max()):.2e}); the fold trainer "
        f"handed {mesh['calls']} (folds, cells); {mesh['ms']:.3f} ms/step on the mesh, "
        f"{one['ms']:.3f} without (median of steps {MESH_WARM + 2}-{MESH_LOO_EPOCHS}, CUDA "
        f"events at each step); "
        f"{mesh['secs']:.2f} s and {one['secs']:.2f} s in all; avg test score "
        f"{one['cv']['avg_test_score']:.5f} ({card})")
    if not same:
        fail("mesh: (d) the LOO on a world-of-one mesh differs from one device")

    frames = {}
    for label, mesh in (("one device", None), ("mesh", meshes["tuner"])):
        np.random.seed(SEED)
        with timed_calls(tuning._PopulationSetup, "_train", population_shapes) as calls, \
                timed_calls(tuning, "_tuner_loss") as steps:
            df, secs = cuda_seconds(lambda: tuner_frames(pairs["tuner"], device=dev, mesh=mesh,
                                                         **mesh_tuner_kw()))
        frames[label] = dict(df=df, secs=secs, ms=steady_period_ms(steps),
                             calls=[c[2] for c in calls])
    one, mesh = frames["one device"], frames["mesh"]
    same = all(np.array_equal(one["df"][c].to_numpy(), mesh["df"][c].to_numpy())
               for c in one["df"].columns) and list(one["df"].columns) == list(mesh["df"].columns)
    say("mesh", f"(d) sobol tuner, {MESH_TUNER[0]} trials x {tuning.N_REPEATS} repeats x "
        f"{MESH_TUNER[1]} epochs in one batch at 22 x {LOO_PAIR[1]} x {LOO_PAIR[2]}: on "
        f"(\"trial\",) = 1 {'the same bits as' if same else 'NOT the same bits as'} without a "
        f"mesh (every metric of every trial); the population trainer handed {mesh['calls']} "
        f"(configs, cells); {mesh['ms']:.3f} ms/step on the mesh, {one['ms']:.3f} without "
        f"(median of steps {MESH_WARM + 2}-{MESH_TUNER[1]}, CUDA events at each step); "
        f"{mesh['secs']:.2f} s and "
        f"{one['secs']:.2f} s in all ({card})")
    if not same:
        fail("mesh: (d) the tuner on a world-of-one mesh differs from one device")
    return {"loo": runs["one device"], "tuner": frames["one device"]["df"]}


def mesh_gloo_worker(rank, directory, device="cuda"):
    """One of two gloo ranks on the one card: the fused sharded fit on a
    ("cell",) mesh of 2 and a ("cell", "spot") mesh of 1 x 2, MESH_STEPS
    steps each from the logits and data that the parent saved; rank 0
    saves the mappings, seconds, ms/step and launch counts."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(REPO))
    from tangram_tpu_torch import parallel as par
    from tangram_tpu_torch.ops import cuda_core
    from tangram_tpu_torch.ops.losses import LossWeights, MapperData
    from tangram_tpu_torch.parallel import fused_sharded

    torch.cuda.set_device(0)
    par.init_distributed("file://" + os.path.join(directory, "gloo"), 2, rank,
                         backend="gloo")
    arrays = np.load(os.path.join(directory, "data.npz"))
    data = MapperData(**{k: torch.from_numpy(arrays[k]).to(device) for k in ("S", "G", "d")})
    lw = LossWeights(**json.loads(str(arrays["lw"])))
    M0 = torch.from_numpy(np.load(os.path.join(directory, "M0.npy"), mmap_mode="r")[:])
    kind = torch.device(device).type
    meshes = {'("cell",) = 2': DeviceMesh(kind, torch.arange(2), mesh_dim_names=("cell",)),
              '("cell", "spot") = 1 x 2': DeviceMesh(kind, torch.arange(2).reshape(1, 2),
                                                     mesh_dim_names=("cell", "spot"))}
    for i, (label, mesh) in enumerate(meshes.items()):
        cuda_core.reset_launches()
        t0 = time.perf_counter()
        with timed_calls(fused_sharded, "_step") as steps:
            M = par.fit_mapping_fused_sharded(M0, data, lw, MESH_STEPS, 0.1, mesh=mesh)[0]
        secs = time.perf_counter() - t0
        launches = dict(cuda_core.LAUNCHES)
        # the median of the steps after the first two
        ms = float(np.median(calls_ms(steps)[2:]))
        if rank == 0:
            np.save(os.path.join(directory, f"M_{i}.npy"), M.numpy())
            with open(os.path.join(directory, f"run_{i}.json"), "w") as f:
                json.dump({"label": label, "secs": secs, "ms": ms, "launches": launches}, f)
    end_worker()


def end_worker():
    """A spawned rank's end: every rank done, the process group destroyed,
    and an exit without the interpreter's teardown (a normal exit can abort
    in the teardown of the process group's threads, about one run in four
    on the CPU)."""
    import torch

    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def mesh_two_gloo_ranks(card, cells_mapper, M0, M_steps, directory):
    """(b) Two gloo ranks on the one card, MESH_STEPS steps on each mesh,
    held to the single-device loop's logits within M_ATOL (maps
    MAP_ATOL), the reference phase's tolerance over 10 steps."""
    import torch
    import torch.multiprocessing as mp

    release_cached_memory()
    data = cells_mapper.data
    np.save(os.path.join(directory, "M0.npy"), M0.numpy())
    np.savez(os.path.join(directory, "data.npz"), S=data.S.cpu().numpy(),
             G=data.G.cpu().numpy(), d=data.d.cpu().numpy(),
             lw=json.dumps(dataclasses.asdict(cells_mapper.lw)))
    t0 = time.perf_counter()
    mp.start_processes(mesh_gloo_worker, args=(directory,), nprocs=2, start_method="spawn")
    say("mesh", f"(b) two gloo ranks on the card in {time.perf_counter() - t0:.1f} s "
        "(process start, the data, the fits)")
    for i in range(2):
        with open(os.path.join(directory, f"run_{i}.json")) as f:
            run = json.load(f)
        M = torch.from_numpy(np.load(os.path.join(directory, f"M_{i}.npy")))
        dM = float((M - M_steps).abs().max())
        dP = float((torch.softmax(M, 1) - torch.softmax(M_steps, 1)).abs().max())
        expect = {"rowstats": 1, "project": MESH_STEPS, "rbar": MESH_STEPS,
                  "dm_adam": MESH_STEPS}
        say("mesh", f"(b) {run['label']}: {MESH_STEPS} steps in {run['secs']:.2f} s with "
            f"the block's upload and the gather, {run['ms']:.3f} ms/step (median of steps "
            f"3-{MESH_STEPS}, CUDA events around each step); rank 0's launches "
            f"{run['launches']}; against one device max |dM| {dM:.2e} (tol {M_ATOL:.0e}), "
            f"maps {dP:.2e} (tol {MAP_ATOL:.0e}) ({card})")
        if {k: v for k, v in run["launches"].items() if v} != expect:
            fail(f"mesh: (b) {run['label']}: rank 0 did not launch {expect}")
        if not (dM <= M_ATOL and dP <= MAP_ATOL):
            fail(f"mesh: (b) {run['label']}: two ranks and one device differ")


def mesh_bf16_autograd(card, cells_mapper):
    """(c) queue A4's leftover at the tutorial shape: MESH_STEPS steps of
    fit_mapping(fused=False) Adam on a bf16 M (optax's update in bf16)
    beside the same on f32, launch counts, ms/step and scores."""
    import torch

    from tangram_tpu_torch.models.mapper import fit_mapping
    from tangram_tpu_torch.ops import cuda_core

    out = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        M = cells_mapper.M.to(dtype)
        cuda_core.reset_launches()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        M, hist = fit_mapping(M, cells_mapper.data, cells_mapper.lw, MESH_STEPS,
                              impl="kernels", fused=False)
        stop.record()
        stop.synchronize()
        if M.dtype != dtype:
            fail(f"mesh: (c) the {label} M came back in {M.dtype}")
        suffix = ".bf16" if dtype == torch.bfloat16 else ""
        check_launches("mesh", {name + suffix: MESH_STEPS for name in (
            "rowstats", "project", "backward_rbar", "dm_backward")})
        out[label] = (start.elapsed_time(stop) / MESH_STEPS,
                      float(hist["main_loss"][-1].cpu()))
    (ms_b, score_b), (ms_f, score_f) = out["bf16"], out["f32"]
    say("mesh", f"(c) fused=False Adam, {MESH_STEPS} steps: bf16 M {ms_b:.2f} ms/step, "
        f"score {score_b:.4f}; f32 {ms_f:.2f} ms/step, score {score_f:.4f} (|diff| "
        f"{abs(score_b - score_f):.2e}, tol {BF16_SCORE_TOL:.0e}) ({card})")
    if not abs(score_b - score_f) <= BF16_SCORE_TOL:
        fail("mesh: (c) the bf16 autograd loop's score is not within tolerance of f32's")


def mesh_population_worker(rank, directory, device="cuda"):
    """(e) one of two gloo ranks on the one card: the LOO of (d) on
    ("fold",) = 2, the cells-mode 10-fold CV at the tutorial shape on
    ("fold", "cell") = 1 x 2 with its peak memory, and the tuner of (d) on
    ("trial",) = 2; each rank saves what it returned and what its trainers
    were handed."""
    import pickle

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(REPO))
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch import evaluation, tuning
    from tangram_tpu_torch import parallel as par

    torch.cuda.set_device(0)
    dev = torch.device(device)
    par.init_distributed("file://" + os.path.join(directory, "gloo_population"), 2, rank,
                         backend="gloo")
    with open(os.path.join(directory, "pairs.pkl"), "rb") as f:
        pairs = pickle.load(f)
    out = {}
    mesh = DeviceMesh(dev.type, torch.arange(2), mesh_dim_names=("fold",))
    with timed_calls(evaluation, "_fit_folds", fold_shapes) as calls:
        _, ge, df = tgt.cross_val(*pairs["loo"], device=dev, mesh=mesh,
                                  **loo_kw(MESH_LOO_SPLIT))
    out["loo"] = dict(scores=df["score"].to_numpy(), X=np.asarray(ge.X),
                      calls=[c[2] for c in calls])
    mesh = DeviceMesh(dev.type, torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("fold", "cell"))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with timed_calls(evaluation, "_fit_folds", fold_shapes) as calls:
        cv = tgt.cross_val(*pairs["tutorial"], device=dev, mesh=mesh, **MESH_CELLS_CV)
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["cells"] = dict(cv=cv, calls=[c[2] for c in calls])
    mesh = DeviceMesh(dev.type, torch.arange(2), mesh_dim_names=("trial",))
    np.random.seed(SEED)
    with timed_calls(tuning._PopulationSetup, "_train", population_shapes) as calls:
        df = tuner_frames(pairs["tuner"], device=dev, mesh=mesh, **mesh_tuner_kw())
    out["tuner"] = dict(df=df, calls=[c[2] for c in calls])
    with open(os.path.join(directory, f"population_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    end_worker()


def same_results(a, b) -> bool:
    """Two ranks' results of (e), bit for bit."""
    import pandas as pd

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_results(a[k], b[k]) for k in a)
    if isinstance(a, pd.DataFrame):
        return list(a.columns) == list(b.columns) and all(
            np.array_equal(a[c].to_numpy(), b[c].to_numpy()) for c in a.columns)
    return bool(np.array_equal(a, b))


def mesh_population_two_gloo_ranks(dev, card, pairs, single, directory):
    """(e) Two gloo ranks on the one card (mesh_population_worker), held to
    one device: the LOO's scores within MESH_CV_TOL of (d)'s, the cells CV's
    within MESH_CV_TOL of the same CV run here on one device, each rank's
    peak beside that run's, the tuner's metrics within MESH_TUNER_TOL of
    (d)'s; both ranks the same results, and the batches split as laid out."""
    import pickle

    import torch.multiprocessing as mp

    import tangram_tpu_torch as tgt
    from tangram_tpu_torch import evaluation, tuning

    with device_peak() as peak, timed_calls(evaluation, "_fit_folds", fold_shapes) as calls:
        one_cells = tgt.cross_val(*pairs["tutorial"], device=dev, **MESH_CELLS_CV)
    one_calls = [c[2] for c in calls]
    release_cached_memory()
    with open(os.path.join(directory, "pairs.pkl"), "wb") as f:
        pickle.dump(pairs, f)
    t0 = time.perf_counter()
    mp.start_processes(mesh_population_worker, args=(directory,), nprocs=2,
                       start_method="spawn")
    secs = time.perf_counter() - t0
    ranks = []
    for rank in range(2):
        with open(os.path.join(directory, f"population_{rank}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    got = ranks[0]
    alike = same_results(*({k: v for k, v in r.items() if k != "peak"} for r in ranks))
    n_folds, split = LOO_PAIR[2], MESH_LOO_SPLIT
    n_types = pairs["loo"][0].obs[LOO_KW["cluster_label"]].nunique()
    batch = MESH_CELLS_CV["fold_batch_size"]
    want_calls = {"loo": [(split // 2, n_types), (n_folds - split, n_types)],
                  "cells": [(batch, SHAPE[0] // 2)] * (10 // batch),
                  "tuner": [(MESH_TUNER[0] // 2, pairs["tuner"][0].n_obs)]}
    d_loo = float(np.abs(got["loo"]["scores"] - single["loo"]["scores"]).max())
    d_cells = max(abs(got["cells"]["cv"][k] - one_cells[k]) for k in one_cells)
    keys = tuning.METRIC_KEYS
    d_tuner = float(np.abs(got["tuner"]["df"][keys].to_numpy()
                           - single["tuner"][keys].to_numpy()).max())
    say("mesh", f"(e) two gloo ranks on the card in {secs:.1f} s (process start, the data, "
        f"the three runs); every result {'the same' if alike else 'NOT the same'} on both "
        "ranks; the trainers handed (members, cells) " + ", ".join(
            f"{k} {got[k]['calls']}" for k in want_calls) + f" ({card})")
    say("mesh", f"(e) LOO on (\"fold\",) = 2, batches of {split} (split) and "
        f"{n_folds - split} (whole): per-fold scores max |diff| {d_loo:.2e} from (d)'s one "
        f"device (tol {MESH_CV_TOL:.0e})")
    say("mesh", f"(e) cells 10-fold CV at {SHAPE}, {MESH_CELLS_CV['num_epochs']} epochs, "
        f"batches of {MESH_CELLS_CV['fold_batch_size']}, on (\"fold\", \"cell\") = 1 x 2: "
        f"scores {got['cells']['cv']} against one device's {one_cells} (max |diff| "
        f"{d_cells:.2e}, tol {MESH_CV_TOL:.0e}); peak device memory above the resident: rank "
        f"0 {ranks[0]['peak'] / 2**30:.3f} GiB, rank 1 {ranks[1]['peak'] / 2**30:.3f} GiB, "
        f"one device {peak['gib']:.3f} GiB "
        f"(handed {one_calls}) ({card})")
    say("mesh", f"(e) tuner on (\"trial\",) = 2: metrics max |diff| {d_tuner:.2e} from (d)'s "
        f"one device (tol {MESH_TUNER_TOL:.0e})")
    problems = []
    if not alike:
        problems.append("the two ranks returned different results")
    if {k: got[k]["calls"] for k in want_calls} != want_calls:
        problems.append(f"the trainers were not handed {want_calls}")
    if not (d_loo <= MESH_CV_TOL and d_cells <= MESH_CV_TOL):
        problems.append("a cross-validation on two ranks differs from one device")
    if not d_tuner <= MESH_TUNER_TOL:
        problems.append("the tuner on two ranks differs from one device")
    if problems:
        fail("mesh: (e) " + "; ".join(problems))


def mesh_phase(dev, card, ad_sc, ad_sp, cells_mapper, norm_lw):
    """Phase 14: training over a mesh (module docstring)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    release_cached_memory()
    pairs = population_pairs(ad_sc, ad_sp)
    directory = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        M0, M_steps, single = mesh_world_of_one(dev, card, ad_sc, ad_sp, cells_mapper,
                                                norm_lw, pairs, directory)
        mesh_bf16_autograd(card, cells_mapper)
        if GLOO_TAKES_CUDA:
            mesh_two_gloo_ranks(card, cells_mapper, M0, M_steps, directory)
            mesh_population_two_gloo_ranks(dev, card, pairs, single, directory)
        else:
            say("mesh", "(b), (e) skipped: gloo does not take CUDA tensors for all_reduce "
                "and all_gather_into_tensor on this card (PERF.md)")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    say("mesh", f"phase done in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--shapes", default=",".join(KERNEL_SHAPES),
                    help="the kernel phase's shapes, a subset of "
                    + ",".join(KERNEL_SHAPES) + " (times come from tutorial)")
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of 5 fused steps and the "
                    "phase shares of the tensor-core kernels (a second build)")
    ap.add_argument("--fit-bits", type=int, metavar="EPOCHS",
                    help="print the hashes of the cells mapper's fits and exit: "
                    "the child process of the bf16 phase's cross-process check")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    shapes = [p for p in args.shapes.split(",") if p]
    if set(shapes) - set(KERNEL_SHAPES):
        ap.error(f"unknown shapes {sorted(set(shapes) - set(KERNEL_SHAPES))}")

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
    if args.fit_bits:
        return fit_bits_child(args.fit_bits)
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
        for key in shapes:
            shape = KERNEL_SHAPES[key]
            t0 = time.perf_counter()
            if shape == SHAPE:
                compare_kernels(shape, dev, results, timed=True)
                compare_bf16_kernels(shape, dev, results, timed=True)
            else:
                with guarded_allocations(dev, shape):
                    compare_kernels(shape, dev, results, timed=False)
                    compare_bf16_kernels(shape, dev, results, timed=False)
                    check_repeatable(shape, dev)
            say("kernels", f"{shape} checked in {time.perf_counter() - t0:.1f} s")
        for name, r in results.items():
            if "ms" in r:
                bound, by, pipe = bound_ms(name, SHAPE)
                say("kernels", f"{name}: kernel {r['ms']:.3f} ms, twin "
                    f"{r['plain_ms']:.3f} ms, bound {bound:.3f} ms ({by}: {pipe}) at "
                    f"{SHAPE} ({card})")
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        say("kernels", f"the dP tile (rbar, gsq, dm_adam, dm_adafactor) at {SHAPE}: "
            f"{cuda_core.dp_splits(*SHAPE[:2], sm_count)} spot splits per 64-cell group; "
            f"their A and dY operands move {dp_l2_bytes(*SHAPE, sm_count) / 1e9:.2f} GB "
            f"through L2 per launch, gsq's with its column partial "
            f"{dp_l2_bytes(*SHAPE, sm_count, gsq=True) / 1e9:.2f} GB, as reckoned from "
            f"the tile shape")
        say("kernels", f"project at {SHAPE}: "
            f"{cuda_core.project_splits(*SHAPE, sm_count)} cell splits of "
            f"{math.ceil(SHAPE[1] / 64)} spot tiles; [A | w] moves "
            f"{project_l2_bytes(*SHAPE) / 1e9:.2f} GB through L2 per launch, as reckoned "
            f"from the tile shape")

    if {"cells", "clusters", "adafactor", "constrained", "bf16", "reference", "spatial",
            "cv", "downstream", "tuner", "mesh"} & set(phases):
        ad_sc, ad_sp, secs = tutorial_pair()
        say("cells", f"synthetic pair {SHAPE} + pp_adatas in {secs:.1f} s")
        cells_mapper = mapper_for(ad_sc, ad_sp, dev, "cells")
        norm_lw = dataclasses.replace(cells_mapper.lw, lambda_l1=LAMBDA_L1,
                                      lambda_l2=LAMBDA_L2)
    peaks, f32_runs, con_mapper = {}, {}, None

    if "cells" in phases:
        import tangram_tpu_torch as tgt

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(
            ad_sc, ad_sp, density_prior="rna_count_based", num_epochs=EPOCHS,
            random_state=SEED, **CELLS)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        launches = check_launches(
            "cells", {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS,
                      "dm_adam": EPOCHS})
        peaks["adam"] = torch.cuda.max_memory_allocated()
        check_mapping("cells", ad_map, SHAPE[0], SHAPE[1], SHAPE[2])
        baseline(f32_runs, CELLS).update(
            main=final_score(ad_map), secs=t_map, peak=(peaks["adam"] - base) / 2**30)
        t0 = time.perf_counter()
        ad_ge = tgt.project_genes(ad_map, ad_sc)
        report = tgt.compare_spatial_geneexp(ad_ge, ad_sp, ad_sc)
        t_eval = time.perf_counter() - t0
        if ad_ge.X.shape != (SHAPE[1], SHAPE[2]) or not np.isfinite(report["score"]).all():
            fail("cells: project_genes / compare_spatial_geneexp output is wrong")
        say("cells", f"map_cells_to_space {t_map:.2f} s for {EPOCHS} epochs; "
            f"project_genes + compare_spatial_geneexp {t_eval:.2f} s; median "
            f"gene score {float(report['score'].median()):.4f}; peak device "
            f"memory of the mapping {peaks['adam'] / 2**30:.3f} GiB ({card})")
        del ad_map, ad_ge

    if "clusters" in phases:
        import tangram_tpu_torch as tgt

        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(
            ad_sc, ad_sp, mode="clusters", cluster_label="subclass_label",
            num_epochs=EPOCHS, random_state=SEED)
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

    if "adafactor" in phases:
        import tangram_tpu_torch as tgt

        g_soft, g_norm = norm_gradient_ratio(cells_mapper)
        say("adafactor", f"lambda_l1={LAMBDA_L1:g}, lambda_l2={LAMBDA_L2:g}: mean "
            f"|L1/L2 gradient| {g_norm:.3e} against mean |softmax gradient| "
            f"{g_soft:.3e} at the start (ratio {g_norm / g_soft:.2f})")
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(
            ad_sc, ad_sp, density_prior="rna_count_based", num_epochs=EPOCHS,
            random_state=SEED, **CELLS_ADAFACTOR_NORMS)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        counts = check_launches(
            "adafactor", {"rowstats_norms": 1, "project": EPOCHS, "rbar": EPOCHS,
                          "gsq": EPOCHS, "dm_adafactor": EPOCHS})
        peaks["adafactor"] = torch.cuda.max_memory_allocated()
        launches = dict(launches or {}, **{k: counts[k] for k in ADAFACTOR_KERNELS})
        # not required to rise: at this shape Adafactor at the default
        # learning rate 0.1 (no momentum, no update clipping) lowers the
        # gene-voxel score, in the reference loop as in the kernels
        check_mapping("adafactor", ad_map, SHAPE[0], SHAPE[1], SHAPE[2], rising=False)
        baseline(f32_runs, CELLS_ADAFACTOR_NORMS).update(
            main=final_score(ad_map), secs=t_map,
            peak=(peaks["adafactor"] - base) / 2**30)
        say("adafactor", f"cells + L1/L2: map_cells_to_space {t_map:.2f} s for "
            f"{EPOCHS} epochs; peak device memory of the mapping "
            f"{peaks['adafactor'] / 2**30:.3f} GiB ({card})")
        del ad_map

        cuda_core.reset_launches()
        t0 = time.perf_counter()
        ad_map = tgt.map_cells_to_space(
            ad_sc, ad_sp, mode="clusters", cluster_label="subclass_label",
            optimizer="adafactor", num_epochs=EPOCHS, random_state=SEED)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        check_launches("adafactor", {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS,
                                     "gsq": EPOCHS, "dm_adafactor": EPOCHS})
        n_clusters = ad_map.X.shape[0]
        check_mapping("adafactor", ad_map, n_clusters, SHAPE[1], SHAPE[2])
        say("adafactor", f"clusters ({n_clusters} < {SHAPE[1]} spots): {EPOCHS} "
            f"epochs in {t_map:.2f} s")
        del ad_map

        # step time, and the device memory that training adds to what is
        # resident (the logits, the optimizer state and the step's scratch)
        ms, train_gib = {}, {}
        for label, lw, opt in (("adam", cells_mapper.lw, "adam"),
                               ("adafactor", cells_mapper.lw, "adafactor"),
                               ("adafactor + L1/L2", norm_lw, "adafactor"),
                               ("adam + L1/L2", norm_lw, "adam")):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms[label] = step_ms(cells_mapper, "kernels", warm=5, steps=20, lw=lw,
                                optimizer=opt)
            train_gib[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
        for label, opts in (("adam", CELLS),
                            ("adafactor + L1/L2", CELLS_ADAFACTOR_NORMS)):
            baseline(f32_runs, opts).update(ms=ms[label], train=train_gib[label])
        say("adafactor", "steady-state ms/step at " + str(SHAPE) + ": " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms.items()) + f" ({card})")
        say("adafactor", "device memory a training run adds (logits, optimizer "
            "state, scratch), GiB: " + ", ".join(
                f"{k} {v:.3f}" for k, v in train_gib.items()) + f" ({card})")
        if "adam" in peaks:
            say("adafactor", f"peak device memory of map_cells_to_space: adam "
                f"{peaks['adam'] / 2**30:.3f} GiB, adafactor + L1/L2 "
                f"{peaks['adafactor'] / 2**30:.3f} GiB ({card})")

    if "constrained" in phases:
        import tangram_tpu_torch as tgt

        for opt, expect in (
                ("adam", {"rowstats": 1, "project": EPOCHS, "rbar": EPOCHS,
                          "dm_adam": EPOCHS}),
                ("adafactor", {"rowstats": EPOCHS, "project": EPOCHS,
                               "backward_rbar": EPOCHS, "dm_backward": EPOCHS})):
            gc.collect()  # what earlier phases left unreachable is not resident
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cuda_core.reset_launches()
            t0 = time.perf_counter()
            ad_map = tgt.map_cells_to_space(
                ad_sc, ad_sp, density_prior="rna_count_based", optimizer=opt,
                num_epochs=EPOCHS, random_state=SEED, **CONSTRAINED)
            torch.cuda.synchronize()
            t_map = time.perf_counter() - t0
            counts = check_launches("constrained", expect)
            peaks[f"constrained {opt}"] = torch.cuda.max_memory_allocated()
            if opt == "adafactor":
                launches = dict(launches or {}, **{k: counts[k] for k in BACKWARD_KERNELS})
            # Adafactor is not required to raise the score (queue C)
            check_mapping("constrained", ad_map, SHAPE[0], SHAPE[1], SHAPE[2],
                          rising=opt == "adam")
            if opt == "adam":
                baseline(f32_runs, CONSTRAINED).update(
                    main=final_score(ad_map), secs=t_map,
                    peak=(peaks["constrained adam"] - base) / 2**30)
            F_out = np.asarray(ad_map.obs["F_out"], dtype=np.float64)
            count_reg = np.asarray(ad_map.uns["training_history"]["count_reg"])
            if F_out.shape != (SHAPE[0],) or not ((F_out > 0) & (F_out < 1)).all():
                fail(f"constrained {opt}: F_out has shape {F_out.shape} or values "
                     "outside (0, 1)")
            if not np.isfinite(count_reg).all():
                fail(f"constrained {opt}: count_reg is not finite")
            say("constrained", f"{opt}: map_cells_to_space {t_map:.2f} s for {EPOCHS} "
                f"epochs; F_out in [{F_out.min():.4f}, {F_out.max():.4f}], sum "
                f"{F_out.sum():.1f} (target {SHAPE[1]}); count_reg {count_reg[0]:.1f} -> "
                f"{count_reg[-1]:.1f}; peak device memory "
                f"{peaks[f'constrained {opt}'] / 2**30:.3f} GiB, "
                f"{(peaks[f'constrained {opt}'] - base) / 2**30:.3f} GiB above the "
                f"{base / 2**30:.3f} GiB resident before ({card})")
            del ad_map
        # built after the runs above, so that their peaks hold one mapping
        con_mapper = mapper_for(ad_sc, ad_sp, dev, "constrained")
        ms_con = {}
        for opt in ("adam", "adafactor"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms_con[opt] = step_ms(con_mapper, "kernels", warm=3, steps=10, optimizer=opt)
            if opt == "adam":
                baseline(f32_runs, CONSTRAINED).update(
                    ms=ms_con[opt],
                    train=(torch.cuda.max_memory_allocated() - base) / 2**30)
        say("constrained", "steady-state ms/step at " + str(SHAPE) + ": " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms_con.items()) + f" ({card})")

    if "bf16" in phases:
        counts = bf16_phase(ad_sc, ad_sp, dev, card, cells_mapper, norm_lw, f32_runs,
                            con_mapper)
        launches = dict(launches or {}, **counts)
        con_mapper = con_mapper or mapper_for(ad_sc, ad_sp, dev, "constrained")
        check_fit_repeats(cells_mapper, norm_lw, con_mapper)

    if "reference" in phases:
        mapper = cells_mapper
        compare_with_reference(mapper, mapper.lw, "adam", "adam",
                               {"rowstats": 1, "project": 10, "rbar": 10, "dm_adam": 10})
        compare_with_reference(mapper, norm_lw, "adam", "adam + L1/L2",
                               {"rowstats_norms": 1, "project": 10, "rbar": 10,
                                "dm_adam": 10})
        compare_with_reference(mapper, norm_lw, "adafactor", "adafactor + L1/L2",
                               {"rowstats_norms": 1, "project": 10, "rbar": 10,
                                "gsq": 10, "dm_adafactor": 10})
        unfused = {"rowstats": 10, "project": 10, "backward_rbar": 10, "dm_backward": 10}
        compare_with_reference(mapper, mapper.lw, "adam", "adam fused=False", unfused,
                               fused=False)
        con_mapper = con_mapper or mapper_for(ad_sc, ad_sp, dev, "constrained")
        compare_with_reference(con_mapper, con_mapper.lw, "adam", "constrained adam",
                               {"rowstats": 1, "project": 10, "rbar": 10, "dm_adam": 10})
        compare_with_reference(con_mapper, con_mapper.lw, "adafactor",
                               "constrained adafactor", unfused)
        ms_k = step_ms(mapper, "kernels", warm=5, steps=20)
        ms_u = step_ms(mapper, "kernels", warm=3, steps=10, fused=False)
        ms_r = step_ms(mapper, "reference", warm=2, steps=10)
        say("reference", f"steady-state ms/step at {SHAPE}: kernels {ms_k:.2f}, "
            f"kernels with fused=False (MapperCore) {ms_u:.2f}, reference loop "
            f"{ms_r:.2f} ({card})")
        if args.profile:
            profile_steps(mapper)

    if "spatial" in phases:
        spatial_phase(dev, card, ad_sc, ad_sp, cells_mapper, args.profile)

    if "cv" in phases:
        cv_phase(dev, card, ad_sc, ad_sp, cells_mapper, args.profile)

    if "downstream" in phases:
        downstream_phase(dev, card, ad_sc, ad_sp, cells_mapper)

    if "tuner" in phases:
        tuner_phase(dev, card, ad_sc, ad_sp)

    if "mesh" in phases:
        mesh_phase(dev, card, ad_sc, ad_sp, cells_mapper, norm_lw)

    if args.profile:
        profile_dp_tile(dev)
    say("done", f"{time.perf_counter() - t_start:.1f} s in all")
    kernels = [
        {"name": name, "route": "cuda",
         "source": (TENSOR_SOURCE if name in TENSOR_KERNELS else
                    PROJECT_SOURCE if name in PROJECT_KERNELS else SOURCE),
         "replaces": REPLACES[name],
         # a kernel no training loop launches (the bf16-M backward) counts
         # its launches in the kernel phase's MapperCore run
         "launches": r.get("launches", None if launches is None else launches.get(name)),
         "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
         "plain_ms": r.get("plain_ms"), "bound_ms": bound_ms(name, SHAPE)[0],
         "bound_by": bound_ms(name, SHAPE)[1],
         # no one PyTorch call computes any of these functions (time_gemms
         # prints cuBLAS at the contraction shapes as a note)
         "library_ms": None}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    if list(phases) != list(PHASES) or shapes != list(KERNEL_SHAPES):
        say("done", "partial run: the ok line is printed only when every phase runs")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
