"""Hyperparameter tuning: a population search on the device.

Counterpart of ``tangram_tpu/tuning.py``, with its names, signatures,
defaults, result frames and errors. Reference behavior being reproduced
(``mapping_parameter_tuning.py``):
``mapping_hyperparameter_tuning(adata_sc, adata_sp, metric, config, ...)``
runs trials over a search space; each trial trains 3 seeded mappers
(``:109-131``) and reports 5 metrics (``:135-139``): three stability metrics
across the repeat runs (``pearson_corr`` ``:42``, ``vote_entropy`` ``:55``,
``consensus_entropy`` ``:71``), gene-expression consistency, and the
validation gene score.

The reference ships dense S/G to a Ray worker process per trial. Here the
loss takes its lambdas as tensors with one entry per population member, so
(config × repeat) populations train as ONE batched problem on the card: the
logits are a (members, cells, spots) tensor, the loss is written with that
leading axis, and Adam is written out with per-member moments and
learning rates. The core is the materialized one
(:func:`~tangram_tpu_torch.ops.core.mapper_core_reference`), as the JAX
tuner pins ``impl="xla"``: the tuner launches none of the port's kernels.
Its products run in f32 with TF32 off for the call, whatever the process
set. Sampling uses a scrambled Sobol sequence, TPE (:mod:`.search`) or
successive halving. On a mesh of processes the trials of a batch spread
over a trial axis and each member's cells over the other axes
(``mapping_hyperparameter_tuning(mesh=)``).
"""

from __future__ import annotations

import contextlib
import logging
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import pandas as pd
import torch

from . import spatial as sw
from .deconv import one_hot_encoding
from .utils import _SweepJournal

__all__ = [
    "uniform",
    "loguniform",
    "choice",
    "pearson_corr",
    "vote_entropy",
    "consensus_entropy",
    "train_multiple_Mapper",
    "mapping_hyperparameter_tuning",
    "TunerResult",
]

TUNABLE_KEYS = [
    "learning_rate",
    # extensions: searchable cosine lr schedule (lr_peak -> lr_end over
    # num_epochs); constant learning_rate remains the default behavior
    "lr_peak",
    "lr_end",
    "num_epochs",
    "lambda_d",
    "lambda_g1",
    "lambda_g2",
    "lambda_neighborhood_g1",
    "lambda_r",
    "lambda_l1",
    "lambda_l2",
    "lambda_ct_islands",
    "lambda_getis_ord",
]
METRIC_KEYS = [
    "cell_map_consistency",
    "cell_map_agreement",
    "cell_map_certainty",
    "gene_expr_consistency",
    "gene_expr_correctness",
]
N_REPEATS = 3  # seeded repeat runs per configuration (reference :109)


# ---------------------------------------------------------------------------
# search-space distributions (ray.tune-compatible duck types accepted too)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class uniform:
    low: float
    high: float

    def from_unit(self, u):
        return self.low + (self.high - self.low) * u


@dataclass(frozen=True)
class loguniform:
    low: float
    high: float

    def from_unit(self, u):
        return float(np.exp(np.log(self.low) + (np.log(self.high) - np.log(self.low)) * u))


@dataclass(frozen=True)
class choice:
    values: tuple

    def __init__(self, values):
        object.__setattr__(self, "values", tuple(values))

    def from_unit(self, u):
        return self.values[min(int(u * len(self.values)), len(self.values) - 1)]


def _coerce_domain(value):
    """Accept our dataclasses, plain constants, ray.tune domains, or optuna
    distributions.

    The reference's tuner takes a dict of ``ray.tune`` distributions
    (``mapping_parameter_tuning.py:14-22``); ray objects are accepted here
    structurally (``Float.lower/.upper`` with a log sampler carrying
    ``base``; ``Categorical.categories``), so a reference user's search-space
    dict works unchanged without ray installed. Optuna's
    ``FloatDistribution(.low/.high/.log)``, ``IntDistribution`` and
    ``CategoricalDistribution(.choices)`` are accepted the same way."""
    if isinstance(value, (uniform, loguniform, choice)):
        return value
    if isinstance(value, (int, float)):
        fixed = float(value)
        return uniform(fixed, fixed)
    cls = type(value).__name__.lower()
    if hasattr(value, "categories"):  # ray.tune.choice
        return choice(tuple(value.categories))
    if hasattr(value, "choices"):  # optuna CategoricalDistribution
        return choice(tuple(value.choices))
    if hasattr(value, "lower") and hasattr(value, "upper") and not isinstance(
        value, str
    ):
        # ray.tune.uniform / loguniform / quniform (Float/Integer domains)
        lo, hi = float(value.lower), float(value.upper)
        if "log" in cls or getattr(getattr(value, "sampler", None), "base", None):
            return loguniform(lo, hi)
        return uniform(lo, hi)
    if hasattr(value, "low") and hasattr(value, "high"):
        # optuna Float/Int distributions
        lo, hi = float(value.low), float(value.high)
        if getattr(value, "log", False) or "log" in cls:
            return loguniform(lo, hi)
        return uniform(lo, hi)
    raise ValueError(f"Unsupported search-space value: {value!r}")


# ---------------------------------------------------------------------------
# stability metrics (reference :42-82): numpy float64 on the host
# ---------------------------------------------------------------------------


def _normalized_entropy(probs):
    """Row entropy of a (cells, spots) stochastic matrix, normalized to
    [0, 1] by log(n_spots). Rows are renormalized first (scipy.stats.entropy
    semantics) and 0·log0 := 0."""
    row_sums = probs.sum(axis=-1, keepdims=True)
    p = np.divide(probs, row_sums, out=np.zeros_like(probs), where=row_sums > 0)
    plogp = np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0)
    return -plogp.sum(axis=-1) / np.log(probs.shape[-1])


def pearson_corr(cube):
    """Pairwise Pearson correlation of the flattened mapping matrices across
    the run axis (reference ``mapping_parameter_tuning.py:42-53`` reports the
    strict lower triangle of the run×run correlation matrix, pairs in
    row-major order: (1,0), (2,0), (2,1), ...).

    Computed as the gram matrix of the CENTERED rows in float64 (the mean
    from a BLAS gemv, the centering in place, cov = X̃·X̃ᵀ a BLAS gemm);
    centering before the gram avoids catastrophic cancellation for
    high-mean/low-variance input. A zero-variance run reports 0 correlation
    (np.corrcoef would emit NaN)."""
    p = cube.shape[0]
    flat = cube.reshape(p, -1).astype(np.float64)
    n = flat.shape[1]
    mean = (flat @ np.ones(n, dtype=np.float64)) / n
    flat -= mean[:, None]
    cov = flat @ flat.T
    var = np.maximum(np.diag(cov), 0.0)
    denom = np.sqrt(np.outer(var, var))
    i, j = np.tril_indices(p, -1)
    num, den = cov[i, j], denom[i, j]
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def vote_entropy(pred_probs_cube):
    """Disagreement of the runs' hard assignments (reference ``:55-69``):
    each run votes its argmax spot per cell; the entropy of the vote
    distribution, normalized by log(n_spots), is returned per cell."""
    n_runs, n_cells, n_spots = pred_probs_cube.shape
    votes = pred_probs_cube.argmax(axis=2)  # (runs, cells)
    vote_share = np.zeros((n_cells, n_spots))
    np.add.at(vote_share, (np.arange(n_cells)[None, :], votes), 1.0 / n_runs)
    return _normalized_entropy(vote_share)


def consensus_entropy(pred_probs_cube):
    """Peakedness of the run-averaged (consensus) mapping per cell,
    normalized by log(n_spots) (reference ``:71-82``)."""
    return _normalized_entropy(pred_probs_cube.mean(axis=0))


@contextlib.contextmanager
def _full_f32():
    """TF32 off for CUDA matmuls inside the block, restored after: the
    tuner's products (the core, the graph terms, the metrics' grams) feed
    rankings, and a TF32 product errs ~1e-3."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _device_metrics(Ps, val_sims, S_val, cell=None, n_cells=None):
    """The 5 reported metrics of repeat cubes, on the device (f32 analogues
    of :func:`pearson_corr`, :func:`vote_entropy`, :func:`consensus_entropy`
    + the masked-gene val score; the host functions remain the reference
    implementations the tests hold these to).

    Keeping the (runs × cells × spots) cubes on the device means only these
    5 scalars per trial cross to the host.

    ``Ps``: (..., runs, cells, spots) softmaxed maps. ``val_sims``:
    (..., runs). ``S_val``: (cells, n_val_genes). Each metric has the
    leading shape ``...`` (one value per config of a batch). On a cell
    block (``Ps``' and ``S_val``'s rows of ``n_cells``) every sum over
    cells is this rank's part, summed over the mesh axis ``cell``: the
    Pearson means and Gram, the vote and consensus entropies, and the gene
    cube S_valᵀP.
    """
    from .ops.axes import NO_AXIS, all_sum_

    cell = NO_AXIS if cell is None else cell
    n_cells = Ps.shape[-2] if n_cells is None else n_cells
    p = Ps.shape[-3]
    log_spots = math.log(Ps.shape[-1])
    tri_i, tri_j = np.tril_indices(p, -1)

    def pearson_mean(flat, axis, n):  # (..., p, this rank's entries of n)
        mean = all_sum_(flat.sum(dim=-1, keepdim=True), axis) / n
        centered = flat - mean
        gram = all_sum_(centered @ centered.transpose(-1, -2), axis)
        var = torch.clamp(torch.diagonal(gram, dim1=-2, dim2=-1), min=0.0)
        denom = torch.sqrt(var[..., :, None] * var[..., None, :])
        num, den = gram[..., tri_i, tri_j], denom[..., tri_i, tri_j]
        safe = torch.where(den > 0, den, torch.ones_like(den))
        return torch.where(den > 0, num / safe, torch.zeros_like(num)).mean(dim=-1)

    def cell_mean(x):  # over the last axis, the cells
        return all_sum_(x.sum(dim=-1), cell) / n_cells

    def norm_entropy_mean(probs):  # rows renormalized, 0·log0 := 0
        rs = probs.sum(dim=-1, keepdim=True)
        pr = torch.where(rs > 0, probs / torch.where(rs > 0, rs, torch.ones_like(rs)),
                         torch.zeros_like(probs))
        plogp = torch.where(pr > 0, pr * torch.log(torch.where(pr > 0, pr, torch.ones_like(pr))),
                            torch.zeros_like(pr))
        return cell_mean(-plogp.sum(dim=-1) / log_spots)

    # vote entropy: Σ over vote groups of −(m/p)·log(m/p) equals a sum over
    # MEMBERS of −(1/p)·log(cnt/p), where cnt is each member's group size —
    # computable from pairwise vote equality without a (cells × spots)
    # scatter
    votes = torch.argmax(Ps, dim=-1)  # (..., p, cells)
    eq = votes[..., :, None, :] == votes[..., None, :, :]  # (..., p, p, cells)
    cnt = eq.sum(dim=-2).to(torch.float32)  # (..., p, cells)
    vote_H = (-(1.0 / p) * torch.log(cnt / p)).sum(dim=-2) / log_spots

    gene_cube = all_sum_(S_val.T @ Ps, cell)  # (..., runs, val genes, spots)
    lead = Ps.shape[:-2]
    return {
        "cell_map_consistency": pearson_mean(Ps.reshape(*lead, -1), cell,
                                             n_cells * Ps.shape[-1]),
        "cell_map_agreement": 1.0 - cell_mean(vote_H),
        "cell_map_certainty": 1.0 - norm_entropy_mean(Ps.mean(dim=-3)),
        "gene_expr_consistency": pearson_mean(gene_cube.reshape(*lead, -1), NO_AXIS,
                                              gene_cube.shape[-2] * gene_cube.shape[-1]),
        "gene_expr_correctness": val_sims.mean(dim=-1),
    }


# ---------------------------------------------------------------------------
# the population loss: one value per member
# ---------------------------------------------------------------------------


def _tuner_loss(M, lam, data_arrays, active=None, cell=None, n_cells=None):
    """The tunable terms with per-member weights.

    ``M`` is (c, s) or a population (members, c, s); each value of ``lam``
    (keyed as ``TUNABLE_KEYS``' lambdas) is a number or a (members,) tensor.
    Returns ``(total, gv_sim)``, each a value per member (0-d for one M).
    Members are independent, so the gradient of ``total.sum()`` is each
    member's own gradient.

    Mathematically identical to :func:`tangram_tpu_torch.ops.losses.compute_loss`
    restricted to the tuner's whitelist (the tuner always builds every
    weight matrix, reference ``:250-255``), through the materialized core.
    The loss is written with the leading member axis rather than mapped by
    ``torch.func.vmap``: a graph product then is one dense (s × s) GEMM
    broadcast over the members, and one function serves a single mapping
    and the population alike.

    ``active`` (a set of λ keys, or None for "all") skips terms whose weight
    is zero across the WHOLE population: otherwise every member would pay
    the dense (spots × spots) W-products even when no spatial λ is in the
    search space. A zero λ makes the skipped term's value and gradient
    exactly zero, so the result is bit-comparable.

    On a cell block (M's, S's and ct_enc's rows of ``n_cells``) the sums
    over cells (Y, q, the entropy and the L1/L2 sums) are this rank's
    parts, summed over the mesh axis ``cell``; the graph terms act on
    spots, after Y is summed.
    """
    from .ops.core import graph_matmul, mapper_core_reference
    from .ops.losses import cosine_similarity, kl_div_sum
    from .ops.axes import NO_AXIS, sum_replicated

    cell = NO_AXIS if cell is None else cell
    (S, G, d, mask, voxel_w, nb_filter, ct_enc, spatial_w, getis_ref) = data_arrays
    if mask is not None:
        S = S * mask[None, :]
        G = G * mask[None, :]
    n_cells = M.shape[-2] if n_cells is None else n_cells

    A = torch.cat([S, ct_enc], dim=1)
    w = torch.full((M.shape[-2],), 1.0 / n_cells, dtype=M.dtype, device=M.device)
    Y, q, h = mapper_core_reference(M, A, w)
    Y, q = sum_replicated(Y, cell), sum_replicated(q, cell)
    G_pred = Y[..., : S.shape[1]]
    ct_map = Y[..., S.shape[1]:]

    def mmean(v):  # over genes, the last axis
        if mask is None:
            return torch.mean(v, dim=-1)
        return torch.sum(v * mask, dim=-1) / torch.sum(mask)

    def on(key):
        return active is None or key in active

    # spots are the second-to-last axis of every (..., spots, genes) array
    gv_sim = mmean(cosine_similarity(G_pred, G, axis=-2))
    vg_sim = torch.mean(cosine_similarity(G_pred, G, axis=-1), dim=-1)
    total = -(lam["lambda_g1"] * gv_sim + lam["lambda_g2"] * vg_sim)
    if on("lambda_d"):
        total = total + lam["lambda_d"] * kl_div_sum(torch.log(q), d)
    if on("lambda_r"):
        total = total + lam["lambda_r"] * -sum_replicated(torch.sum(h, dim=-1), cell)
    if on("lambda_l1"):
        total = total + lam["lambda_l1"] * sum_replicated(
            torch.sum(torch.abs(M), dim=(-2, -1)), cell)
    if on("lambda_l2"):
        total = total + lam["lambda_l2"] * sum_replicated(
            torch.sum(M * M, dim=(-2, -1)), cell)
    if on("lambda_ct_islands"):
        nb_ct = graph_matmul(nb_filter, ct_map)
        excess = ct_map - nb_ct
        ct_penalty = torch.mean(torch.maximum(excess, torch.zeros_like(excess)),
                                dim=(-2, -1))
        total = total + lam["lambda_ct_islands"] * ct_penalty
    if on("lambda_neighborhood_g1"):
        nb_sim = mmean(
            cosine_similarity(
                graph_matmul(voxel_w, G_pred), graph_matmul(voxel_w, G), axis=-2,
            )
        )
        total = total - lam["lambda_neighborhood_g1"] * nb_sim
    if on("lambda_getis_ord"):
        # A gene masked out of training has Σ G_pred = 0. The clamp passes no
        # gradient to a clamped sum, so that column adds nothing, as if it
        # were dropped; JAX's jnp.maximum passes 0 · (−0 / 1e-60), NaN, which
        # poisons every member of the population, λ = 0 ones too (ROADMAP
        # queue C, tests/test_torch_tuning.py pins both).
        getis_pred = graph_matmul(spatial_w, G_pred) / torch.clamp(
            torch.sum(G_pred, dim=-2, keepdim=True), min=1e-30
        )
        getis_sim = mmean(cosine_similarity(getis_ref, getis_pred, axis=-2))
        total = total - lam["lambda_getis_ord"] * getis_sim
    return total, gv_sim


def _active_lambdas(configs, lam_keys) -> frozenset:
    """λ keys with a nonzero value in ANY of the population's configs —
    everything else is statically zero and its term can be skipped
    (value and gradient exactly zero either way)."""
    return frozenset(
        k for k in lam_keys
        if any(float(cfg.get(k, 0.0)) != 0.0 for cfg in configs)
    )


def _space_active_lambdas(domains, lam_keys) -> frozenset:
    """λ keys that CAN be nonzero under the search space: any distribution
    counts (except a ``choice`` whose values are all zero), a fixed value
    by its literal, anything unrecognized conservatively counts. Derived
    once per tuner call, so that the active set — and the trainer cached
    for it — is stable across adaptive ask/tell rounds instead of flapping
    with each round's sampled values."""
    active = set()
    for k in lam_keys:
        v = domains.get(k, 0.0)
        if isinstance(v, choice):
            if any(float(x) != 0.0 for x in v.values):
                active.add(k)
        elif isinstance(v, uniform):
            # _coerce_domain renders a FIXED value as uniform(x, x), so a
            # pinned 0.0 arrives here as uniform(0, 0) — inactive
            if float(v.low) != 0.0 or float(v.high) != 0.0:
                active.add(k)
        elif isinstance(v, loguniform):
            active.add(k)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            if float(v) != 0.0:
                active.add(k)
        else:
            active.add(k)
    return frozenset(active)


def train_multiple_Mapper(config, data):
    """Train N_REPEATS seeded mappers for one config and report the 5 metrics
    (reference ``:86-139``). Kept for API parity; the batched population path
    below is what the tuner itself uses. The ``device`` of ``data`` is
    resolved as everywhere in the port: None means the card."""
    (S, G, d_source, d, device, print_each, voxel_weights, ct_encode,
     neighborhood_filter, spatial_weights, train_genes_idx, val_genes_idx) = data
    del d_source, print_each

    report = _run_population(
        configs=[{k: float(v) for k, v in config.items()}],
        S=S, G=G, d=d,
        voxel_weights=voxel_weights,
        neighborhood_filter=neighborhood_filter,
        ct_encode=ct_encode,
        spatial_weights=spatial_weights,
        train_genes_idx=train_genes_idx,
        val_genes_idx=val_genes_idx,
        device=device,
    )
    return report.iloc[0].to_dict()


class _PopulationSetup:
    """Device tensors + repeat inits shared by every tuner search mode.

    With ``mesh`` (a ``DeviceMesh``), ``layout`` lays the trials out as
    :class:`~tangram_tpu_torch.parallel.mesh.BatchLayout` says (the trial
    axis named ``"trial"``, else the first), and the cell-indexed tensors
    (the repeat inits, S, its val columns, the one-hot cell types) hold
    this rank's rows."""

    def __init__(self, S, G, d, voxel_weights, neighborhood_filter,
                 ct_encode, spatial_weights, train_genes_idx, val_genes_idx,
                 device=None, mesh=None):
        from .models.mapper import init_logits, resolve_device
        from .parallel.mesh import BatchLayout

        self.device = dev = resolve_device(device)
        n_cells, n_spots = S.shape[0], G.shape[0]
        self.n_cells, self.n_spots = n_cells, n_spots
        self.layout = BatchLayout(mesh, "trial", n_cells, what="per-trial")
        rows = self.layout.rows
        g_all = S.shape[1]
        train_mask = np.zeros(g_all, np.float32)
        train_mask[np.asarray(train_genes_idx)] = 1.0
        self.train_mask = train_mask
        self.val_genes_idx = val_genes_idx
        self.S = S

        def put(x):
            return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

        # raw (unmasked) S restricted to the val genes — the gene-space
        # stability metrics project each run's map through it on the device
        self.S_val_dev = put(np.asarray(S)[rows][:, np.asarray(val_genes_idx)])
        self.S_dev = put(np.asarray(S)[rows])
        self.G_dev = put(G)
        self.mask_dev = put(train_mask)
        arrays = (self.S_dev, self.G_dev, put(d), self.mask_dev, put(voxel_weights),
                  put(neighborhood_filter), put(np.asarray(ct_encode)[rows]),
                  put(spatial_weights))

        # Getis-Ord reference on the (masked) training genes, on the device:
        # the (spots × spots) @ (spots × genes) product is ~50 GFLOP at real
        # Visium spot counts (the weights are uploaded anyway); full f32
        # products, as it is the loss term's reference
        with _full_f32():
            Gm = self.G_dev * self.mask_dev[None, :]
            getis_ref = (arrays[7] @ Gm) / torch.clamp(Gm.sum(dim=0), min=1e-30)
        self.arrays = arrays + (getis_ref,)

        # Repeat-run inits reproduce the reference stream exactly: run r
        # passes random_state=r to the Mapper
        # (mapping_parameter_tuning.py:121), and random_state=0 is falsy
        # there, so run 0 continues the ambient numpy stream while runs 1, 2
        # reseed — init_logits("numpy") has the same semantics (the JAX
        # package's draws bit for bit), making the 5 stability metrics
        # comparable run-for-run with the reference tuner.
        self.M0s = torch.stack(
            [init_logits(n_cells, n_spots, r, "auto")[rows] for r in range(N_REPEATS)]
        ).to(dev)

        self.lam_keys = [
            k for k in TUNABLE_KEYS
            if k not in ("learning_rate", "lr_peak", "lr_end", "num_epochs")
        ]
        self._fit_cache = {}

    @torch.no_grad()
    def _train(self, lam_mat, lr_peaks, lr_ends, M, count, mu, nu, start: int,
               steps: int, num_epochs: int, active):
        """Adam on the population for epochs ``start .. start + steps``, in
        place on M, mu, nu (configs, repeats, c, s) and count (configs,
        repeats): the update of ``make_adam(1.0)`` (the Adam of torch and optax,
        eps added after the sqrt), then scaled by each member's learning
        rate ``cosine_value(t, lr_peak, lr_end, num_epochs)`` — the JAX
        tuner's order, which with lr_peak == lr_end is constant Adam. It is
        written out here rather than taken from ``ops.optim.make_adam``,
        whose update multiplies by the learning rate before the division
        (JAX's fused order) and takes one count: per member, that would
        round some entries an ulp apart. Then
        each member's map softmax(M) over spots and val gene score (the
        reference's quirk: on the train split), and the metrics of each
        config's repeat cube."""
        from .ops.optim import ADAM_EPS, BETA1, BETA2
        from .ops.losses import cosine_similarity
        from .ops.schedules import cosine_value
        from .ops.axes import all_sum_

        n_cfg, R = M.shape[:2]
        members = M.reshape(n_cfg * R, *M.shape[2:])  # views: updates land in M
        mu_m, nu_m = mu.view_as(members), nu.view_as(members)
        count_m = count.view(-1)
        lam = {k: lam_mat[:, i].repeat_interleave(R) for i, k in enumerate(self.lam_keys)}
        t = start + torch.arange(steps, dtype=torch.float32, device=M.device)
        lr = cosine_value(t[:, None], lr_peaks.repeat_interleave(R)[None],
                          lr_ends.repeat_interleave(R)[None], num_epochs, xp=torch)
        beta1 = torch.tensor(BETA1, dtype=torch.float32, device=M.device)
        beta2 = torch.tensor(BETA2, dtype=torch.float32, device=M.device)
        for i in range(steps):
            with torch.enable_grad():
                Mv = members.detach().requires_grad_()
                total, _ = _tuner_loss(Mv, lam, self.arrays, active, self.layout.cell,
                                       self.n_cells)
                (g,) = torch.autograd.grad(total.sum(), (Mv,))
            mu_m.copy_((1.0 - BETA1) * g + BETA1 * mu_m)
            nu_m.copy_((1.0 - BETA2) * (g * g) + BETA2 * nu_m)
            count_m.add_(1)
            t_f = count_m.to(torch.float32)[:, None, None]
            mu_hat = mu_m / (1.0 - beta1 ** t_f)
            nu_hat = nu_m / (1.0 - beta2 ** t_f)
            update = -(mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
            members.add_(update * lr[i][:, None, None])
            del g, total, Mv
        P = torch.softmax(members, dim=-1)
        Sm = self.S_dev * self.mask_dev[None, :]
        Gm = self.G_dev * self.mask_dev[None, :]
        G_pred = all_sum_(P.transpose(-1, -2) @ Sm, self.layout.cell)
        val = (torch.sum(cosine_similarity(G_pred, Gm, axis=-2) * self.mask_dev, dim=-1)
               / torch.sum(self.mask_dev))
        return _device_metrics(P.view_as(M), val.view(n_cfg, R), self.S_val_dev,
                               self.layout.cell, self.n_cells)

    def fit_batched(self, num_epochs: int, active: Optional[frozenset] = None):
        """The (configs × repeats) population trainer for a training length
        and active-λ set, cached per (num_epochs, active) — the adaptive
        search calls this every ask/tell round and reuses one trainer.
        ``fn(lam_mat, lr_peaks, lr_ends, M0s)`` trains every config from the
        repeat inits and returns the metrics, a (configs,) tensor each."""
        num_epochs = int(num_epochs)
        cache_key = (num_epochs, active)
        if cache_key in self._fit_cache:
            return self._fit_cache[cache_key]

        def fn(lam_mat, lr_peaks, lr_ends, M0s):
            n = lam_mat.shape[0]
            M = M0s.expand(n, *M0s.shape).clone()
            count = torch.zeros((n, M0s.shape[0]), dtype=torch.int32, device=M.device)
            with _full_f32():
                return self._train(lam_mat, lr_peaks, lr_ends, M, count,
                                   torch.zeros_like(M), torch.zeros_like(M), 0,
                                   num_epochs, num_epochs, active)

        self._fit_cache[cache_key] = fn
        return fn

    def fit_halving(self, num_epochs: int, active: Optional[frozenset] = None):
        """The resumable (configs × repeats) trainer halving rungs use:
        ``fn(lam_mat, lr_peaks, lr_ends, M, count, mu, nu, start, steps)``
        continues each run for ``steps`` epochs from absolute epoch
        ``start``, carrying Adam's (count, mu, nu), with the cosine schedule
        spanning the FULL ``num_epochs`` budget (partial training follows
        the same trajectory a full run would). Returns ``(M, count, mu, nu,
        metrics)``, the state updated in place. Cached per (num_epochs,
        active) like :meth:`fit_batched`: ``search="adaptive+halving"``
        calls this once per TPE bracket."""
        num_epochs = int(num_epochs)
        cache_key = ("halving", num_epochs, active)
        if cache_key in self._fit_cache:
            return self._fit_cache[cache_key]

        def fn(lam_mat, lr_peaks, lr_ends, M, count, mu, nu, start, steps):
            with _full_f32():
                mets = self._train(lam_mat, lr_peaks, lr_ends, M, count, mu, nu,
                                   int(start), int(steps), num_epochs, active)
            return M, count, mu, nu, mets

        self._fit_cache[cache_key] = fn
        return fn

    def lam_matrix(self, configs, idxs):
        return torch.tensor(
            [[float(configs[i].get(k, 0.0)) for k in self.lam_keys] for i in idxs],
            dtype=torch.float32, device=self.device,
        )

    def lr_vectors(self, configs, idxs):
        peaks, ends = [], []
        for i in idxs:
            pk = float(
                configs[i].get("lr_peak", configs[i].get("learning_rate", 0.1))
            )
            peaks.append(pk)
            ends.append(float(configs[i].get("lr_end", pk)))
        return (torch.tensor(peaks, dtype=torch.float32, device=self.device),
                torch.tensor(ends, dtype=torch.float32, device=self.device))

    def metrics_row(self, cube, val_scores_row):
        """The reference tuner's 5 reported metrics for one trial
        (mapping_parameter_tuning.py:135-139) from its repeat-run cube.

        Host (numpy, f64) reference implementation; the population paths
        compute the same metrics on the device (:func:`_device_metrics`,
        held to this by the tests) so that the cube never leaves the card."""
        gene_cube = np.array(
            [self.S[:, np.asarray(self.val_genes_idx)].T @ cube[r]
             for r in range(N_REPEATS)]
        )
        return {
            "cell_map_consistency": float(pearson_corr(cube).mean()),
            "cell_map_agreement": float(1 - vote_entropy(cube).mean()),
            "cell_map_certainty": float(1 - consensus_entropy(cube).mean()),
            "gene_expr_consistency": float(pearson_corr(gene_cube).mean()),
            "gene_expr_correctness": float(np.mean(val_scores_row)),
        }


def _host_rows(mets, layout, n: int):
    """The metrics of a batch of ``n`` trials as one host array (one
    transfer), a dict of (configs,) float64 arrays with the keys sorted: the
    column order of the JAX package's frames (its jitted metric dict comes
    back sorted). ``mets`` are this rank's trials of the batch, gathered
    over the ``layout``'s trial axis first."""
    keys = sorted(mets)
    table = layout.gather(torch.stack([mets[k] for k in keys], dim=1), n).cpu().numpy()
    return dict(zip(keys, table.T.astype(np.float64)))


def _run_population(
    configs,
    S,
    G,
    d,
    voxel_weights,
    neighborhood_filter,
    ct_encode,
    spatial_weights,
    train_genes_idx,
    val_genes_idx,
    population_batch_size: int = 4,
    verbose: bool = False,
    setup: Optional[_PopulationSetup] = None,
    active: Optional[frozenset] = None,
    device=None,
    mesh=None,
):
    """The (configs × repeats) population in batches of
    ``population_batch_size`` configs; on the setup's mesh (``mesh``, when
    this builds the setup) each batch whose size divides the trial axis
    spreads over it. Every rank returns the whole frame."""
    if setup is None:
        setup = _PopulationSetup(
            S, G, d, voxel_weights, neighborhood_filter, ct_encode,
            spatial_weights, train_genes_idx, val_genes_idx, device=device, mesh=mesh,
        )
    M0s = setup.M0s

    results = []
    # group configs by num_epochs (one training length per batch)
    by_epochs: dict[int, list[int]] = {}
    for idx, cfg in enumerate(configs):
        by_epochs.setdefault(int(cfg.get("num_epochs", 1000)), []).append(idx)

    # λ keys that are zero across the whole population: their terms are
    # skipped (notably the dense W-product spatial terms). The public tuner
    # passes a search-space-derived set so it is identical across adaptive
    # rounds; direct callers fall back to this batch.
    if active is None:
        active = _active_lambdas(configs, setup.lam_keys)

    for num_epochs, idxs in by_epochs.items():
        fit_batched = setup.fit_batched(num_epochs, active)

        for start in range(0, len(idxs), population_batch_size):
            chunk = idxs[start : start + population_batch_size]
            mine = chunk[setup.layout.part(len(chunk))]
            lam_mat = setup.lam_matrix(configs, mine)
            lr_peaks, lr_ends = setup.lr_vectors(configs, mine)
            mets = _host_rows(fit_batched(lam_mat, lr_peaks, lr_ends, M0s), setup.layout,
                              len(chunk))

            for row, i in enumerate(chunk):
                results.append(
                    {"_index": i, **{k: float(v[row]) for k, v in mets.items()}}
                )
            if verbose:
                logging.info("tuner: %d/%d trials done", len(results), len(configs))

    results.sort(key=lambda r: r["_index"])
    df = pd.DataFrame(results).drop(columns="_index")
    return df


def _halving_rungs(n_trials: int, total_epochs: int, eta: int):
    """Cumulative (epoch_target, n_survivors_into_rung) pairs for batched
    successive halving: rung k trains the surviving n/eta^k configs up to
    total/eta^(K-k) epochs, the final rung to the full budget. Total epochs
    spent ≈ (K/eta + 1)·total — a fraction of the n·total a full sweep
    costs."""
    K = 0
    while eta ** (K + 1) <= n_trials:
        K += 1
    rungs = []
    for k in range(K + 1):
        target = max(1, int(round(total_epochs / eta ** (K - k))))
        survivors = max(1, int(np.ceil(n_trials / eta ** k)))
        rungs.append((target, survivors))
    # strictly increasing targets; the last always reaches the full budget
    out = []
    for target, survivors in rungs:
        if out and target <= out[-1][0]:
            continue
        out.append((target, survivors))
    out[-1] = (total_epochs, out[-1][1])
    return out


def _run_halving(
    configs,
    metric,
    setup: _PopulationSetup,
    num_epochs: int,
    eta: int = 3,
    population_batch_size: int = 4,
    verbose: bool = False,
    active: Optional[frozenset] = None,
):
    """Batched successive halving with epoch reallocation (the scheduler
    side of the reference's Ray stack — `tune.Tuner` + a pruning scheduler):
    trials train as batched populations in rung-sized epoch chunks; after
    each rung only the top 1/eta by the selected metrics keep training.
    Multi-metric selection uses nondomination rank + crowding (the same
    ``pareto_order`` the adaptive TPE split uses, so diverged NaN trials
    are eliminated first).

    Memory policy: carrying Adam state across rungs requires the whole
    alive population's (M, mu, nu) resident on the device at once — feasible
    only for modest populations. When that footprint exceeds the device
    budget (``utils.device_memory_budget``), rungs instead retrain their
    survivors from scratch in ``population_batch_size``-sized chunks
    (classic SHA: bounded memory at ≤ eta/(eta−1)× extra compute); both
    paths follow the same cosine-schedule trajectory because partial
    training always spans absolute epochs [0, target).

    On the setup's mesh each rung lies on the trial axis when its alive
    count divides it (each chunk of a restarted rung likewise), as in the
    JAX package: the carried state of a rung that does holds this rank's
    trials, and after an elimination the survivors' rows are gathered over
    the trial axis and taken up again by the ranks that now own them.

    Returns a row per trial with the 5 metrics at its last rung plus a
    ``trained_epochs`` column.
    """
    M0s, lam_keys, layout = setup.M0s, setup.lam_keys, setup.layout
    n = len(configs)
    if active is None:
        active = _active_lambdas(configs, lam_keys)

    fit_batched = setup.fit_halving(num_epochs, active)

    lam_mat = setup.lam_matrix(configs, range(n))
    lr_peaks, lr_ends = setup.lr_vectors(configs, range(n))

    # Carried-state mode needs the whole population's (M, mu, nu) — plus
    # the same again for a call's outputs, as the JAX package counts it —
    # live on the device at once. Fall back to restart-based rungs when it
    # doesn't fit.
    from .utils import device_memory_budget

    # in+out × (M, mu, nu) of the whole population, as JAX counts it
    state_bytes = 2 * 3 * 4 * n * N_REPEATS * setup.n_cells * setup.n_spots
    carry = state_bytes <= device_memory_budget(setup.device)
    chunk_size = max(1, int(population_batch_size))

    def fresh(k):
        """k configs' start: the repeat inits, zero count and moments."""
        M = M0s.expand(k, *M0s.shape).clone()
        count = torch.zeros((k, N_REPEATS), dtype=torch.int32, device=M.device)
        return M, count, torch.zeros_like(M), torch.zeros_like(M)

    if carry:
        part = layout.part(n)
        M, count, mu, nu = fresh(part.stop - part.start)
    elif verbose:
        logging.info(
            "halving: carried state (%.1f GB) exceeds the device budget; "
            "restart-based rungs in chunks of %d", state_bytes / 1e9,
            chunk_size,
        )

    # `alive` holds global trial indices in the same order as the batch
    # arrays' leading axis; eliminations gather the survivor rows
    alive = np.arange(n)
    rows = [None] * n
    trained = np.zeros(n, dtype=int)
    done = 0
    for target, survivors in _halving_rungs(n, int(num_epochs), int(eta)):
        keep = min(survivors, len(alive))
        if keep < len(alive):
            order = _select_order(
                np.asarray([[rows[i][m] for m in metric] for i in alive])
            )
            sel = np.sort(order[:keep])  # batch positions of the survivors
            sel_dev = torch.as_tensor(sel, device=lam_mat.device)
            lam_mat, lr_peaks, lr_ends = lam_mat[sel_dev], lr_peaks[sel_dev], lr_ends[sel_dev]
            if carry:
                # the whole alive population's state (it fits the budget by
                # construction), then this rank's survivors
                mine = layout.part(keep)
                M, count, mu, nu = (layout.gather(x, len(alive))[sel_dev][mine]
                                    for x in (M, count, mu, nu))
            alive = alive[sel]
        if carry:
            mine = layout.part(len(alive))
            M, count, mu, nu, mets = fit_batched(
                lam_mat[mine], lr_peaks[mine], lr_ends[mine], M, count, mu, nu, done,
                target - done,
            )
            mets = _host_rows(mets, layout, len(alive))
            for row, i in enumerate(alive):
                rows[i] = {k: float(v[row]) for k, v in mets.items()}
        else:
            for start in range(0, len(alive), chunk_size):
                stop = min(start + chunk_size, len(alive))
                part = layout.part(stop - start)
                mine = slice(start + part.start, start + part.stop)
                *_, mets = fit_batched(
                    lam_mat[mine], lr_peaks[mine], lr_ends[mine],
                    *fresh(part.stop - part.start), 0, target,
                )
                mets = _host_rows(mets, layout, stop - start)
                for row in range(stop - start):
                    i = alive[start + row]
                    rows[i] = {k: float(v[row]) for k, v in mets.items()}
        done = target
        trained[alive] = done
        if verbose:
            logging.info(
                "halving: %d configs at %d/%d epochs", len(alive), done,
                num_epochs,
            )

    df = pd.DataFrame(rows)
    df["trained_epochs"] = trained
    return df


def _select_order(Y: np.ndarray) -> np.ndarray:
    """Trial ordering, best first, by the selected (maximized) metrics —
    :func:`tangram_tpu_torch.search.pareto_order` (the same rule the TPE
    sampler's good/bad split uses; diverged trials with NaN metrics sort
    last, so halving eliminates them first)."""
    from .search import pareto_order

    return pareto_order(Y)


# ---------------------------------------------------------------------------
# public tuner
# ---------------------------------------------------------------------------


class _BestResult:
    """Duck-types ``ray.train.Result``: ``.config`` and ``.metrics``
    (values as native Python scalars, like ray reports them)."""

    def __init__(self, row):
        from .utils import _jsonable

        self.config = {
            k.split("/", 1)[1]: _jsonable(row[k])
            for k in row.index if k.startswith("config/")
        }
        self.metrics = {
            k: _jsonable(row[k]) for k in row.index
            if not k.startswith("config/")
        }


class _ResultGrid:
    def __init__(self, df):
        self._df = df

    def get_dataframe(self):
        return self._df

    def get_best_result(self, metric=None, mode="max"):
        """Best trial as a ``ray.train.Result``-shaped object (ray's
        ``ResultGrid.get_best_result``). ``metric`` may be one name or a
        list (multi-objective — the Pareto-best by the same
        :func:`tangram_tpu_torch.search.pareto_order` rule the samplers use);
        ``mode`` is ``"max"`` or ``"min"`` (the 5 tuner metrics are all
        maximized, ray's API still takes a mode)."""
        if metric is None:
            raise ValueError("get_best_result requires `metric`")
        names = [metric] if isinstance(metric, str) else list(metric)
        sign = {"max": 1.0, "min": -1.0}.get(mode)
        if sign is None:
            raise ValueError('mode must be "max" or "min"')
        from .search import pareto_order

        Y = sign * self._df[names].to_numpy(dtype=float)
        best = int(pareto_order(Y)[0])
        if not np.all(np.isfinite(Y[best])):
            # pareto_order sorts NaN (diverged) trials last, so reaching
            # one here means EVERY trial diverged — don't hand back an
            # arbitrary config as "best" silently
            logging.warning(
                "get_best_result: no trial has finite %s metrics (all "
                "trials diverged?); returning an arbitrary trial", names,
            )
        return _BestResult(self._df.iloc[best])


class TunerResult:
    """Duck-types the ray ``Tuner`` the reference returns: call
    ``.get_results().get_dataframe()`` for a row per trial with the 5 metrics
    and ``config/...`` columns."""

    def __init__(self, df):
        self._df = df

    def get_results(self):
        return _ResultGrid(self._df)

    def fit(self):  # already fitted; parity no-op
        return self.get_results()


def mapping_hyperparameter_tuning(
    adata_sc,
    adata_sp,
    metric,
    config,
    tuner_num_samples: int = 2000,
    cv_train_genes=None,
    cv_val_genes=None,
    cluster_label=None,
    device=None,
    density_prior="rna_count_based",
    random_state: Optional[int] = 0,
    population_batch_size: int = 4,
    verbose: bool = False,
    mesh=None,
    search: str = "sobol",
    halving_eta: int = 3,
    resume_path: Optional[str] = None,
) -> TunerResult:
    """Tune mapping hyperparameters (reference ``:141-272``).

    Differences from the reference: trials run as batched populations on
    the device instead of Ray worker processes, ``population_batch_size``
    configs (× 3 repeats) at a time. ``device`` is the card by default
    (``None`` means ``"cuda"``, which must be available); ``device="cpu"``
    runs the same code on the CPU. ``search`` selects the sampler:

    * ``"sobol"`` (default) — scrambled Sobol quasi-random: non-adaptive,
      best-possible space coverage at a fixed trial budget.
    * ``"adaptive"`` — multi-objective TPE (the capability the reference
      gets from Ray + ``OptunaSearch``, ``mapping_parameter_tuning.py:
      259-271``): trials run in ``population_batch_size``-sized ask/tell
      rounds, each round's configurations sampled near the Pareto-best
      observed ones (:mod:`tangram_tpu_torch.search`); each round is one
      batched population.
    * ``"halving"`` — batched successive halving (the scheduler/pruning
      side of the Ray stack): trials train in rung-sized epoch chunks;
      after each rung only the top ``1/halving_eta`` by the selected
      metrics keep training, so the full epoch budget concentrates on
      promising configurations (total cost ≈ (1 + K/eta)·num_epochs
      instead of n·num_epochs). When the whole population's Adam state
      fits the device budget, rungs continue from carried state; otherwise
      rungs retrain their survivors from scratch in
      ``population_batch_size``-sized chunks (classic SHA — bounded
      memory, ≤ eta/(eta−1)× extra compute). Requires a fixed
      ``num_epochs`` in ``config``; the result gains a ``trained_epochs``
      column.
    * ``"adaptive+halving"`` — the two composed, as Ray composes
      ``OptunaSearch`` with a pruning scheduler: TPE asks a bracket of
      configurations, successive halving prunes the bracket, and every
      trial's metrics (full-budget survivors and partial-budget
      eliminations) feed the TPE model for the next bracket. Same fixed
      ``num_epochs`` requirement and ``trained_epochs`` column as
      ``"halving"``.

    ``resume_path`` makes the sweep crash-tolerant: every completed
    population batch / ask-tell round is journaled to the file, and
    re-running with the same arguments skips the recorded trials (Sobol)
    or replays them through the TPE model (adaptive modes) and completes
    only the remainder — a killed sweep loses at most one in-flight batch,
    and the resumed sweep asks what the unbroken one asked. Plain
    ``"halving"`` journals only a completed sweep (its rung state is
    global, so a partial sweep restarts). The file must belong to the same
    sweep (search/space/metric/budget/seed — validated); run 0's mapper
    init continues the ambient numpy stream (reference parity), so equal
    resumed metrics additionally need the same ambient seeding the original
    call had.

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` of the ``device``'s
    type; every rank of it calls the tuner alike) is data parallelism over
    trials with tensor parallelism inside each trial, as the JAX package
    lays it out, in every search mode: a population batch (a halving rung,
    a restarted rung's chunk) whose config count divides the mesh axis
    named ``"trial"`` (else the first axis) spreads over it, and any other
    trains whole on every rank; the remaining axes shard each member's
    cells in contiguous blocks when the cell count divides their product,
    and hold every cell, with a warning, otherwise. Every rank draws the
    same inits and asks the same configs from the same seeds (so each
    needs the same ambient numpy state) and returns the whole frame; the
    lead rank alone writes ``resume_path``.
    """
    from .mapping import _densify
    from .models.mapper import _check_mesh, resolve_device

    if search not in ("sobol", "adaptive", "halving", "adaptive+halving"):
        raise ValueError(
            'search must be "sobol", "adaptive", "halving" or '
            '"adaptive+halving"'
        )
    if "halving" in search and int(halving_eta) < 2:
        raise ValueError("halving_eta must be >= 2")

    if (type(density_prior) is str) and (
        density_prior not in ["rna_count_based", "uniform", None]
    ):
        raise ValueError("Invalid input for density_prior.")

    if not set(["training_genes", "overlap_genes"]).issubset(set(adata_sc.uns.keys())):
        raise ValueError("Missing tangram parameters. Run `pp_adatas()`.")
    if not set(["training_genes", "overlap_genes"]).issubset(set(adata_sp.uns.keys())):
        raise ValueError("Missing tangram parameters. Run `pp_adatas()`.")
    assert list(adata_sp.uns["training_genes"]) == list(adata_sc.uns["training_genes"])

    overlap_genes = adata_sc.uns["overlap_genes"]

    if cv_train_genes is None:
        train_genes_idx = list(range(len(overlap_genes)))
    else:
        if set(cv_train_genes).issubset(set(adata_sc.uns["training_genes"])):
            train_genes_idx = (
                adata_sc[:, overlap_genes].var.index.get_indexer(cv_train_genes)
            )
        else:
            raise ValueError("Given training genes should be subset of two AnnDatas.")

    if cv_val_genes is None:
        val_genes_idx = list(range(len(overlap_genes)))
    else:
        if set(cv_val_genes).issubset(set(adata_sc.uns["training_genes"])):
            val_genes_idx = (
                adata_sc[:, overlap_genes].var.index.get_indexer(cv_val_genes)
            )
        else:
            raise ValueError("Given validation genes should be subset of two AnnDatas.")

    if not set(metric).issubset(set(METRIC_KEYS)):
        raise ValueError(
            'Argument "metric" must be a subset of {}'.format(METRIC_KEYS)
        )
    if not set(config.keys()).issubset(set(TUNABLE_KEYS)):
        raise ValueError(
            'Keys of the argument "config" must be a subset of {}'.format(TUNABLE_KEYS)
        )
    device = resolve_device(device)
    mesh = _check_mesh(mesh, device)

    logging.info("Allocate tensors for mapping.")
    S = _densify(adata_sc[:, overlap_genes].X)
    G = _densify(adata_sp[:, overlap_genes].X)
    if not S.any(axis=0).all() or not G.any(axis=0).all():
        raise ValueError("Genes with all zero values detected. Run `pp_adatas()`.")

    if isinstance(density_prior, str) and density_prior == "rna_count_based":
        density_prior = adata_sp.obs["rna_count_based_density"]
    elif isinstance(density_prior, str) and density_prior == "uniform":
        density_prior = adata_sp.obs["uniform_density"]
    d = np.asarray(
        density_prior
        if density_prior is not None
        else adata_sp.obs["uniform_density"],
        dtype=np.float32,
    )

    # all weight-matrix variants, unconditionally (reference :250-255)
    voxel_weights = sw.spatial_weights(adata_sp, standardized=True, self_inclusion=True)
    if cluster_label not in adata_sc.obs.keys():
        raise ValueError(
            "cluster_label must be specified for the cell type island extension."
        )
    neighborhood_filter = sw.spatial_weights(
        adata_sp, standardized=False, self_inclusion=False
    )
    ct_encode = one_hot_encoding(adata_sc.obs[cluster_label]).values
    spatial_weights = sw.spatial_weights(adata_sp, standardized=False, self_inclusion=True)

    domains = {k: _coerce_domain(v) for k, v in config.items()}

    setup = _PopulationSetup(
        S, G, d, voxel_weights, neighborhood_filter, ct_encode,
        spatial_weights, train_genes_idx, val_genes_idx, device=device, mesh=mesh,
    )
    population_kwargs = dict(
        S=S,
        G=G,
        d=d,
        voxel_weights=voxel_weights,
        neighborhood_filter=neighborhood_filter,
        ct_encode=ct_encode,
        spatial_weights=spatial_weights,
        train_genes_idx=train_genes_idx,
        val_genes_idx=val_genes_idx,
        population_batch_size=population_batch_size,
        verbose=verbose,
        setup=setup,
        # derived from the SEARCH SPACE (not the sampled values) so every
        # adaptive round / halving rung reuses one cached trainer
        active=_space_active_lambdas(domains, setup.lam_keys),
    )

    journal = stored_trials = None
    if resume_path is not None:
        journal = _SweepJournal(
            resume_path,
            meta=dict(
                search=search, metric=list(metric), keys=sorted(domains),
                tuner_num_samples=int(tuner_num_samples),
                random_state=random_state, halving_eta=int(halving_eta),
            ),
            sync=setup.layout,
        )
        stored_trials = journal.load()
        if verbose and stored_trials:
            logging.info(
                "tuner: resuming %d recorded trials from %s",
                len(stored_trials), resume_path,
            )

    def from_unit_rows(unit_rows):
        return [
            {k: dom.from_unit(u) for (k, dom), u in zip(domains.items(), row)}
            for row in unit_rows
        ]

    def sobol_unit_rows(n):
        import warnings

        from scipy.stats import qmc

        sampler = qmc.Sobol(
            d=max(len(domains), 1), scramble=True, seed=random_state
        )
        with warnings.catch_warnings():
            # arbitrary trial counts are this API's contract (the reference
            # accepts any tuner_num_samples); scipy's power-of-2 balance
            # advice is noise here
            warnings.filterwarnings(
                "ignore", message=".*balance properties of Sobol.*"
            )
            return sampler.random(n)

    def tpe_ask_tell_rounds(batch, runner, label):
        """The shared TPE ask/tell loop: ask a batch, run it as one batched
        population, tell the sampler the selected (maximized) ``metric``
        columns back. Both adaptive modes differ only in the per-round
        runner (full-budget population vs halving bracket)."""
        from .search import TPESampler

        sampler = TPESampler(
            n_dims=len(domains),
            seed=random_state,
            n_startup=min(16, max(4, tuner_num_samples // 4)),
        )
        configs, frames = [], []
        replay = list(stored_trials or [])
        while len(configs) < tuner_num_samples:
            ask_n = min(batch, tuner_num_samples - len(configs))
            unit_rows = sampler.ask(ask_n)
            round_configs = from_unit_rows(unit_rows)
            # resume: a journaled round is replayed, its rows asked again
            # and its recorded metrics told back, so that the sampler
            # reaches the state the unbroken sweep had and the remaining
            # rounds ask what that sweep asked (the JAX package tells the
            # journal at once, after which the sampler asks its start-up
            # points again)
            recs, replay = replay[:ask_n], replay[ask_n:]
            if recs and not np.array_equal(
                    np.asarray([t["unit"] for t in recs], dtype=np.float64),
                    unit_rows[:len(recs)]):
                raise ValueError(
                    f"resume_path {resume_path!r} records other trials than "
                    "this sweep asks")
            frame = pd.DataFrame([t["metrics"] for t in recs])
            if len(recs) < ask_n:
                fresh = runner(round_configs[len(recs):])
                frame = pd.concat([frame, fresh], ignore_index=True) if recs else fresh
                if journal is not None:
                    new = fresh.to_dict("records")
                    journal.append([
                        {"i": len(configs) + k,
                         "unit": [float(u) for u in unit_rows[k]],
                         "config": round_configs[k], "metrics": new[k - len(recs)]}
                        for k in range(len(recs), ask_n)
                    ])
            sampler.tell(unit_rows, frame[list(metric)].to_numpy())
            configs.extend(round_configs)
            frames.append(frame)
            if verbose:
                logging.info(
                    "%s tuner: %d/%d trials", label, len(configs),
                    tuner_num_samples,
                )
        return configs, pd.concat(frames, ignore_index=True)

    if search == "adaptive" and domains:
        configs, df = tpe_ask_tell_rounds(
            population_batch_size,
            lambda cfgs: _run_population(configs=cfgs, **population_kwargs),
            "adaptive",
        )
    elif search in ("halving", "adaptive+halving") and domains:
        num_epochs = config.get("num_epochs", 1000)
        if not isinstance(num_epochs, (int, float)) or isinstance(
            num_epochs, bool
        ):
            raise ValueError(
                f'search="{search}" requires a FIXED num_epochs in config — '
                "the halving schedule reallocates epochs itself"
            )
        halving_kw = dict(
            eta=int(halving_eta),
            population_batch_size=population_batch_size,
            verbose=verbose,
            active=population_kwargs["active"],
        )
        if search == "halving":
            # batched successive halving: Sobol-sample the population, then
            # reallocate the epoch budget to the metric-best survivors
            unit_all = sobol_unit_rows(tuner_num_samples)
            configs = from_unit_rows(unit_all)
            if stored_trials and len(stored_trials) >= tuner_num_samples:
                # rung state is global, so only a COMPLETED sweep is
                # journaled/resumable — return it verbatim
                stored = stored_trials[:tuner_num_samples]
                configs = [t["config"] for t in stored]
                df = pd.DataFrame([t["metrics"] for t in stored])
            else:
                df = _run_halving(
                    configs, list(metric), setup, int(num_epochs),
                    **halving_kw,
                )
                if journal is not None:
                    recs = df.to_dict("records")
                    journal.append([
                        {"i": i, "unit": [float(u) for u in unit_all[i]],
                         "config": configs[i], "metrics": recs[i]}
                        for i in range(len(configs))
                    ])
        else:
            # BOHB-style composition (the reference's Ray stack composes
            # OptunaSearch with a pruning scheduler the same way): TPE asks
            # a bracket of configs, successive halving prunes it, and every
            # trial's metrics — full-budget survivors and partial-budget
            # eliminations alike — feed back into the TPE model.
            configs, df = tpe_ask_tell_rounds(
                max(int(halving_eta), int(population_batch_size)),
                lambda cfgs: _run_halving(
                    cfgs, list(metric), setup, int(num_epochs), **halving_kw,
                ),
                "adaptive+halving",
            )
    else:
        # scrambled Sobol over the search space, one population
        unit_all = sobol_unit_rows(tuner_num_samples)
        configs = from_unit_rows(unit_all)
        if journal is None:
            df = _run_population(configs=configs, **population_kwargs)
        else:
            # resume: trials are independent under Sobol, so journaled
            # indices are skipped and only the remainder runs (in
            # population_batch_size chunks, each flushed on completion)
            done = {
                int(t["i"]): t["metrics"]
                for t in stored_trials if int(t["i"]) < tuner_num_samples
            }
            pending = [i for i in range(tuner_num_samples) if i not in done]
            for start in range(0, len(pending), int(population_batch_size)):
                chunk = pending[start:start + int(population_batch_size)]
                frame = _run_population(
                    configs=[configs[i] for i in chunk], **population_kwargs
                )
                recs = frame.to_dict("records")
                journal.append([
                    {"i": i, "unit": [float(u) for u in unit_all[i]],
                     "config": configs[i], "metrics": rec}
                    for i, rec in zip(chunk, recs)
                ])
                done.update(zip(chunk, recs))
            df = pd.DataFrame([done[i] for i in range(tuner_num_samples)])

    for k in domains:
        df[f"config/{k}"] = [cfg[k] for cfg in configs]
    return TunerResult(df)
