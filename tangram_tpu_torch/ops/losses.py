"""The Tangram loss terms, in PyTorch.

Counterpart of ``tangram_tpu/ops/losses.py``: the expression (gene-voxel
and voxel-gene) similarities, the density KL, the entropy term, the L1/L2
terms on the raw logits and the five graph terms (spatial neighborhood
similarity, cell-type islands, Getis-Ord, Moran and Geary preservation) of
the unconstrained mapper; the count and filter terms of the constrained
mapper, which takes no graph term (as in the JAX package); and the
validation metrics. Semantics mirror the reference optimizer
(``mapping_optimizer.py:159-356`` and ``:495-587``), including its
reporting quirks: each term is reported as ``term / lambda``, NaN when that
lambda is 0, the graph terms as their similarity or penalty, NaN when off,
and the constrained mapper reports the entropy with the opposite sign.

Geary's C uses the identity ``Σ_ij w_ij (x_i − x_j)² = r·x² + c·x² −
2·Σ x ⊙ Wx`` (r, c the row and column sums of W) in place of the
reference's O(spots² · genes) broadcast, as the JAX package does. The spot
graphs are dense tensors or :class:`~tangram_tpu_torch.ops.core.NeighborGraph`
and enter through :func:`~tangram_tpu_torch.ops.core.graph_matmul`; inside
a fused step's epilogue each such product, and each of its VJPs, counts
once in ``cuda_core.LAUNCHES["graph"]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from .core import graph_matmul, mapper_core
from .cuda_core import LAUNCHES

__all__ = [
    "LossWeights",
    "MapperData",
    "cosine_similarity",
    "kl_div_sum",
    "spatial_local_indicators",
    "compute_loss",
    "compute_constrained_loss",
    "constrained_epilogue",
    "constrained_inputs",
    "unconstrained_inputs",
    "unconstrained_epilogue",
    "graph_terms_on",
    "val_metrics",
    "val_metrics_from_projection",
    "VAL_METRIC_KEYS",
]

COSINE_EPS = 1e-8  # matches torch.nn.functional.cosine_similarity default


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss-term strengths (the same fields as the JAX package's)."""

    lambda_g1: float = 1.0
    lambda_d: float = 0.0
    lambda_g2: float = 0.0
    lambda_r: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    lambda_neighborhood_g1: float = 0.0
    lambda_ct_islands: float = 0.0
    lambda_getis_ord: float = 0.0
    lambda_moran: float = 0.0
    lambda_geary: float = 0.0
    # constrained mode only
    lambda_count: float = 1.0
    lambda_f_reg: float = 1.0


#: the five graph terms' lambdas; a term is on where its lambda is > 0
GRAPH_LAMBDAS = ("lambda_neighborhood_g1", "lambda_ct_islands", "lambda_getis_ord",
                 "lambda_moran", "lambda_geary")


def graph_terms_on(lw: LossWeights) -> bool:
    """True when any of the five graph terms is on."""
    return any(getattr(lw, name) > 0 for name in GRAPH_LAMBDAS)


class MapperData(NamedTuple):
    """Tensors consumed by the loss, all on one device. ``None`` disables a
    term."""

    S: torch.Tensor  # (cells, genes) training expression
    G: torch.Tensor  # (spots, genes) spatial expression
    gene_mask: Optional[torch.Tensor] = None  # (genes,) 1/0 for padded folds
    d: Optional[torch.Tensor] = None  # (spots,) target density
    d_source: Optional[torch.Tensor] = None  # (cells,) cluster density
    voxel_weights: Any = None  # (spots, spots) tensor or NeighborGraph
    neighborhood_filter: Any = None  # (spots, spots) tensor or NeighborGraph
    ct_encode: Optional[torch.Tensor] = None  # (cells, n_celltypes)
    spatial_weights: Any = None  # (spots, spots) tensor or NeighborGraph
    getis_ord_ref: Optional[torch.Tensor] = None  # (spots, genes)
    moran_ref: Optional[torch.Tensor] = None  # (spots, genes)
    geary_ref: Optional[torch.Tensor] = None  # (genes,)
    target_count: Optional[torch.Tensor] = None  # 0-d, constrained mode


def cosine_similarity(x, y, axis: int = 0, eps: float = COSINE_EPS):
    """torch-compatible cosine similarity along ``axis``: each norm is clamped
    to ``eps`` individually.

    The clamp sits *inside* the sqrt (``sqrt(max(Σx², eps²))``): the same
    value as ``max(‖x‖, eps)``, but with a zero (not NaN) gradient at x = 0,
    which matters for masked gene columns. ``F.cosine_similarity`` clamps
    differently and is not used.
    """
    dot = torch.sum(x * y, dim=axis)
    nx = torch.sqrt(torch.clamp(torch.sum(x * x, dim=axis), min=eps * eps))
    ny = torch.sqrt(torch.clamp(torch.sum(y * y, dim=axis), min=eps * eps))
    return dot / (nx * ny)


def kl_div_sum(log_pred, target):
    """torch ``KLDivLoss(reduction='sum')``: Σ target·(log target − log_pred)
    with 0·log 0 := 0, so zero-target entries contribute exactly 0 even
    where ``log_pred`` is −inf. The sum runs over the last axis: a batch of
    ``log_pred`` rows (the tuner's population) gives one value per row."""
    pos = target > 0
    xlogx = torch.where(
        pos, target * torch.log(torch.where(pos, target, torch.ones_like(target))),
        torch.zeros_like(target),
    )
    cross = torch.where(pos, target * log_pred, torch.zeros_like(log_pred))
    return torch.sum(xlogx - cross, dim=-1)


def _masked_mean(values, mask):
    if mask is None:
        return torch.mean(values)
    return torch.sum(values * mask) / torch.sum(mask)


def _safe_div(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


#: whether :func:`_graph_product` counts (inside a fused step's epilogue)
_COUNT_GRAPH = [False]


@contextlib.contextmanager
def counting_graph_products():
    """Count each spot-graph product of the loss, and each of its VJPs, in
    ``LAUNCHES["graph"]`` while open."""
    outer, _COUNT_GRAPH[0] = _COUNT_GRAPH[0], True
    try:
        yield
    finally:
        _COUNT_GRAPH[0] = outer


def _count_graph_vjp(grad):
    LAUNCHES["graph"] += 1


def _graph_product(W, X):
    """:func:`graph_matmul`, counted under :func:`counting_graph_products`
    with its VJP where ``X`` takes a gradient."""
    out = graph_matmul(W, X)
    if _COUNT_GRAPH[0]:
        LAUNCHES["graph"] += 1
        if out.requires_grad:
            out.register_hook(_count_graph_vjp)
    return out


def _row_col_sums(W):
    if hasattr(W, "row_sums"):
        return W.row_sums(), W.col_sums()
    return torch.sum(W, dim=1), torch.sum(W, dim=0)


def spatial_local_indicators(G, W, lw: LossWeights):
    """(Getis-Ord G*, Moran's I, Geary's C) of each gene of G (spots ×
    genes) on the spot graph W, each ``None`` where its lambda is not > 0:
    (spots, genes), (spots, genes) and (genes,). Matches the reference
    ``mapping_optimizer.py:159-187``; Geary's C through the streamed
    identity of the module docstring, and Moran's W @ broadcast(mean) as
    row_sums(W) ⊗ mean. A gene column of zeros gives 0 for each (through
    ``_safe_div``), so masked-out genes need no mask here."""
    getis_ord = moran = geary = None
    n_spots = G.shape[0]

    WG = None
    if lw.lambda_getis_ord > 0 or lw.lambda_moran > 0 or lw.lambda_geary > 0:
        WG = _graph_product(W, G)

    if lw.lambda_getis_ord > 0:
        getis_ord = _safe_div(WG, torch.sum(G, dim=0))

    if lw.lambda_moran > 0:
        mean = torch.mean(G, dim=0)
        z = G - mean
        Wz = WG - _row_col_sums(W)[0][:, None] * mean[None, :]
        moran = _safe_div(n_spots * z * Wz, torch.sum(z * z, dim=0))

    if lw.lambda_geary > 0:
        z = G - torch.mean(G, dim=0)
        m2 = torch.sum(z * z, dim=0) / (n_spots - 1)
        r, c = _row_col_sums(W)
        GG = G * G
        pair_sum = r @ GG + c @ GG - 2.0 * torch.sum(G * WG, dim=0)
        geary = _safe_div(pair_sum, 2.0 * m2)

    return getis_ord, moran, geary


def _needs_ct(data: MapperData, lw: LossWeights) -> bool:
    return lw.lambda_ct_islands > 0 and data.ct_encode is not None


def unconstrained_inputs(M, data: MapperData, lw: LossWeights):
    """(A, w) fed to the core: A is S (gene-masked), with the one-hot cell
    types appended when the cell-type-island term is on (λ > 0), w the
    marginal weight — uniform 1/n_cells in cells mode, the cluster density
    in clusters mode."""
    S, mask = data.S, data.gene_mask
    if mask is not None:
        S = S * mask[None, :]
    if _needs_ct(data, lw):
        S = torch.cat([S, data.ct_encode], dim=1)
    if data.d_source is not None:
        w = data.d_source
    else:
        n_cells = M.shape[0]
        w = torch.full((n_cells,), 1.0 / n_cells, dtype=torch.float32,
                       device=M.device)
    return S, w


def unconstrained_epilogue(Y, q, h, l1_sum, l2_sum, data: MapperData,
                           lw: LossWeights):
    """Everything downstream of the core, as a function of the small
    (spots × k) projection ``Y`` (the genes, then the cell types when the
    island term is on), the marginal ``q`` and the per-cell
    ``h = Σ P log P`` or their total, a 0-d tensor. The fused loop
    differentiates this function alone, on the total, and hands (dY, dq,
    dh) to the streamed backward kernels. ``l1_sum`` and ``l2_sum`` are
    Σ|M| and ΣM² of the raw logits (``None`` where their lambda is 0); the
    fused loop passes them as values only, their gradients being added
    inside the update kernels. A graph term is on
    where its lambda is > 0 (a negative lambda turns it off, as in JAX).

    Returns ``(total, terms)``; ``terms`` holds 0-d tensors for
    ``main_loss``, ``vg_reg``, ``kl_reg``, ``entropy_reg``, ``l1_reg``,
    ``l2_reg``, ``gv_neighborhood_sim``, ``ct_island_penalty``,
    ``getis_ord_sim``, ``moran_sim``, ``geary_sim`` and ``total_loss``, NaN
    where the term is off.
    """
    S, G, mask = data.S, data.G, data.gene_mask
    if mask is not None:
        S = S * mask[None, :]
        G = G * mask[None, :]
    nan = torch.full((), float("nan"), dtype=torch.float32, device=Y.device)

    G_pred = Y[:, : S.shape[1]]
    ct_map = Y[:, S.shape[1]:] if _needs_ct(data, lw) else None
    terms = {}

    # gene-voxel & voxel-gene expression similarity (ref :205-206)
    gv_sim = _masked_mean(cosine_similarity(G_pred, G, axis=0), mask)
    vg_sim = torch.mean(cosine_similarity(G_pred, G, axis=1))
    gv_term = lw.lambda_g1 * gv_sim
    vg_term = lw.lambda_g2 * vg_sim
    expression_term = gv_term + vg_term
    terms["main_loss"] = gv_term / lw.lambda_g1
    terms["vg_reg"] = vg_term / lw.lambda_g2 if lw.lambda_g2 != 0 else nan

    # density KL (ref :212-221)
    if data.d is not None:
        density_term = lw.lambda_d * kl_div_sum(torch.log(q), data.d)
        terms["kl_reg"] = density_term / lw.lambda_d if lw.lambda_d != 0 else nan
    else:
        density_term = 0.0
        terms["kl_reg"] = nan

    # entropy (ref :224) — positive entropy ADDED to the loss => peaked maps
    entropy_term = lw.lambda_r * -(h if h.dim() == 0 else torch.sum(h))
    terms["entropy_reg"] = entropy_term / lw.lambda_r if lw.lambda_r != 0 else nan

    # L1/L2 on the raw logits (ref :228-231)
    l1_term = lw.lambda_l1 * l1_sum if lw.lambda_l1 != 0 else 0.0
    l2_term = lw.lambda_l2 * l2_sum if lw.lambda_l2 != 0 else 0.0
    terms["l1_reg"] = l1_term / lw.lambda_l1 if lw.lambda_l1 != 0 else nan
    terms["l2_reg"] = l2_term / lw.lambda_l2 if lw.lambda_l2 != 0 else nan

    # spatial neighborhood expression similarity (ref :234-239)
    if lw.lambda_neighborhood_g1 > 0:
        WGp = _graph_product(data.voxel_weights, G_pred)
        WG = _graph_product(data.voxel_weights, G)
        nb_sim = _masked_mean(cosine_similarity(WGp, WG, axis=0), mask)
        gv_neighborhood_term = lw.lambda_neighborhood_g1 * nb_sim
        terms["gv_neighborhood_sim"] = nb_sim
    else:
        gv_neighborhood_term = 0.0
        terms["gv_neighborhood_sim"] = nan

    # cell-type islands (ref :242-248)
    if ct_map is not None:
        nb_ct = _graph_product(data.neighborhood_filter, ct_map)
        excess = ct_map - nb_ct
        # max(x, 0) as jnp.maximum, half the gradient on each side at a tie
        penalty = torch.mean(torch.maximum(excess, torch.zeros_like(excess)))
        ct_island_term = lw.lambda_ct_islands * penalty
        terms["ct_island_penalty"] = penalty
    else:
        ct_island_term = 0.0
        terms["ct_island_penalty"] = nan

    # spatial autocorrelation preservation (ref :251-263)
    getis_pred, moran_pred, geary_pred = spatial_local_indicators(
        G_pred, data.spatial_weights, lw)
    getis_term = moran_term = geary_term = 0.0
    terms["getis_ord_sim"] = terms["moran_sim"] = terms["geary_sim"] = nan
    if lw.lambda_getis_ord > 0:
        sim = _masked_mean(cosine_similarity(data.getis_ord_ref, getis_pred, axis=0), mask)
        getis_term = lw.lambda_getis_ord * sim
        terms["getis_ord_sim"] = sim
    if lw.lambda_moran > 0:
        sim = _masked_mean(cosine_similarity(data.moran_ref, moran_pred, axis=0), mask)
        moran_term = lw.lambda_moran * sim
        terms["moran_sim"] = sim
    if lw.lambda_geary > 0:
        # one Geary's C per gene: the reference's cosine over a 1-D tensor
        # is the cosine of the two gene vectors
        ref, pred = data.geary_ref, geary_pred
        if mask is not None:
            ref, pred = ref * mask, pred * mask
        sim = cosine_similarity(ref, pred, axis=0)
        geary_term = lw.lambda_geary * sim
        terms["geary_sim"] = sim

    total = (-expression_term + density_term + entropy_term + l1_term + l2_term
             + ct_island_term - gv_neighborhood_term - getis_term - moran_term
             - geary_term)
    terms["total_loss"] = total
    return total, terms


def compute_loss(M, data: MapperData, lw: LossWeights, impl: str = "auto"):
    """Loss of the unconstrained mapper (reference ``_loss_fn``,
    ``mapping_optimizer.py:189-309``) through :func:`mapper_core` with
    ``impl`` resolved for ``M`` (``"auto"``: the kernels' core on a CUDA
    tensor, the materialized core on a CPU tensor).

    Returns ``(total_loss, terms)``."""
    A, w = unconstrained_inputs(M, data, lw)
    Y, q, h = mapper_core(M, A, w, impl)
    l1_sum = torch.sum(torch.abs(M)) if lw.lambda_l1 != 0 else None
    l2_sum = torch.sum(M * M) if lw.lambda_l2 != 0 else None
    return unconstrained_epilogue(Y, q, h, l1_sum, l2_sum, data, lw)


def compute_constrained_loss(params, data: MapperData, lw: LossWeights,
                             impl: str = "auto"):
    """Loss of the constrained mapper (reference
    ``MapperConstrained._loss_fn``, ``mapping_optimizer.py:495-587``) of
    ``params = (M, F)``: the core runs with A = S ⊙ σ(F) and w = σ(F)."""
    M, F = params
    A, w = constrained_inputs(F, data)
    Y, q, h = mapper_core(M, A, w, impl)
    return constrained_epilogue(Y, q, torch.sum(h), F, data, lw)


def constrained_inputs(F, data: MapperData):
    """(A = S ⊙ σ(F), w = σ(F)) fed to the core in constrained mode (S
    gene-masked), contiguous."""
    w = torch.sigmoid(F)
    S = data.S
    if data.gene_mask is not None:
        S = S * data.gene_mask[None, :]
    return (S * w[:, None]).contiguous(), w


def constrained_epilogue(Y, q, h_sum, F, data: MapperData, lw: LossWeights,
                         f_sums=None):
    """The constrained loss downstream of the core, as a function of the
    projection ``Y = Pᵀ(S ⊙ σ(F))``, the filtered marginal ``q = σ(F) P``,
    the total ``h_sum = Σ P log P`` and the raw filter logits ``F``, taken as
    independent inputs: the fused step differentiates this function alone
    and recovers F's gradient through A and q from the rbar pass.

    ``f_sums = (Σ σ(F), Σ σ(F) − σ(F)²)`` with ``F=None`` takes the two F
    reductions formed outside this function, summed there over the cells'
    shards on a mesh.

    Returns ``(total, terms)``; ``terms`` holds 0-d tensors for
    ``main_loss``, ``vg_reg``, ``kl_reg``, ``entropy_reg``, ``count_reg``,
    ``lambda_f_reg`` and ``total_loss``, NaN where the term's lambda is 0.
    """
    G, mask = data.G, data.gene_mask
    if mask is not None:
        G = G * mask[None, :]
    nan = torch.full((), float("nan"), dtype=torch.float32, device=Y.device)
    if f_sums is not None:
        sum_F_probs, sum_f_reg = f_sums
    else:
        F_probs = torch.sigmoid(F)
        sum_F_probs = torch.sum(F_probs)
        sum_f_reg = torch.sum(F_probs - F_probs * F_probs)
    terms = {}

    gv_sim = _masked_mean(cosine_similarity(Y, G, axis=0), mask)
    vg_sim = torch.mean(cosine_similarity(Y, G, axis=1))
    gv_term = lw.lambda_g1 * gv_sim
    vg_term = lw.lambda_g2 * vg_sim
    expression_term = gv_term + vg_term
    terms["main_loss"] = gv_term / lw.lambda_g1
    terms["vg_reg"] = vg_term / lw.lambda_g2 if lw.lambda_g2 != 0 else nan

    if data.d is not None:
        # the filtered marginal: (P ⊙ F).sum(cells) = σ(F) P = q (ref :512-514)
        density_term = lw.lambda_d * kl_div_sum(torch.log(q / sum_F_probs), data.d)
        terms["kl_reg"] = density_term / lw.lambda_d if lw.lambda_d != 0 else nan
    else:
        density_term = None
        terms["kl_reg"] = nan

    # sign quirk (ref :526): the constrained mapper reports Σ P log P where
    # the plain mapper reports −Σ P log P; the loss gains +λ_r·entropy alike
    entropy_term = lw.lambda_r * h_sum
    terms["entropy_reg"] = entropy_term / lw.lambda_r if lw.lambda_r != 0 else nan

    count_term = lw.lambda_count * torch.abs(sum_F_probs - data.target_count)
    terms["count_reg"] = (count_term / lw.lambda_count if lw.lambda_count != 0
                          else nan)

    f_reg = lw.lambda_f_reg * sum_f_reg
    terms["lambda_f_reg"] = f_reg / lw.lambda_f_reg if lw.lambda_f_reg != 0 else nan

    total = -expression_term - entropy_term + count_term + f_reg
    if density_term is not None:
        total = total + density_term
    terms["total_loss"] = total
    return total, terms


VAL_METRIC_KEYS = (
    "val_total_loss",
    "val_gene_sim",
    "val_sp_sparsity_weighted_sim",
    "val_entropy",
)


def val_metrics_from_projection(Y, G, h_mean, n_spots: int, gene_mask=None):
    """Validation metrics from the projection ``Y = Pᵀ S_val``, the
    measured val expression ``G`` and the mean per-cell ``h = Σ P log P``."""
    cos_g = cosine_similarity(Y, G, axis=0)
    gv_sim = _masked_mean(cos_g, gene_mask)
    vg_sim = torch.mean(cosine_similarity(Y, G, axis=1))
    gene_density = torch.sum(G != 0, dim=0) / G.shape[0]  # 1 − sparsity
    if gene_mask is not None:
        gene_density = gene_density * gene_mask
    sp_weighted = torch.sum(cos_g * gene_density) / torch.sum(gene_density)
    return {
        "val_total_loss": gv_sim + vg_sim,
        "val_gene_sim": gv_sim,
        "val_sp_sparsity_weighted_sim": sp_weighted,
        "val_entropy": -h_mean / math.log(n_spots),
    }


def val_metrics(M, S, G, gene_mask=None, impl: str = "auto"):
    """Validation metrics (reference ``_val_loss_fn``,
    ``mapping_optimizer.py:311-356``): expression similarity, gene-voxel
    similarity, sparsity-weighted similarity and the normalized mapping
    entropy, through :func:`mapper_core` with ``impl`` resolved for ``M``."""
    if gene_mask is not None:
        S = S * gene_mask[None, :]
        G = G * gene_mask[None, :]
    n_cells = M.shape[0]
    w = torch.full((n_cells,), 1.0 / n_cells, dtype=torch.float32, device=M.device)
    Y, _, h = mapper_core(M, S, w, impl)
    return val_metrics_from_projection(Y, G, torch.mean(h), M.shape[1],
                                       gene_mask=gene_mask)
