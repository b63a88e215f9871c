"""Plain Tangram with its five spatial graph terms: the reference that
decides ``correct`` in a cell whose configuration has a ``graph`` block.

Written from the published method (broadinstitute/Tangram:
``mapping_utils.py::pp_adatas``, which builds the spot graph with squidpy's
``spatial_neighbors`` at its generic default of 6 neighbours, lines
95-100; ``map_cells_to_space``'s weight variants, lines 317-329, from
``spatial_weights.py``; ``mapping_optimizer.py``'s ``_loss_fn``, lines
189-309, and ``_spatial_local_indicators``, lines 159-187), in plain NumPy
and PyTorch, importing nothing of the program. The preprocessing, the
density prior, the seeded start and the training scores are
:mod:`.tangram`'s.

**The spot graph** (:func:`nearest`): each spot's ``n_neighs`` nearest
other spots by euclidean distance. Two distances tie when they round to
the same multiple of :data:`TIE_RESOLUTION` of the coordinates' largest
magnitude, and a tie goes to the lower spot index. The benchmark's spots
lie on an exact hex lattice, whose border spots have several candidates at
the n-th distance, equal but for the float rounding of the coordinates;
upstream leaves the choice among them to its search algorithm.

**The weight variants** (``spatial_weights.py``): *standardized*, each
edge's distance over the sum of its row's distances; else the binary
connectivities; *self_inclusion* adds 1 on the diagonal afterwards. The
neighbourhood term takes (standardized, self), the islands (binary, no
self); Moran's and Geary's (standardized, no self) and Getis-Ord's
(binary, self) share one slot, which upstream fills in that order, so with
Getis-Ord on all three take Getis-Ord's variant.

**The loss** of the logits M (SURVEY §2.2), P = softmax(M) by rows:

    G_pred = Pᵀ S,  ct_map = Pᵀ C                  (C: one-hot cell types)
    main     = mean_g cos(G_pred[:, g], G[:, g])
    density  = KL(d ‖ P.sum(0) / cells), summed
    nb       = mean_g cos((W_v G_pred)[:, g], (W_v G)[:, g])
    islands  = mean(max(ct_map − W_f ct_map, 0))
    Getis-Ord G* = (W X) / X.sum(0)
    Moran's I    = n · z ⊙ (W z) / (z²).sum(0),          z = X − mean(X)
    Geary's C    = Σ_ij w_ij (X_i − X_j)² / (2 m2),       m2 = (z²).sum(0) / (n − 1)
    total = −λ_g1 main + λ_d density + λ_ct islands − λ_nb nb
            − λ_go cos(G*) − λ_mo cos(I) − λ_ge cos(C)

each indicator of X = G once (the reference indicators) and of X = G_pred
every step, each of its terms the mean over genes of the cosine of the
two (Geary's: the one cosine of the two gene vectors). **One departure**:
Geary's sum runs over the graph's stored edges, w_ij (X_i − X_j)² for each,
where upstream broadcasts a (spots × spots × genes) tensor, 96 GB at 9,852
spots × 249 genes in f32. The sum is the same: a pair with w_ij = 0 adds
nothing.

Every step is autograd through the materialized softmax and Adam is
``torch.optim.Adam``, as upstream runs it. The two contractions take their
operands as ``operands`` says (:data:`.tangram._ROUND`: ``"float32"`` with
TF32 off, or ``"tf32"``, each operand of the forward and backward products
rounded to TF32), in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

from .tangram import _ROUND, gene_scores, numpy_init, preprocess

__all__ = ["TIE_RESOLUTION", "GRAPH_KEYS", "nearest", "Graph", "spot_graphs", "indicators",
           "SpatialLoss", "SpatialResult", "run_job"]

#: distances that round to the same multiple of this share of the
#: coordinates' largest magnitude tie; a tie goes to the lower spot index
TIE_RESOLUTION = 1e-9
#: the graph terms' histories, as the program names them
GRAPH_KEYS = ("gv_neighborhood_sim", "ct_island_penalty", "getis_ord_sim", "moran_sim",
              "geary_sim")


def nearest(coords, n_neighs: int, block: int = 1024) -> np.ndarray:
    """(spots, k) indices of each spot's k = min(n_neighs, spots − 1)
    nearest other spots, nearest first, ties as the module docstring
    says: every distance of a block of rows, each keyed by (its rounded
    distance, the spot's index)."""
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    k = min(int(n_neighs), n - 1)
    quantum = TIE_RESOLUTION * max(float(np.abs(coords).max()), np.finfo(np.float64).tiny)
    out = np.empty((n, k), dtype=np.int64)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        d = np.sqrt(sum((coords[r0:r1, j, None] - coords[None, :, j]) ** 2
                        for j in range(coords.shape[1])))
        key = np.round(d / quantum).astype(np.int64) * n + np.arange(n)
        key[np.arange(r1 - r0), np.arange(r0, r1)] = np.iinfo(np.int64).max  # not itself
        part = np.argpartition(key, k - 1, axis=1)[:, :k] if k else np.zeros((r1 - r0, 0), int)
        out[r0:r1] = np.take_along_axis(
            part, np.argsort(np.take_along_axis(key, part, axis=1), axis=1), axis=1)
    return out


@dataclass(frozen=True)
class Graph:
    """A spot × spot weight matrix as its stored edges (row, col, weight)."""

    rows: torch.Tensor  # (edges,) int64
    cols: torch.Tensor  # (edges,) int64
    weights: torch.Tensor  # (edges,)
    spots: int

    def __matmul__(self, X):
        """W @ X: each row the weighted sum of its edges' rows of X."""
        return torch.zeros((self.spots, X.shape[1]), dtype=X.dtype, device=X.device).index_add(
            0, self.rows, self.weights.to(X.dtype)[:, None] * X[self.cols])

    def to_dense(self) -> torch.Tensor:
        W = torch.zeros((self.spots, self.spots), dtype=self.weights.dtype,
                        device=self.weights.device)
        return W.index_put_((self.rows, self.cols), self.weights, accumulate=True)


def spot_graphs(coords, n_neighs: int, device, dtype=torch.float32) -> dict:
    """The three weight variants upstream builds with every graph term on,
    by the slot that takes each: ``voxel_weights`` (standardized, self),
    ``neighborhood_filter`` (binary, no self), ``spatial_weights`` (binary,
    self: Getis-Ord's, which upstream writes after Moran's and Geary's)."""
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    nn = nearest(coords, n_neighs)
    rows = np.repeat(np.arange(n), nn.shape[1])
    cols = nn.reshape(-1)
    dist = np.sqrt(((coords[rows] - coords[cols]) ** 2).sum(axis=-1))
    row_sum = np.bincount(rows, weights=dist, minlength=n)
    standardized = dist / row_sum[rows]
    binary = np.ones_like(dist)

    def graph(weights, self_inclusion):
        r, c, w = rows, cols, weights
        if self_inclusion:
            own = np.arange(n)
            r, c, w = np.concatenate([r, own]), np.concatenate([c, own]), \
                np.concatenate([w, np.ones(n)])
        return Graph(torch.as_tensor(r, device=device), torch.as_tensor(c, device=device),
                     torch.as_tensor(w, dtype=dtype, device=device), n)

    return {"voxel_weights": graph(standardized, True),
            "neighborhood_filter": graph(binary, False),
            "spatial_weights": graph(binary, True)}


def indicators(X, W: Graph):
    """(Getis-Ord G*, Moran's I, Geary's C) of each column of X (spots ×
    genes) on W: (spots, genes), (spots, genes), (genes,); Geary's sum
    over W's stored edges."""
    n = X.shape[0]
    getis = (W @ X) / X.sum(dim=0)
    z = X - X.mean(dim=0)
    moran = n * z * (W @ z) / (z * z).sum(dim=0)
    m2 = (z * z).sum(dim=0) / (n - 1)
    pairs = (W.weights.to(X.dtype)[:, None] * (X[W.rows] - X[W.cols]) ** 2).sum(dim=0)
    return getis, moran, pairs / (2 * m2)


class _Contraction(torch.autograd.Function):
    """Pᵀ A with its VJP A dYᵀ, each product's operands rounded by ``rnd``
    (the identity in f32: ``P.T @ A`` and autograd's own VJP)."""

    @staticmethod
    def forward(ctx, P, A, rnd):
        ctx.rnd = rnd
        ctx.save_for_backward(A)
        return rnd(P).T @ rnd(A)

    @staticmethod
    def backward(ctx, dY):
        (A,) = ctx.saved_tensors
        return ctx.rnd(A) @ ctx.rnd(dY).T, None, None


def _cos(a, b):
    """Upstream's ``torch.nn.CosineSimilarity(dim=0)``, averaged."""
    return F.cosine_similarity(a, b, dim=0).mean()


class SpatialLoss:
    """The loss of the module docstring for S (cells × genes), the one-hot
    types C (cells × types), G (spots × genes), the density d and the
    graphs of :func:`spot_graphs`; ``lambdas`` maps upstream's argument
    names (``lambda_g1``, ``lambda_d``, ``lambda_neighborhood_g1``,
    ``lambda_ct_islands``, ``lambda_getis_ord``, ``lambda_moran``,
    ``lambda_geary``) to their values, a term on where its lambda is > 0."""

    def __init__(self, S, C, G, d, graphs: dict, lambdas: dict, operands: str = "float32"):
        self.S, self.C, self.G, self.d = S, C, G, d
        self.lam = {k: float(v) for k, v in lambdas.items()}
        self.graphs, self.rnd = graphs, _ROUND[operands]
        W = graphs["spatial_weights"]
        self.refs = indicators(G, W)
        self.WG = graphs["voxel_weights"] @ G

    def __call__(self, M):
        """(total, terms) at the logits M; ``terms`` holds the main score
        and each graph term's value (NaN where it is off), as 0-d
        tensors."""
        lam, nan = self.lam, torch.tensor(float("nan"))
        P = torch.softmax(M, dim=1)
        G_pred = _Contraction.apply(P, self.S, self.rnd)
        main = _cos(G_pred, self.G)
        total = -lam["lambda_g1"] * main
        if lam.get("lambda_d", 0) > 0:
            q = P.sum(dim=0) / P.shape[0]
            total = total + lam["lambda_d"] * F.kl_div(torch.log(q), self.d, reduction="sum")
        terms = dict.fromkeys(GRAPH_KEYS, nan)
        if lam.get("lambda_neighborhood_g1", 0) > 0:
            terms["gv_neighborhood_sim"] = _cos(self.graphs["voxel_weights"] @ G_pred, self.WG)
            total = total - lam["lambda_neighborhood_g1"] * terms["gv_neighborhood_sim"]
        if lam.get("lambda_ct_islands", 0) > 0:
            ct_map = _Contraction.apply(P, self.C, self.rnd)
            excess = ct_map - self.graphs["neighborhood_filter"] @ ct_map
            terms["ct_island_penalty"] = torch.maximum(excess, torch.zeros_like(excess)).mean()
            total = total + lam["lambda_ct_islands"] * terms["ct_island_penalty"]
        on = [lam.get(k, 0) > 0 for k in ("lambda_getis_ord", "lambda_moran", "lambda_geary")]
        if any(on):
            preds = indicators(G_pred, self.graphs["spatial_weights"])
            for key, lam_key, ref, pred, is_on in zip(
                    GRAPH_KEYS[2:], ("lambda_getis_ord", "lambda_moran", "lambda_geary"),
                    self.refs, preds, on):
                if is_on:
                    terms[key] = _cos(ref, pred)
                    total = total - lam[lam_key] * terms[key]
        terms["main_loss"] = main
        terms["total_loss"] = total
        return total, terms


@dataclass
class SpatialResult:
    """What a mapping job hands its user, and the histories the check
    compares."""

    mapping: torch.Tensor  # (cells, spots) f32 on the device
    scores: dict  # training gene -> training score
    total_loss: np.ndarray  # (epochs,) before each step
    terms: dict  # GRAPH_KEYS -> (epochs,) before each step


def one_hot(labels) -> np.ndarray:
    """(cells, types) f32 indicators of the types present, in
    first-appearance order (upstream's ``one_hot_encoding``)."""
    labels = pd.Series(np.asarray(labels))
    return np.stack([(labels == t).to_numpy() for t in labels.unique()], axis=1).astype(
        np.float32)


def run_job(markers, genes_sc, X_sc, labels, genes_sp, X_sp, coords, graph: dict,
            density_prior: str, epochs: int, lr: float, random_state: int, device,
            operands: str = "float32") -> SpatialResult:
    """One whole cells-mode Tangram mapping with the graph terms
    (``pp_adatas(genes=markers)`` with the spot coordinates ``coords``,
    then ``map_cells_to_space`` with λ_g1 = 1, the prior, and ``graph``:
    the configuration's block, its lambdas under upstream's names and its
    ``n_neighs``) of the single-cell counts ``X_sc`` (CSR, with ``labels``)
    onto ``X_sp`` (CSR)."""
    genes, S, G, density = preprocess(markers, genes_sc, X_sc, genes_sp, X_sp)
    if density_prior == "rna_count_based":
        d = density
    elif density_prior == "uniform":
        d = np.full(G.shape[0], 1.0 / G.shape[0])
    else:
        raise ValueError(f"density_prior {density_prior!r}")

    def dev(x):
        return torch.tensor(np.asarray(x), device=device, dtype=torch.float32)

    S_t, G_t = dev(S), dev(G)
    lambdas = {k: v for k, v in graph.items() if k.startswith("lambda_")}
    lambdas.update(lambda_g1=1.0, lambda_d=1.0)
    loss = SpatialLoss(S_t, dev(one_hot(labels)), G_t, dev(d),
                       spot_graphs(coords, graph["n_neighs"], device), lambdas, operands)
    M = dev(numpy_init(S.shape[0], G.shape[0], random_state)).requires_grad_()
    opt = torch.optim.Adam([M], lr=lr)
    total, terms = [], {k: [] for k in GRAPH_KEYS}
    with torch.enable_grad():
        for _ in range(int(epochs)):
            opt.zero_grad(set_to_none=True)
            value, parts = loss(M)
            value.backward()
            opt.step()
            total.append(value.detach())
            for k in GRAPH_KEYS:
                terms[k].append(parts[k].detach().to(value.device))
    with torch.no_grad():
        P = torch.softmax(M.detach(), dim=1)
    scores = dict(zip(genes, gene_scores(P, S_t, G_t, operands)))
    return SpatialResult(mapping=P, scores=scores,
                         total_loss=torch.stack(total).double().cpu().numpy(),
                         terms={k: torch.stack(v).double().cpu().numpy()
                                for k, v in terms.items()})
