"""Plain Tangram: the reference that decides a cell's ``correct``.

Written from the published method (broadinstitute/Tangram,
``mapping_utils.py`` and ``mapping_optimizer.py``), in plain NumPy and
PyTorch, importing nothing of the program. It works out again, from the
inputs the benchmark made (sparse counts as plain CSR arrays), everything
the program derives from them: the training genes, the density prior, the
cluster aggregates, the seeded start, every Adam step, the mapping and the
per-gene training scores.

The loss of a cells × spots logit matrix M (λ_g1 = 1; λ_d = 1 with a
density prior d), with P = softmax(M) by rows:

    G_pred = Pᵀ S                      (spots × genes)
    q      = w P                       (spots; w = 1/cells, or the cluster shares)
    loss   = −mean_g cos(G_pred[:, g], G[:, g]) + Σ_s d_s (log d_s − log q_s)

Its gradient in M is the softmax VJP g = P ⊙ (dP − r), dP = S dYᵀ + w dqᵀ,
r = rowsum(P ⊙ dP), with (dY, dq) the gradient of the loss in (G_pred, q),
taken by autograd on that small function alone. Adam is PyTorch's (β =
(0.9, 0.999), ε = 1e-8 after the square root, bias-corrected). The steps
run over blocks of cells, so that a large mapping fits beside nothing else
on the card.

:class:`Precision` states the storage: the type M and the moments are kept
in (rounded to nearest after each step) and the rounding of the two
contractions' operands: ``"float32"`` (TF32 off), ``"tf32"`` (each operand
rounded to TF32's 10-bit mantissa, as a TF32 matmul takes it) or
``"bfloat16"``. ``Precision("float64", "float64", "float64")`` runs the
whole reference in float64, the yardstick the tests hold it to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch

__all__ = ["Precision", "FP32", "preprocess", "cluster_aggregate", "numpy_init", "loss",
           "Trainer", "gene_scores", "softmax_rows", "tf32_round", "JobResult", "run_job"]

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest value with TF32's 10 explicit mantissa bits (ties
    to even), kept in f32."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -0x2000).view(torch.float32)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


_ROUND = {"float32": lambda x: x, "float64": lambda x: x, "tf32": tf32_round,
          "bfloat16": _bf16_round}
_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclass(frozen=True)
class Precision:
    param: str = "float32"  # storage of M
    moments: str = "float32"  # storage of Adam's mu and nu
    operands: str = "float32"  # rounding of the contractions' operands


FP32 = Precision()


def compute_dtype(precision: Precision) -> torch.dtype:
    """float64 for the float64 reference, float32 otherwise."""
    return torch.float64 if precision.param == "float64" else torch.float32


def _row_of(X) -> np.ndarray:
    """The row of each stored entry of the CSR matrix ``X``."""
    return np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))


def _dense_columns(X, cols) -> np.ndarray:
    """The columns ``cols`` of the CSR matrix ``X``, dense f32, in that order."""
    slot = np.full(X.shape[1], -1, dtype=np.int64)
    slot[np.asarray(cols, dtype=np.int64)] = np.arange(len(cols))
    j = slot[X.indices]
    taken = j >= 0
    out = np.zeros((X.shape[0], len(cols)), dtype=np.float32)
    out[_row_of(X)[taken], j[taken]] = X.data[taken]
    return out


def preprocess(markers, genes_sc, X_sc, genes_sp, X_sp):
    """Tangram's ``pp_adatas(genes=markers)`` and the slicing of
    ``map_cells_to_space`` on plain CSR arrays (``generators.Csr``): genes
    expressed in no cell (spot) dropped on each side, names lowercased, the
    training genes the markers found on both sides, in the markers' order.
    Returns (training gene names, S (cells × genes), G (spots × genes) dense
    f32, the rna-count density of the spots over every gene)."""
    def kept(genes, X):
        seen = np.bincount(X.indices[X.data != 0], minlength=X.shape[1]) >= 1
        return {g.lower(): j for j, g in enumerate(genes) if seen[j]}

    col_sc, col_sp = kept(genes_sc, X_sc), kept(genes_sp, X_sp)
    genes = [g for g in dict.fromkeys(m.lower() for m in markers) if g in col_sc and g in col_sp]
    S = _dense_columns(X_sc, [col_sc[g] for g in genes])
    G = _dense_columns(X_sp, [col_sp[g] for g in genes])
    counts = np.bincount(_row_of(X_sp), weights=X_sp.data, minlength=X_sp.shape[0])
    return genes, S, G, counts / counts.sum()


def cluster_aggregate(S, labels):
    """Tangram's ``adata_to_cluster_expression(scale=True)``: one row per
    label, in ``value_counts`` order, summing its cells; and each label's
    share of the cells."""
    shares = pd.Series(labels).value_counts(normalize=True)
    codes = pd.Series(labels).map({c: i for i, c in enumerate(shares.index)}).to_numpy()
    summed = np.zeros((len(shares), S.shape[1]), dtype=np.float64)
    np.add.at(summed, codes, np.asarray(S, dtype=np.float64))
    return summed.astype(np.float32), shares.to_numpy(dtype=np.float64)


def numpy_init(cells: int, spots: int, random_state: int) -> np.ndarray:
    """The mapper's start: ``np.random.seed(random_state)`` (when nonzero),
    then N(0, 1) logits drawn in float64 and cast to float32."""
    if random_state:
        np.random.seed(seed=random_state)
    return np.random.normal(0, 1, (cells, spots)).astype(np.float32)


def _cosine_columns(a, b):
    return (a * b).sum(0) / (torch.linalg.vector_norm(a, dim=0) * torch.linalg.vector_norm(b, dim=0))


def loss(Y, q, G, d):
    """(total, main) of the projection Y (spots × genes) and the marginal
    q (spots,): −mean gene cosine, plus the density KL when d is given."""
    main = _cosine_columns(Y, G).mean()
    total = -main
    if d is not None:
        pos = d > 0
        total = total + torch.sum(torch.where(pos, d * (torch.log(torch.where(pos, d, 1.0))
                                                         - torch.log(q)), 0.0))
    return total, main


def softmax_rows(M: torch.Tensor) -> torch.Tensor:
    return torch.softmax(M.to(torch.promote_types(M.dtype, torch.float32)), dim=1)


class Trainer:
    """Adam on the logits M (cells × spots) of the mapping of S onto (G, d),
    in blocks of cells of at most 2^28 entries. ``M`` is taken as the start
    and updated in place in ``precision.param``."""

    def __init__(self, M, S, G, d, w, lr: float, precision: Precision = FP32):
        self.p = precision
        self.M = M.to(_DTYPE[precision.param])
        self.mu = torch.zeros(M.shape, dtype=_DTYPE[precision.moments], device=M.device)
        self.nu = torch.zeros_like(self.mu)
        self.S, self.G, self.d, self.w = S, G, d, w
        self.lr, self.t = float(lr), 0
        self.block = min(M.shape[0], max(1, (1 << 28) // max(M.shape[1], 1)))
        self.rnd = _ROUND[precision.operands]
        self.cdt = compute_dtype(precision)

    def _blocks(self):
        for r0 in range(0, self.M.shape[0], self.block):
            yield slice(r0, min(r0 + self.block, self.M.shape[0]))

    def step(self):
        """One Adam step. Returns (total, main) of the loss before the step
        as floats."""
        Y = torch.zeros(self.G.shape, dtype=self.cdt, device=self.M.device)
        q = torch.zeros(self.G.shape[0], dtype=self.cdt, device=self.M.device)
        blocks = list(self._blocks())
        for b in blocks:
            P = softmax_rows(self.M[b])
            Y += self.rnd(P).T @ self.rnd(self.S[b])
            q += self.w[b] @ P
        with torch.enable_grad():
            Yv, qv = Y.requires_grad_(), q.requires_grad_()
            total, main = loss(Yv, qv, self.G, self.d)
            dY, dq = torch.autograd.grad(total, (Yv, qv))
        dY = self.rnd(dY)
        self.t += 1
        bc1, bc2 = 1.0 - BETA1 ** self.t, 1.0 - BETA2 ** self.t
        for b in blocks:
            # one block: P of the forward serves the backward too
            P = P if len(blocks) == 1 else softmax_rows(self.M[b])
            dP = (self.rnd(self.S[b]) @ dY.T).addr_(self.w[b], dq)
            g = dP.sub_((P * dP).sum(dim=1, keepdim=True)).mul_(P)
            M, mu, nu = (x[b].to(self.cdt) for x in (self.M, self.mu, self.nu))
            mu.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            nu.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            M.addcdiv_(mu, nu.div(bc2).sqrt_().add_(EPS), value=-self.lr / bc1)
            for store, x in ((self.M, M), (self.mu, mu), (self.nu, nu)):
                if store.dtype != self.cdt:  # else updated in place already
                    store[b] = x.to(store.dtype)
        return float(total.detach()), float(main.detach())

    def mapping(self) -> torch.Tensor:
        """softmax(M) by rows, f32."""
        return torch.cat([softmax_rows(self.M[b]) for b in self._blocks()])


def gene_scores(P: torch.Tensor, S: torch.Tensor, G: torch.Tensor, precision: str = "float32"):
    """Each gene's training score: the cosine, in float64, between the
    spots' projected expression Pᵀ S (an f32 product, its operands rounded
    as ``precision`` says) and the measured G."""
    rnd = _ROUND[precision]
    Y = (rnd(P).T @ rnd(S)).double()
    return _cosine_columns(Y, G.double()).cpu().numpy()


@dataclass
class JobResult:
    """What a mapping job hands its user."""

    mapping: torch.Tensor  # (cells or clusters, spots) f32 on the device
    scores: dict  # training gene -> training score
    total_loss: np.ndarray  # (epochs,) before each step


def run_job(markers, genes_sc, X_sc, labels, genes_sp, X_sp, mode: str, density_prior: str,
            epochs: int, lr: float, random_state: int, device,
            precision: Precision = FP32) -> JobResult:
    """One whole Tangram mapping (``pp_adatas(genes=markers)``, then
    ``map_cells_to_space`` with the given mode and prior, λ_g1 = 1) of the
    single-cell counts ``X_sc`` (CSR; labels ``labels``, a pandas
    Categorical, for clusters mode) onto ``X_sp`` (CSR)."""
    genes, S, G, density = preprocess(markers, genes_sc, X_sc, genes_sp, X_sp)
    if mode == "clusters":
        S, w = cluster_aggregate(S, labels)
    elif mode == "cells":
        w = np.full(S.shape[0], 1.0 / S.shape[0])
    else:
        raise ValueError(f"mode {mode!r}")
    if density_prior == "rna_count_based":
        d = density
    elif density_prior == "uniform":
        d = np.full(G.shape[0], 1.0 / G.shape[0])
    else:
        raise ValueError(f"density_prior {density_prior!r}")

    def dev(x):
        return torch.tensor(np.asarray(x), device=device, dtype=compute_dtype(precision))

    S_t, G_t = dev(S), dev(G)
    M = dev(numpy_init(S.shape[0], G.shape[0], random_state))
    trainer = Trainer(M, S_t, G_t, dev(d), dev(w), lr, precision)
    total = np.array([trainer.step()[0] for _ in range(int(epochs))])
    P = trainer.mapping()
    scores = dict(zip(genes, gene_scores(P, S_t, G_t, precision.operands)))
    return JobResult(mapping=P, scores=scores, total_loss=total)
