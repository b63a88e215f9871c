"""The benchmark's data, made from the seed.

:func:`synthetic_pair` is a frozen copy of ``tangram_tpu_torch/datasets.py::
synthetic_mapping_pair`` (itself a copy of ``tangram_tpu/datasets.py``) as
of the commit that added this benchmark, numpy only, returning plain arrays
in place of AnnData objects: the same draws in the same order, so a seed
gives the same counts. The program may change its own generator; this copy
stays as it is, so the benchmark's data do not move under a later change.

:func:`tutorial_pair` is the benchmark's own: it puts :func:`synthetic_pair`'s
counts in the marker columns of sparse single-cell and spatial matrices as
wide as a published dataset pair, the other genes drawn on a torch device
as sparse background counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticPair", "synthetic_pair", "Csr", "TutorialPair", "tutorial_pair"]


@dataclass
class SyntheticPair:
    """The statistical stand-in of a single-cell / spatial pair."""

    X_sc: np.ndarray  # (cells, genes) float32 counts
    labels: np.ndarray  # (cells,) int type index of each cell
    X_sp: np.ndarray  # (spots, genes) float32 counts
    coords: np.ndarray  # (spots, 2) float64 hex-lattice coordinates
    genes: list  # gene names, "gene0", ...
    types: list  # type names, "type0", ...


def _hex_coords(n_spots: int, pitch: float = 1.0) -> np.ndarray:
    side = int(np.ceil(np.sqrt(n_spots)))
    coords = []
    for r in range(side + 1):
        for c in range(side + 1):
            coords.append(((c + 0.5 * (r % 2)) * pitch,
                           r * (np.sqrt(3.0) / 2.0) * pitch))
    return np.asarray(coords[:n_spots], dtype=np.float64)


def _nb_counts(rng, mean, dispersion):
    lam = rng.gamma(shape=dispersion, scale=np.maximum(mean, 1e-12) / dispersion)
    return rng.poisson(lam)


def synthetic_pair(n_cells: int, n_spots: int, n_genes: int, n_types: int,
                   random_state: int, sc_depth: float = 1.2, sp_depth: float = 3.0,
                   dropout: float = 0.35, marker_logfold: float = 1.8) -> SyntheticPair:
    """Negative-binomial counts with snRNA-style dropout on the single-cell
    side and spatially smooth type fractions on a hex lattice on the
    spatial side; every gene is observed on both sides."""
    rng = np.random.default_rng(random_state)
    genes = [f"gene{i}" for i in range(n_genes)]
    types = [f"type{t}" for t in range(n_types)]

    base = np.exp(rng.normal(loc=-1.0, scale=1.4, size=n_genes))
    n_marked = rng.integers(1, 4, size=n_genes)
    logfold = np.zeros((n_types, n_genes))
    for g in range(n_genes):
        marked = rng.choice(n_types, size=n_marked[g], replace=False)
        logfold[marked, g] = rng.normal(marker_logfold, 0.4, size=n_marked[g])
    mu = base[None, :] * np.exp(logfold)
    dispersion = np.exp(rng.normal(loc=0.0, scale=0.7, size=n_genes)) * 0.8

    type_props = rng.dirichlet(np.full(n_types, 3.0))
    labels = rng.choice(n_types, size=n_cells, p=type_props)
    lib_sc = np.exp(rng.normal(0.0, 0.45, size=n_cells)) * sc_depth
    X_sc = _nb_counts(rng, lib_sc[:, None] * mu[labels], dispersion[None, :]).astype(np.float32)
    p_keep = 1.0 - dropout * np.exp(-0.5 * base)[None, :]
    X_sc *= rng.random(X_sc.shape) < p_keep

    coords = _hex_coords(n_spots)
    span = coords.max(axis=0) - coords.min(axis=0)
    centers = coords.min(axis=0) + rng.random((n_types, 2)) * span
    scales = (0.15 + 0.25 * rng.random(n_types)) * span.mean()
    d2 = ((coords[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    field = np.exp(-0.5 * d2 / scales[None, :] ** 2) + 0.02
    fractions = field * type_props[None, :]
    fractions /= fractions.sum(axis=1, keepdims=True)

    lib_sp = np.exp(rng.normal(0.0, 0.35, size=n_spots)) * sp_depth
    mean_sp = lib_sp[:, None] * (fractions @ mu)
    X_sp = _nb_counts(rng, mean_sp, dispersion[None, :]).astype(np.float32)

    for X in (X_sc, X_sp):
        dead = ~X.any(axis=0)
        if dead.any():
            X[rng.integers(0, X.shape[0], size=int(dead.sum())), np.nonzero(dead)[0]] = 1.0
    return SyntheticPair(X_sc=X_sc, labels=labels, X_sp=X_sp, coords=coords,
                         genes=genes, types=types)


@dataclass
class Csr:
    """A compressed-sparse-row matrix as plain arrays: row ``i`` holds
    ``data[indptr[i]:indptr[i + 1]]`` in the columns ``indices[...]``,
    ascending; no stored zeros."""

    indptr: np.ndarray  # (rows + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray  # (nnz,) float32
    shape: tuple


@dataclass
class TutorialPair:
    """A single-cell / spatial pair as wide as a published one."""

    X_sc: Csr  # (cells, genes_sc) counts
    genes_sc: list
    labels: np.ndarray  # (cells,) int type index of each cell
    types: list
    X_sp: Csr  # (spots, genes_sp) counts
    genes_sp: list
    coords: np.ndarray  # (spots, 2)
    markers: list  # the marker genes asked for, in their order


def _sparse_rows(dense_marks: np.ndarray, mark_cols: np.ndarray, rate: np.ndarray, gen,
                 device, block: int) -> Csr:
    """Rows of ``len(rate)`` genes: column j detected with probability
    ``rate[j]`` at a count 1 + ⌊Exp(1)⌋, the columns ``mark_cols`` taking
    ``dense_marks`` instead; drawn on ``device`` in blocks of rows."""
    import torch

    rows, width = dense_marks.shape[0], len(rate)
    p = torch.as_tensor(rate, dtype=torch.float32, device=device)
    cols = torch.as_tensor(mark_cols, dtype=torch.int64, device=device)
    counts, indices, data = [], [], []
    for r0 in range(0, rows, block):
        n = min(block, rows - r0)
        hit = torch.rand((n, width), generator=gen, device=device) < p
        u = torch.rand((n, width), generator=gen, device=device)
        x = torch.where(hit, torch.floor(1.0 - torch.log1p(-u)), 0.0)
        x[:, cols] = torch.as_tensor(dense_marks[r0:r0 + n], device=device)
        nz = x.nonzero()
        counts.append(torch.bincount(nz[:, 0], minlength=n).cpu())
        indices.append(nz[:, 1].to(torch.int32).cpu())
        data.append(x[nz[:, 0], nz[:, 1]].cpu())
        del hit, u, x, nz
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(torch.cat(counts).numpy(), out=indptr[1:])
    return Csr(indptr=indptr, indices=torch.cat(indices).numpy(), data=torch.cat(data).numpy(),
               shape=(rows, width))


def _rates(rng, width: int, detected: float) -> np.ndarray:
    """Per-gene detection rates, log-normal about ``detected`` (mean), at
    most 0.95."""
    return np.minimum(0.95, detected * np.exp(rng.normal(0.0, 1.0, width) - 0.5))


def tutorial_pair(cells: int, spots: int, genes_sc: int, genes_sp: int, markers: int,
                  shared_markers: int, types: int, seed: int, sc_detected: float,
                  sp_detected: float, device="cpu", block: int = 2048) -> TutorialPair:
    """A pair shaped as a published one: ``cells`` × ``genes_sc`` single-cell
    counts and ``spots`` × ``genes_sp`` spatial counts, sparse, whose genes
    are named ``Gene00000``, ... on the single-cell side (the spatial genes a
    subset of them, in that order). ``markers`` marker genes, at random
    columns, carry :func:`synthetic_pair`'s counts (the same seed); the first
    ``shared_markers`` of them are on the spatial side too, the rest only on
    the single-cell side. Every other gene is background detected at about
    ``sc_detected`` (``sp_detected``) of the rows. The background is drawn on
    ``device`` by a ``torch.Generator`` seeded with ``seed``."""
    import torch

    core = synthetic_pair(cells, spots, markers, types, random_state=seed)
    rng = np.random.default_rng([int(seed), 1])
    names = [f"Gene{i:05d}" for i in range(genes_sc)]
    mark_sc = rng.choice(genes_sc, size=markers, replace=False)
    others = np.setdiff1d(np.arange(genes_sc), mark_sc)
    sp_cols = np.sort(np.concatenate([
        mark_sc[:shared_markers],
        rng.choice(others, size=genes_sp - shared_markers, replace=False)]))
    mark_sp = np.searchsorted(sp_cols, mark_sc[:shared_markers])
    rate_sc, rate_sp = _rates(rng, genes_sc, sc_detected), _rates(rng, genes_sp, sp_detected)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    X_sc = _sparse_rows(core.X_sc, mark_sc, rate_sc, gen, device, block)
    X_sp = _sparse_rows(core.X_sp[:, :shared_markers], mark_sp, rate_sp, gen, device, block)
    return TutorialPair(X_sc=X_sc, genes_sc=names, labels=core.labels, types=core.types,
                        X_sp=X_sp, genes_sp=[names[j] for j in sp_cols], coords=core.coords,
                        markers=[names[j] for j in mark_sc])
