"""Spatial neighbor graphs of the spots and their weight matrices.

The counterpart of ``tangram_tpu/spatial.py``, host-side numpy and scipy:

* ``spatial_neighbors`` (``pp_adatas`` calls it whenever ``obsm["spatial"]``
  is present) writes ``obsp['spatial_connectivities']`` and
  ``obsp['spatial_distances']``. Its nearest-neighbor queries run on
  :class:`scipy.spatial.cKDTree` instead of scikit-learn, so the port needs
  nothing beyond numpy and scipy here. Where several candidates tie at the
  k-th distance (lattice borders), the k-NN graph keeps the lower spot
  indices (:data:`TIE_RESOLUTION`), where scikit-learn keeps whichever its
  algorithm meets first; off ties the graphs are identical. The graph is
  an input of the graph terms: two runs compared with each other take the
  same ``obsp``.
* ``sparse_weights`` and ``spatial_weights`` turn that graph into the
  reference's weight matrices (``spatial_weights.py:5-29``), in CSR and as
  a dense float64 array.
* ``neighbor_graph`` gives the structured k-NN form
  (:class:`~tangram_tpu_torch.ops.core.NeighborGraph`), so that W @ X never
  needs the dense s × s matrix.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

from .ops.core import NeighborGraph, graph_from_arrays

__all__ = ["spatial_neighbors", "sparse_weights", "spatial_weights", "neighbor_graph"]


#: a lattice neighbor sits at 1× the grid pitch; the second hex ring starts
#: at √3 ≈ 1.73× (2× for square grids) — any cutoff between leaves exactly
#: the first ring
_GRID_RING_CUTOFF = 1.3

#: two distances from a spot tie when they round to the same multiple of
#: this share of the coordinates' largest magnitude (lattice spots lie at
#: equal distances but for the float rounding of their coordinates); a tie
#: goes to the lower spot index
TIE_RESOLUTION = 1e-9


def _nearest(coords, k: int) -> np.ndarray:
    """(n, k) indices of each spot's ``k`` nearest other spots, nearest
    first, ties by :data:`TIE_RESOLUTION` to the lower index. The self
    edge is left out by identity, so a duplicated coordinate does not
    crowd it out. Candidates come from a k-d tree, twice as many as asked
    for, and more while the last one still ties with the k-th."""
    n = len(coords)
    if k <= 0:
        return np.zeros((n, 0), dtype=np.int64)
    quantum = TIE_RESOLUTION * max(float(np.abs(coords).max()), np.finfo(np.float64).tiny)
    tree, own = cKDTree(coords), np.arange(n)[:, None]
    m = min(n, 2 * (k + 1))
    while True:
        _, idx = tree.query(coords, k=m)
        idx = np.asarray(idx, dtype=np.int64).reshape(n, m)
        key = np.round(np.linalg.norm(coords[idx] - coords[:, None, :], axis=-1) / quantum)
        key[idx == own] = np.inf
        order = np.lexsort((idx, key), axis=-1)
        kth = np.take_along_axis(key, order[:, k - 1:k], axis=1)[:, 0]
        # every spot outside the candidates is at least as far as the
        # farthest candidate other than the spot itself
        farthest = np.where(idx == own, -np.inf, key).max(axis=1)
        if m == n or (kth < farthest).all():
            return np.take_along_axis(idx, order[:, :k], axis=1)
        m = min(n, 2 * m)


def spatial_neighbors(
    adata_sp,
    n_neighs: int = 6,
    coord_type: Optional[str] = None,
    delaunay: bool = False,
    set_diag: bool = False,
    spatial_key: str = "spatial",
    radius=None,
    percentile: Optional[float] = None,
    n_rings: int = 1,
):
    """Compute a spot adjacency graph from ``obsm[spatial_key]`` coordinates.

    Writes ``obsp['spatial_connectivities']`` (binary CSR) and
    ``obsp['spatial_distances']`` (CSR). The parameters follow
    ``squidpy.gr.spatial_neighbors``:

    * ``coord_type="generic"`` — k-nearest-neighbor graph, euclidean
      distances; of candidates tied at the k-th distance the lower spot
      indices are kept (:data:`TIE_RESOLUTION`). ``radius`` as a float
      switches to a fixed-radius graph; as an ``(rmin, rmax)`` pair it
      prunes the KNN edges to that interval.
      ``percentile`` prunes edges longer than that percentile.
    * ``"grid"`` — Visium-style lattice adjacency: of the ``n_neighs``
      nearest candidates only those within the first lattice ring are kept;
      ``n_rings`` extends adjacency to the n-th ring (distance = ring index).
    * ``"delaunay"`` — Delaunay triangulation adjacency.
    * ``None`` — ``"grid"`` when ``uns["spatial"]`` carries Visium metadata,
      ``"generic"`` otherwise.
    """
    if spatial_key not in adata_sp.obsm:
        raise ValueError(
            f"Missing spatial coordinates in `obsm[{spatial_key!r}]`."
        )
    if coord_type is None:
        uns = getattr(adata_sp, "uns", {})
        coord_type = "grid" if "spatial" in uns else "generic"
    delaunay_active = delaunay or coord_type == "delaunay"
    if percentile is not None and coord_type != "generic" and not delaunay_active:
        raise ValueError(
            "percentile is only valid with coord_type='generic' or a "
            "Delaunay graph (delaunay=True / coord_type='delaunay')."
        )
    if radius is not None and coord_type != "generic" and not delaunay_active:
        raise ValueError(
            "radius is only valid with coord_type='generic' or a "
            "Delaunay graph (delaunay=True / coord_type='delaunay')."
        )
    if n_rings > 1 and coord_type != "grid":
        raise ValueError("n_rings > 1 is only valid with coord_type='grid'.")
    coords = np.asarray(adata_sp.obsm[spatial_key], dtype=np.float64)
    n = coords.shape[0]

    if delaunay_active:
        from scipy.spatial import Delaunay

        if np.isscalar(radius) and radius is not None:
            raise ValueError(
                "a scalar radius selects a radius-neighbors graph and "
                "cannot be combined with delaunay=True; pass a (rmin, rmax) "
                "tuple to prune Delaunay edges by distance interval."
            )
        tri = Delaunay(coords)
        indptr, indices = tri.vertex_neighbor_vertices
        rows = np.repeat(np.arange(n), np.diff(indptr))
        cols = indices
        d = np.linalg.norm(coords[rows] - coords[cols], axis=1)
        if radius is not None:
            rmin, rmax = radius
            keep = (d >= float(rmin)) & (d <= float(rmax))
            rows, cols, d = rows[keep], cols[keep], d[keep]
        if percentile is not None and len(d):
            keep = d <= np.percentile(d, percentile)
            rows, cols, d = rows[keep], cols[keep], d[keep]
    elif np.isscalar(radius):
        # fixed-radius graph (squidpy: radius as a single float)
        idx = cKDTree(coords).query_ball_point(coords, r=float(radius))
        counts = np.asarray([len(ix) for ix in idx])
        rows = np.repeat(np.arange(n), counts)
        cols = (np.concatenate(idx).astype(np.int64)
                if len(idx) else np.zeros(0, np.int64))
        keep = rows != cols  # drop self-edges
        rows, cols = rows[keep], cols[keep]
        d = np.linalg.norm(coords[rows] - coords[cols], axis=1)
    else:
        k = min(n_neighs + 1, n)
        rows = np.repeat(np.arange(n), k - 1)
        cols = _nearest(coords, k - 1).reshape(-1)
        d = np.linalg.norm(coords[rows] - coords[cols], axis=1)

        if coord_type == "grid" and len(d):
            # lattice pitch = the median nearest-neighbor distance; keep
            # only first-ring edges
            nearest = d.reshape(n, k - 1)[:, 0]
            pitch = float(np.median(nearest))
            keep = d <= pitch * _GRID_RING_CUTOFF
            rows, cols = rows[keep], cols[keep]
            d = np.ones(keep.sum(), dtype=np.float64)  # ring index
        elif radius is not None:
            rmin, rmax = radius
            keep = (d >= float(rmin)) & (d <= float(rmax))
            rows, cols, d = rows[keep], cols[keep], d[keep]
        elif percentile is not None:
            keep = d <= np.percentile(d, percentile)
            rows, cols, d = rows[keep], cols[keep], d[keep]

    conn = sp.csr_matrix((np.ones_like(d, dtype=np.float64), (rows, cols)), shape=(n, n))
    dists = sp.csr_matrix((d, (rows, cols)), shape=(n, n))
    conn.sum_duplicates()
    dists.sum_duplicates()
    conn.data[:] = 1.0

    if coord_type == "grid" and n_rings > 1:
        # BFS by boolean matrix powers of the 1-ring adjacency: ring r =
        # spots first reachable in r hops; distance entries = ring index
        one_ring = conn.copy()
        seen = (conn + sp.eye(n, format="csr")).sign().tocsr()
        dists = conn.copy()
        frontier = conn
        for r in range(2, n_rings + 1):
            reach = (frontier @ one_ring).sign().tocsr()
            new = (reach - reach.multiply(seen)).tocsr()
            new.eliminate_zeros()
            if new.nnz == 0:
                break
            conn = (conn + new).sign().tocsr()
            dists = (dists + new * r).tocsr()
            seen = (seen + new).sign().tocsr()
            frontier = new

    if set_diag:
        conn = conn + sp.eye(n, format="csr")

    adata_sp.obsp["spatial_connectivities"] = conn
    adata_sp.obsp["spatial_distances"] = dists
    return adata_sp


def _require_graph(adata_sp):
    if not {"spatial_connectivities", "spatial_distances"}.issubset(
        set(adata_sp.obsp.keys())
    ):
        raise ValueError(
            "Missing spatial neighborhood parameters. Run `pp_adatas()` with "
            "the spatial information stored in `spatial` in `adata_sp.obsm`."
        )


def sparse_weights(adata_sp, standardized: bool) -> sp.csr_matrix:
    """The spot-graph weight matrix in CSR form, float64: the binary
    connectivities, or with ``standardized`` the distances scaled to unit
    row L1 norm and masked to the connectivity pattern."""
    _require_graph(adata_sp)
    conn = sp.csr_matrix(adata_sp.obsp["spatial_connectivities"], dtype=np.float64)
    if not standardized:
        return conn.sign().tocsr()
    dists = sp.csr_matrix(adata_sp.obsp["spatial_distances"], dtype=np.float64)
    row_sums = np.asarray(np.abs(dists).sum(axis=1)).ravel()
    scale = np.divide(1.0, row_sums, out=np.zeros_like(row_sums), where=row_sums != 0)
    return (sp.diags(scale) @ dists).multiply(conn.sign()).tocsr()


def spatial_weights(adata_sp, standardized: bool, self_inclusion: bool) -> np.ndarray:
    """Dense spot × spot float64 weight matrix, as the reference's
    ``spatial_weights.py:5-29`` computes it: :func:`sparse_weights`, with
    ``self_inclusion`` the identity added *after* the normalization (a
    reference quirk, kept: standardized + self-inclusion rows sum to 2).

    The variants the graph terms use: (True, True) neighborhood-g1,
    (False, False) cell-type islands, (True, False) Moran and Geary,
    (False, True) Getis-Ord.
    """
    W = sparse_weights(adata_sp, standardized).toarray()
    if self_inclusion:
        # in place: np.eye would make a second dense (s × s) array
        W[np.diag_indices_from(W)] += 1.0
    return W


def neighbor_graph(adata_sp, standardized: bool, self_inclusion: bool,
                   max_neighbors: Optional[int] = None) -> NeighborGraph:
    """The structured (s, k) form of :func:`spatial_weights`: the same
    W @ X products without the dense s × s matrix, as a
    :class:`~tangram_tpu_torch.ops.core.NeighborGraph` of CPU tensors (f32
    weights) with its transpose.

    ``max_neighbors`` caps the padded row width ``k``. Where the cap
    truncates a row, the row keeps its largest-``|weight|`` edges (the self
    edge of ``self_inclusion`` always keeps its slot) and a warning says
    how many edges were dropped: the products are then approximations.
    """
    _require_graph(adata_sp)
    W = sparse_weights(adata_sp, standardized)
    n = W.shape[0]

    nnz = np.diff(W.indptr)
    rows = np.repeat(np.arange(n), nnz)
    k = (int(nnz.max()) if n else 0) + (1 if self_inclusion else 0)
    data, cols = W.data, W.indices
    if max_neighbors is not None and k > int(max_neighbors):
        k = int(max_neighbors)
        k_edges = k - 1 if self_inclusion else k
        if k_edges <= 0:
            raise ValueError(
                "max_neighbors leaves no room for graph edges"
                + (" beside the self edge" if self_inclusion else "")
            )
        # each row's entries by descending |weight|, so that truncation
        # keeps the heaviest edges
        order = np.lexsort((-np.abs(W.data), rows))
        data, cols = W.data[order], W.indices[order]
        dropped = int(np.maximum(nnz - k_edges, 0).sum())
        if dropped:
            warnings.warn(
                f"max_neighbors={max_neighbors} drops {dropped} graph "
                f"edge(s) (keeping each row's {k_edges} largest-|weight| "
                "ones); W @ X products are approximate. Raise max_neighbors "
                "for exact parity with spatial_weights().",
                stacklevel=2,
            )
    k_edges = k - 1 if self_inclusion else k

    # CSR → padded (s, k) in one scatter: each stored entry goes to (its
    # row, its position within the row); entries past k_edges are dropped
    indices = np.zeros((n, k), dtype=np.int64)
    weights = np.zeros((n, k), dtype=np.float32)
    slots = np.arange(W.nnz) - np.repeat(W.indptr[:-1], nnz)
    keep = slots < k_edges
    indices[rows[keep], slots[keep]] = cols[keep]
    weights[rows[keep], slots[keep]] = data[keep]
    if self_inclusion:
        # the self edge after each row's kept entries (its slot reserved)
        kept = np.minimum(nnz, k_edges)
        indices[np.arange(n), kept] = np.arange(n)
        weights[np.arange(n), kept] = 1.0
    return graph_from_arrays(indices, weights)
