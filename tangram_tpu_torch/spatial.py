"""Spatial neighbor graph of the spots: ``spatial_neighbors``.

The counterpart of ``tangram_tpu/spatial.py:spatial_neighbors``, which
``pp_adatas`` calls whenever ``obsm["spatial"]`` is present. The nearest-
neighbor queries run on :class:`scipy.spatial.cKDTree` instead of
scikit-learn, so the port needs nothing beyond numpy and scipy here. Where
several candidates tie at the k-th distance (lattice borders), the two
libraries may keep different ones; off ties the graphs are identical.

The weight matrices and the structured k-NN form that consume this graph
(``spatial_weights``, ``neighbor_graph``) belong to the spatial-regularizer
slice and are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

__all__ = ["spatial_neighbors"]


#: a lattice neighbor sits at 1× the grid pitch; the second hex ring starts
#: at √3 ≈ 1.73× (2× for square grids) — any cutoff between leaves exactly
#: the first ring
_GRID_RING_CUTOFF = 1.3


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
      distances. ``radius`` as a float switches to a fixed-radius graph; as
      an ``(rmin, rmax)`` pair it prunes the KNN edges to that interval.
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
        _, idx = cKDTree(coords).query(coords, k=k)
        idx = np.asarray(idx).reshape(n, k)
        # Drop each point's self-edge by identity, not position: with
        # duplicated coordinates a tied zero-distance neighbor may come
        # before the point itself.
        is_self = idx == np.arange(n)[:, None]
        missing_self = ~is_self.any(axis=1)
        # rows whose self entry got crowded out by >k zero-distance
        # duplicates: drop one tied zero-distance column instead
        is_self[missing_self, 0] = True
        rows = np.repeat(np.arange(n), k - 1)
        cols = idx[~is_self]
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
