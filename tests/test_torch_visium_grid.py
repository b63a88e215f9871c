"""Visium hex-grid neighbor graphs (``coord_type="grid"``) of the port's
``spatial_neighbors`` against ``tests/test_visium_grid.py`` and the JAX
package's graphs.

Every case of ``tests/test_visium_grid.py`` runs on both packages
(parametrized by package name): hex-lattice adjacency and border degrees,
auto-selecting ``"grid"`` from ``uns["spatial"]``, ``pp_adatas``' auto
grid, ``n_rings``, radius and percentile pruning, Delaunay pruning and
parameter validation. Then the two packages' ``obsp`` are compared: in
grid mode, and wherever no two candidates tie at a row's k-th distance,
entry for entry; in generic mode on the hex lattice, where the border
spots' candidates tie, by the rule of ``tests/test_torch_spatial.py``:
each spot's sorted neighbor distances are equal. The grid graph's mapping
through every graph term is held to the JAX package's on the same graph
by the rule of the graph stack (``chip_smoke.py``'s ``GRAPH_SPREAD``): in
2-norm within 4 times the larger of the two packages' distance from
themselves when the cells are trained in another order.
"""

import contextlib
import importlib

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_recovery import cells_in_order

PACKAGES = ("tangram_tpu", "tangram_tpu_torch")
GRAPH_KEYS = ("spatial_connectivities", "spatial_distances")
GRAPH_SPREAD = 4.0


@pytest.fixture(params=PACKAGES)
def api(request):
    """One package's flat namespace."""
    return importlib.import_module(request.param)


def hex_lattice(n_rows, n_cols, pitch=1.0):
    """Row-staggered hexagonal lattice (the Visium array layout): every
    interior spot has exactly 6 equidistant neighbors at ``pitch``."""
    coords = []
    for r in range(n_rows):
        for c in range(n_cols):
            coords.append(((c + 0.5 * (r % 2)) * pitch, r * (np.sqrt(3.0) / 2.0) * pitch))
    return np.asarray(coords, dtype=np.float64)


def make_adata(api, coords, visium_metadata=False):
    n = coords.shape[0]
    ad = api.AnnData(X=np.ones((n, 2), np.float32),
                     obs=pd.DataFrame(index=[f"s{i}" for i in range(n)]))
    ad.obsm["spatial"] = coords
    if visium_metadata:
        ad.uns["spatial"] = {"library_1": {"images": {}, "scalefactors": {}}}
    return ad


def degrees(ad):
    return np.asarray(ad.obsp["spatial_connectivities"].sum(axis=1)).ravel()


# ---------------------------------------------------------------------------
# tests/test_visium_grid.py on both packages
# ---------------------------------------------------------------------------


def test_hex_lattice_adjacency(api):
    coords = hex_lattice(5, 6, pitch=2.5)
    ad = make_adata(api, coords)
    api.spatial_neighbors(ad, coord_type="grid")
    deg = degrees(ad)
    n_cols = 6
    idx = lambda r, c: r * n_cols + c  # noqa: E731
    conn = ad.obsp["spatial_connectivities"].tocsr()
    assert set(conn[idx(2, 3)].indices) == {idx(2, 2), idx(2, 4), idx(1, 2), idx(1, 3),
                                            idx(3, 2), idx(3, 3)}
    assert deg[idx(2, 3)] == 6
    assert set(conn[idx(0, 0)].indices) == {idx(0, 1), idx(1, 0)}
    coo = conn.tocoo()
    assert np.all(np.linalg.norm(coords[coo.row] - coords[coo.col], axis=1) <= 2.5 * 1.01)
    assert np.all(ad.obsp["spatial_distances"].data == 1.0)


def test_grid_vs_generic_on_borders(api):
    coords = hex_lattice(4, 4)
    ad_gen = make_adata(api, coords)
    api.spatial_neighbors(ad_gen, coord_type="generic")
    ad_grid = make_adata(api, coords)
    api.spatial_neighbors(ad_grid, coord_type="grid")
    deg_gen, deg_grid = degrees(ad_gen), degrees(ad_grid)
    assert deg_gen.max() >= 6
    assert deg_grid.min() < 6
    assert deg_grid.max() == 6
    assert (deg_grid <= deg_gen).all()


def test_auto_selects_grid_with_visium_metadata(api):
    coords = hex_lattice(4, 5)
    ad_visium = make_adata(api, coords, visium_metadata=True)
    api.spatial_neighbors(ad_visium)
    ad_plain = make_adata(api, coords)
    api.spatial_neighbors(ad_plain)
    assert degrees(ad_visium).min() < 6
    assert np.all(degrees(ad_plain) == 6)


def visium_pair(api, seed, n_rows, n_cols, n_genes, n_cells, labels=False):
    """A Visium-like spatial AnnData on a hex lattice (``uns["spatial"]``
    set) and a single-cell one, as ``tests/test_visium_grid.py`` builds
    them, through ``api``'s AnnData."""
    rng = np.random.default_rng(seed)
    coords = hex_lattice(n_rows, n_cols)
    n = coords.shape[0]
    genes = [f"g{i}" for i in range(n_genes)]
    ad_sp = api.AnnData(X=rng.poisson(3.0, (n, n_genes)).astype(np.float32) + 1.0,
                        obs=pd.DataFrame(index=[f"s{i}" for i in range(n)]),
                        var=pd.DataFrame(index=genes))
    ad_sp.obsm["spatial"] = coords
    ad_sp.uns["spatial"] = {"library_1": {}}
    X = rng.poisson(2.0, (n_cells, n_genes)).astype(np.float32) + 1.0
    obs = pd.DataFrame(index=[f"c{i}" for i in range(n_cells)])
    if labels:
        obs["subclass_label"] = pd.Categorical(rng.choice(["a", "b"], n_cells))
    ad_sc = api.AnnData(X=X, obs=obs, var=pd.DataFrame(index=genes))
    return ad_sc, ad_sp


def test_pp_adatas_auto_grid(api):
    ad_sc, ad_sp = visium_pair(api, 0, 4, 5, 6, 7)
    api.pp_adatas(ad_sc, ad_sp, genes=None)
    assert "spatial_connectivities" in ad_sp.obsp
    deg = degrees(ad_sp)
    assert deg.max() == 6 and deg.min() < 6


def test_grid_graph_is_symmetric(api):
    ad = make_adata(api, hex_lattice(5, 5))
    api.spatial_neighbors(ad, coord_type="grid")
    conn = ad.obsp["spatial_connectivities"]
    assert (conn != conn.T).nnz == 0


def test_n_rings_two_ring_hex(api):
    ad = make_adata(api, hex_lattice(9, 9), visium_metadata=True)
    api.spatial_neighbors(ad, n_rings=2)
    conn, dists = ad.obsp["spatial_connectivities"], ad.obsp["spatial_distances"]
    center = 4 * 9 + 4
    assert conn[center].nnz == 18
    row = dists[center].toarray().ravel()
    assert (row == 1.0).sum() == 6
    assert (row == 2.0).sum() == 12
    assert set(np.unique(dists.data)) <= {1.0, 2.0}


def test_n_rings_one_matches_default(api):
    coords = hex_lattice(6, 6)
    ad1 = make_adata(api, coords, visium_metadata=True)
    ad2 = make_adata(api, coords, visium_metadata=True)
    api.spatial_neighbors(ad1)
    api.spatial_neighbors(ad2, n_rings=1)
    assert (ad1.obsp["spatial_connectivities"] != ad2.obsp["spatial_connectivities"]).nnz == 0


def test_radius_float_generic(api):
    coords = np.random.default_rng(0).random((60, 2)) * 10
    ad = make_adata(api, coords)
    api.spatial_neighbors(ad, radius=2.5, coord_type="generic")
    dists = ad.obsp["spatial_distances"]
    assert dists.nnz > 0
    assert dists.data.max() <= 2.5
    assert dists.diagonal().sum() == 0
    assert (dists != dists.T).nnz == 0


def test_radius_interval_prunes_knn(api):
    coords = np.random.default_rng(1).random((60, 2)) * 10
    ad_all = make_adata(api, coords)
    api.spatial_neighbors(ad_all, n_neighs=6, coord_type="generic")
    lo, hi = 0.5, 1.5
    ad = make_adata(api, coords)
    api.spatial_neighbors(ad, n_neighs=6, coord_type="generic", radius=(lo, hi))
    d = ad.obsp["spatial_distances"]
    assert d.nnz < ad_all.obsp["spatial_distances"].nnz
    assert d.data.min() >= lo and d.data.max() <= hi


def test_percentile_prunes_longest_edges(api):
    coords = np.random.default_rng(2).random((80, 2)) * 10
    ad_all = make_adata(api, coords)
    api.spatial_neighbors(ad_all, n_neighs=6, coord_type="generic")
    ad = make_adata(api, coords)
    api.spatial_neighbors(ad, n_neighs=6, coord_type="generic", percentile=50.0)
    d_all, d = ad_all.obsp["spatial_distances"], ad.obsp["spatial_distances"]
    assert d.nnz <= d_all.nnz * 0.55
    assert d.data.max() <= np.percentile(d_all.data, 50.0) + 1e-12


def test_parameter_validation(api):
    coords = hex_lattice(4, 4)
    ad = make_adata(api, coords, visium_metadata=True)
    with pytest.raises(ValueError):
        api.spatial_neighbors(ad, percentile=50.0)
    with pytest.raises(ValueError):
        api.spatial_neighbors(ad, radius=1.0)
    with pytest.raises(ValueError):
        api.spatial_neighbors(make_adata(api, coords), coord_type="generic", n_rings=2)


def test_delaunay_percentile_prunes_long_edges(api):
    coords = np.random.default_rng(3).random((80, 2)) * 10
    ad_all = make_adata(api, coords)
    api.spatial_neighbors(ad_all, coord_type="generic", delaunay=True)
    ad = make_adata(api, coords)
    api.spatial_neighbors(ad, coord_type="generic", delaunay=True, percentile=50.0)
    d_all, d = ad_all.obsp["spatial_distances"], ad.obsp["spatial_distances"]
    assert d.nnz < d_all.nnz
    assert d.data.max() <= np.percentile(d_all.data, 50.0) + 1e-12


def test_delaunay_radius_interval_prunes(api):
    coords = np.random.default_rng(4).random((60, 2)) * 10
    ad = make_adata(api, coords)
    api.spatial_neighbors(ad, coord_type="generic", delaunay=True, radius=(0.3, 1.2))
    d = ad.obsp["spatial_distances"]
    assert d.nnz > 0
    assert d.data.min() >= 0.3 and d.data.max() <= 1.2


def test_delaunay_rejects_scalar_radius(api):
    ad = make_adata(api, np.random.default_rng(5).random((30, 2)) * 10)
    with pytest.raises(ValueError, match="scalar radius"):
        api.spatial_neighbors(ad, coord_type="generic", delaunay=True, radius=1.0)


# ---------------------------------------------------------------------------
# the two packages' graphs, entry for entry
# ---------------------------------------------------------------------------


def both_graphs(coords, visium_metadata=False, **kw):
    out = []
    for name in PACKAGES:
        api = importlib.import_module(name)
        ad = make_adata(api, coords, visium_metadata)
        api.spatial_neighbors(ad, **kw)
        out.append({key: ad.obsp[key].tocsr() for key in GRAPH_KEYS})
    return out


def assert_same_csr(got, want):
    got.sort_indices()
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


GRIDS = {
    "hex grid": (hex_lattice(7, 8, pitch=2.5), False, dict(coord_type="grid")),
    "hex auto grid": (hex_lattice(6, 5), True, {}),
    "hex two rings": (hex_lattice(9, 9), True, dict(n_rings=2)),
    "hex three rings": (hex_lattice(8, 7), True, dict(n_rings=3)),
    "odd corner rows": (hex_lattice(3, 11), True, {}),
    "delaunay": (np.random.default_rng(3).random((80, 2)) * 10, False,
                 dict(coord_type="generic", delaunay=True, percentile=50.0)),
    "radius": (np.random.default_rng(0).random((60, 2)) * 10, False,
               dict(coord_type="generic", radius=2.5)),
    "radius interval": (np.random.default_rng(1).random((60, 2)) * 10, False,
                        dict(coord_type="generic", n_neighs=6, radius=(0.5, 1.5))),
}


@pytest.mark.parametrize("case", list(GRIDS))
def test_graph_equals_jax_entry_for_entry(case):
    """No candidate ties at a row's cut: the same CSR matrices, on the hex
    lattice (grid mode: every first-ring neighbor is kept, so its ties do
    not choose) and on its borders."""
    coords, visium, kw = GRIDS[case]
    want, got = both_graphs(coords, visium, **kw)
    for key in GRAPH_KEYS:
        assert_same_csr(got[key], want[key])


@pytest.mark.parametrize("shape", [(4, 4), (6, 9)])
def test_generic_graph_on_the_hex_lattice_differs_only_among_ties(shape):
    """Generic k-NN on the hex lattice: border spots have more candidates
    at their 6th distance than places, and the two neighbor searches may
    keep different ones (the rule of tests/test_torch_spatial.py): each
    spot's degree and sorted neighbor distances are equal."""
    want, got = both_graphs(hex_lattice(*shape), coord_type="generic")
    conn_j, conn_t = want["spatial_connectivities"], got["spatial_connectivities"]
    np.testing.assert_array_equal(np.diff(conn_t.indptr), np.diff(conn_j.indptr))
    d_j = want["spatial_distances"].tolil().data
    d_t = got["spatial_distances"].tolil().data
    for row_j, row_t in zip(d_j, d_t):
        np.testing.assert_allclose(sorted(row_t), sorted(row_j), rtol=1e-12)


# ---------------------------------------------------------------------------
# the mapping on the grid graph, through every graph term
# ---------------------------------------------------------------------------

GRID_TERMS = dict(lambda_neighborhood_g1=0.5, lambda_ct_islands=0.3, lambda_getis_ord=0.2,
                  lambda_moran=0.2, lambda_geary=0.2)


def grid_mapping(api, perm=None, terms=GRID_TERMS):
    """``tests/test_visium_grid.py``'s end-to-end mapping (18 cells on a 5 ×
    5 hex lattice, 8 genes, the five graph terms) through ``api``;
    ``perm`` trains the cells in that order
    (``test_torch_recovery.cells_in_order``) and puts the mapping's rows
    back."""
    ad_sc, ad_sp = visium_pair(api, 1, 5, 5, 8, 18, labels=True)
    api.pp_adatas(ad_sc, ad_sp)
    assert degrees(ad_sp).min() < 6
    kw = dict(device="cpu") if api.__name__ == "tangram_tpu_torch" else {}
    module = importlib.import_module(f"{api.__name__}.mapping")
    with cells_in_order(module, perm) if perm is not None else contextlib.nullcontext():
        ad_map = api.map_cells_to_space(
            ad_sc, ad_sp, mode="cells", density_prior="uniform", num_epochs=15,
            random_state=1, cluster_label="subclass_label", verbose=False, **terms, **kw)
    X = np.asarray(ad_map.X, dtype=np.float64)
    if perm is not None:
        X = X[np.argsort(perm)]
    return ad_map, X, ad_sp


def test_mapping_with_spatial_regularizers_on_grid_graph(api):
    ad_map, X, _ = grid_mapping(api)
    np.testing.assert_allclose(X.sum(axis=1), 1.0, rtol=1e-5)
    assert np.isfinite(ad_map.uns["training_history"]["main_loss"]).all()


def test_grid_mapping_matches_jax_within_graph_spread():
    """The port's mapping on the grid graph against the JAX package's: both
    build the same graph (test_graph_equals_jax_entry_for_entry) and start
    from the same logits. Its 2-norm distance stays within GRAPH_SPREAD
    times the witness, the larger of the two packages' distance from
    themselves with the 18 cells trained in reverse order, each from its
    own start (sums over cells then run in another order). The control: the
    port without its weakest-biting term (Geary's C, ~0.07 away) is far
    outside that bound."""
    import tangram_tpu as tg
    import tangram_tpu_torch as tgt

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        map_j, X_j, sp_j = grid_mapping(tg)
        map_t, X_t, sp_t = grid_mapping(tgt)
        for key in GRAPH_KEYS:
            assert_same_csr(sp_t.obsp[key].tocsr(), sp_j.obsp[key].tocsr())
        perm = np.arange(18)[::-1].copy()
        witness = max(np.linalg.norm(grid_mapping(tg, perm)[1] - X_j),
                      np.linalg.norm(grid_mapping(tgt, perm)[1] - X_t))
        no_geary = dict(GRID_TERMS, lambda_geary=0.0)
        X_control = grid_mapping(tgt, terms=no_geary)[1]
    finally:
        torch.set_num_threads(threads)
    assert witness > 0
    assert np.linalg.norm(X_t - X_j) <= GRAPH_SPREAD * witness
    assert np.linalg.norm(X_control - X_j) > 100 * GRAPH_SPREAD * witness
    for key in ("main_loss", "total_loss"):
        np.testing.assert_allclose(map_t.uns["training_history"][key],
                                   map_j.uns["training_history"][key], rtol=3e-4, atol=3e-5)
