"""The PyTorch port's spot graphs against the JAX package's.

The weight matrices (``sparse_weights``, the four ``spatial_weights``
variants), the structured k-NN form (``neighbor_graph`` with and without
``max_neighbors``, ``neighbor_graph_from_dense``, ``transpose_arrays``),
``graph_matmul`` forward and backward, and the conversions of
``convert.py``, each on the same ``obsp`` or the same numpy arrays in both
packages. Then the graph builder itself, ``spatial_neighbors``, whose
ties the two packages break differently (ROADMAP queue C, "Graph ties").

Tolerances: the float64 weight matrices to 1e-12 (both packages run the
same scipy arithmetic); the padded graphs exactly (integer indices, f32
weights cast from the same float64); ``graph_matmul`` at rtol 1e-5 (f32,
sums in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu import datasets as jds
from tangram_tpu import spatial as jsw
from tangram_tpu.ops import core as jcore
from tangram_tpu.ops import losses as jl
from tangram_tpu_torch import datasets as tds
from tangram_tpu_torch import spatial as tsw
from tangram_tpu_torch.convert import mapper_data_from_jax, neighbor_graph_from_jax
from tangram_tpu_torch.ops import core as tcore

VARIANTS = [(True, True), (False, False), (True, False), (False, True)]


def spots(n=80, seed=3, **kw):
    """An AnnData of ``n`` random spots with the JAX package's graph in
    ``obsp``: both packages read this one graph."""
    rng = np.random.default_rng(seed)
    ad = tgt.AnnData(X=np.ones((n, 2), np.float32))
    ad.obsm["spatial"] = rng.random((n, 2))
    jsw.spatial_neighbors(ad, **kw)
    return ad


def assert_graphs_equal(got, want):
    for name in ("indices", "weights", "t_indices", "t_weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.indices.dtype == got.t_indices.dtype == torch.int64
    assert got.weights.dtype == got.t_weights.dtype == torch.float32


@pytest.mark.parametrize("standardized", [False, True])
def test_sparse_weights_match_jax(standardized):
    ad = spots()
    got = tsw.sparse_weights(ad, standardized)
    want = jsw.sparse_weights(ad, standardized)
    assert sp.isspmatrix_csr(got) and got.dtype == np.float64
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("standardized,self_inclusion", VARIANTS)
def test_spatial_weights_match_jax(standardized, self_inclusion):
    ad = spots()
    got = tsw.spatial_weights(ad, standardized, self_inclusion)
    want = jsw.spatial_weights(ad, standardized, self_inclusion)
    assert got.dtype == np.float64 and got.shape == (80, 80)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_standardized_self_inclusion_rows_sum_to_two():
    """The reference quirk: the identity is added after the normalization."""
    W = tsw.spatial_weights(spots(), True, True)
    np.testing.assert_allclose(W.sum(axis=1), 2.0, rtol=1e-12)
    np.testing.assert_allclose(np.diag(W), 1.0)


def test_weights_need_the_graph():
    ad = tgt.AnnData(X=np.ones((5, 2), np.float32))
    for build in (lambda: tsw.spatial_weights(ad, True, False),
                  lambda: tsw.neighbor_graph(ad, True, False)):
        with pytest.raises(ValueError, match="Missing spatial neighborhood"):
            build()


@pytest.mark.parametrize("standardized,self_inclusion", VARIANTS)
def test_neighbor_graph_matches_jax(standardized, self_inclusion):
    ad = spots(coord_type="delaunay")  # rows of unequal degree: padded slots
    got = tsw.neighbor_graph(ad, standardized, self_inclusion)
    want = jsw.neighbor_graph(ad, standardized, self_inclusion)
    assert_graphs_equal(got, want)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               tsw.spatial_weights(ad, standardized, self_inclusion),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("self_inclusion", [False, True])
def test_neighbor_graph_max_neighbors_truncates_like_jax(self_inclusion):
    ad = spots(coord_type="delaunay")
    with pytest.warns(UserWarning, match="max_neighbors=4 drops") as got_w:
        got = tsw.neighbor_graph(ad, True, self_inclusion, max_neighbors=4)
    with pytest.warns(UserWarning, match="max_neighbors=4 drops") as want_w:
        want = jsw.neighbor_graph(ad, True, self_inclusion, max_neighbors=4)
    assert str(got_w[0].message) == str(want_w[0].message)
    assert_graphs_equal(got, want)
    assert got.indices.shape[1] == 4
    if self_inclusion:
        # every row keeps its self edge, at weight 1
        rows = torch.arange(got.n_spots)[:, None]
        is_self = got.indices == rows
        assert bool(is_self.any(dim=1).all())
        assert bool((got.weights[is_self] == 1.0).all())


def test_neighbor_graph_max_neighbors_leaves_no_room():
    with pytest.raises(ValueError, match="beside the self edge"):
        tsw.neighbor_graph(spots(coord_type="delaunay"), True, True, max_neighbors=1)


@pytest.mark.parametrize("k", [None, 3])
def test_neighbor_graph_from_dense_matches_jax(k):
    W = tsw.spatial_weights(spots(coord_type="delaunay"), True, False)
    assert_graphs_equal(tcore.neighbor_graph_from_dense(W, k),
                        jcore.neighbor_graph_from_dense(W, k))


def test_transpose_arrays_match_jax():
    g = jsw.neighbor_graph(spots(coord_type="delaunay"), False, True)
    got = tcore.transpose_arrays(np.asarray(g.indices), np.asarray(g.weights))
    want = jcore.transpose_arrays(np.asarray(g.indices), np.asarray(g.weights))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_transpose", [True, False])
def test_row_and_col_sums_match_jax(with_transpose):
    g = jsw.neighbor_graph(spots(coord_type="delaunay"), True, True)
    if not with_transpose:
        g = g._replace(t_indices=None, t_weights=None)
    t = neighbor_graph_from_jax(g)
    np.testing.assert_allclose(t.row_sums().numpy(), np.asarray(g.row_sums()), rtol=1e-6)
    np.testing.assert_allclose(t.col_sums().numpy(), np.asarray(g.col_sums()), rtol=1e-6)


def graphs(kind):
    """(JAX W, the port's W) of one graph: dense, k-NN with and without the
    transpose, and a wide k-NN (k > 16: the gather-and-contract branch)."""
    if kind == "wide":
        rng = np.random.default_rng(5)
        W = (rng.random((60, 60)) * (rng.random((60, 60)) < 0.4)).astype(np.float32)
        jg = jcore.neighbor_graph_from_dense(W)
        assert jg.indices.shape[1] > 16
        return jg, neighbor_graph_from_jax(jg)
    ad = spots(n=60, coord_type="delaunay")
    if kind == "dense":
        W = tsw.spatial_weights(ad, True, True).astype(np.float32)
        return jnp.asarray(W), torch.from_numpy(W)
    jg = jsw.neighbor_graph(ad, True, True)
    if kind == "knn, no transpose":
        jg = jg._replace(t_indices=None, t_weights=None)
    return jg, neighbor_graph_from_jax(jg)


@pytest.mark.parametrize("kind", ["dense", "knn", "knn, no transpose", "wide"])
def test_graph_matmul_and_its_gradient_match_jax_vjp(kind):
    Wj, Wt = graphs(kind)
    rng = np.random.default_rng(6)
    X = rng.normal(0, 1, (60, 7)).astype(np.float32)
    ct = rng.normal(0, 1, (60, 7)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x: jcore.graph_matmul(Wj, x), jnp.asarray(X))
    (dX_j,) = vjp(jnp.asarray(ct))
    Xt = torch.from_numpy(X).requires_grad_()
    out_t = tgt.graph_matmul(Wt, Xt)
    (dX_t,) = torch.autograd.grad(out_t, (Xt,), torch.from_numpy(ct))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dX_t.numpy(), np.asarray(dX_j), rtol=1e-5, atol=1e-6)
    dense = Wt if kind == "dense" else Wt.to_dense()
    np.testing.assert_allclose(dX_t.numpy(), (dense.T @ torch.from_numpy(ct)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_graph_matmul_backward_is_the_transpose_gather():
    """With the transpose present, the backward is one more gather through
    it (no scatter-add): a transpose planted with other weights shows."""
    _, g = graphs("knn")
    X = torch.ones((g.n_spots, 3), requires_grad=True)
    ct = torch.ones((g.n_spots, 3))
    planted = g._replace(t_weights=2.0 * g.t_weights)
    (dX,) = torch.autograd.grad(tgt.graph_matmul(planted, X), (X,), ct)
    want = 2.0 * (g.to_dense().T @ ct)
    np.testing.assert_allclose(dX.numpy(), want.numpy(), rtol=1e-5)


def test_neighbor_graph_to_device_and_dtype():
    g = tsw.neighbor_graph(spots(), True, False).to("cpu", torch.float64)
    assert g.weights.dtype == g.t_weights.dtype == torch.float64
    assert g.indices.dtype == torch.int64
    assert g.to("cpu").weights.dtype == torch.float32


def test_mapper_data_from_jax_carries_graphs():
    jg = jsw.neighbor_graph(spots(n=40), True, False)
    W = jnp.asarray(np.eye(40, dtype=np.float32))
    rng = np.random.default_rng(1)
    ref = jnp.asarray(rng.random((40, 3), dtype=np.float32))
    jdata = jl.MapperData(
        S=jnp.ones((5, 3)), G=jnp.ones((40, 3)), voxel_weights=W,
        neighborhood_filter=jg, ct_encode=jnp.eye(5), spatial_weights=jg,
        getis_ord_ref=ref, moran_ref=ref, geary_ref=jnp.ones(3))
    data = mapper_data_from_jax(jdata)
    assert set(data._fields) == set(jdata._fields)
    assert isinstance(data.voxel_weights, torch.Tensor)
    np.testing.assert_array_equal(data.voxel_weights.numpy(), np.asarray(W))
    for name in ("neighborhood_filter", "spatial_weights"):
        assert isinstance(getattr(data, name), tgt.NeighborGraph)
        assert_graphs_equal(getattr(data, name), jg)
    for name in ("ct_encode", "getis_ord_ref", "moran_ref", "geary_ref"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)))


def test_one_hot_encoding_matches_jax():
    labels = ["b", "a", "c", "a", "b", "d"]
    for keep in (False, True):
        got = tgt.one_hot_encoding(labels, keep_aggregate=keep)
        want = tg.one_hot_encoding(labels, keep_aggregate=keep)
        assert list(got.columns) == list(want.columns) == (["cl"] if keep else []) + [
            "b", "a", "c", "d"]
        np.testing.assert_array_equal(got.values, want.values)


def test_public_names_match_the_jax_package():
    for name in ("NeighborGraph", "graph_matmul", "spatial_neighbors", "spatial_weights",
                 "neighbor_graph", "one_hot_encoding"):
        assert name in tgt.__all__ and hasattr(tg, name)
    assert tgt.spatial_weights is tsw.spatial_weights
    assert tgt.NeighborGraph is tcore.NeighborGraph


# ---------------------------------------------------------------------------
# graph ties (ROADMAP queue C): cKDTree against scikit-learn
# ---------------------------------------------------------------------------


def both_graphs(xy, **kw):
    ads = []
    for AnnData, build in ((tg.AnnData, tg.spatial_neighbors),
                           (tgt.AnnData, tgt.spatial_neighbors)):
        ad = AnnData(X=np.ones((len(xy), 2), np.float32))
        ad.obsm["spatial"] = xy
        build(ad, **kw)
        ads.append(ad)
    return ads


@pytest.mark.parametrize("n_neighs", [4, 6, 10])
def test_spatial_neighbors_identical_to_jax_without_ties(n_neighs):
    """Random coordinates have no distance ties: the same graph, bit for
    bit, in both packages."""
    xy = np.random.default_rng(n_neighs).random((300, 2))
    ad_j, ad_t = both_graphs(xy, n_neighs=n_neighs)
    for key in ("spatial_connectivities", "spatial_distances"):
        want, got = ad_j.obsp[key].tocsr(), ad_t.obsp[key].tocsr()
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data)


def test_hex_lattice_graphs_differ_only_among_ties():
    """The tutorial lattice: cKDTree and scikit-learn may keep different
    candidates where several tie at the k-th distance (border spots), as
    scikit-learn's own algorithms do among themselves. Every row keeps its
    degree, and where the rows differ, each neighbor in one graph and not
    the other lies at that row's k-th distance, as do the candidates of the
    other graph it replaces. The port's datasets give the JAX package's
    lattice."""
    xy = tds._hex_coords(1_000)
    np.testing.assert_array_equal(xy, jds._hex_coords(1_000))
    ad_j, ad_t = both_graphs(xy, coord_type="generic")
    Cj, Ct = (ad.obsp["spatial_connectivities"].tocsr() for ad in (ad_j, ad_t))
    np.testing.assert_array_equal(np.diff(Ct.indptr), np.diff(Cj.indptr))
    Dj = ad_j.obsp["spatial_distances"].tocsr()
    rows_apart = 0
    for i in range(len(xy)):
        nj = set(Cj.indices[Cj.indptr[i]:Cj.indptr[i + 1]])
        nt = set(Ct.indices[Ct.indptr[i]:Ct.indptr[i + 1]])
        if nj == nt:
            continue
        rows_apart += 1
        kth = Dj[i].data.max()
        for j in nj ^ nt:
            assert np.isclose(np.linalg.norm(xy[i] - xy[j]), kth, rtol=1e-9), (i, j)
    assert rows_apart < len(xy) // 10
