"""The PyTorch port's deconvolution chain and annotation utilities against
the JAX package's, case for case with ``tests/test_deconvolution.py``.

The chain (``create_segment_cell_df`` → ``count_cell_annotations`` →
``deconvolve_cell_annotations``, with ``project_cell_annotations`` and
``cell_type_mapping``) is host code: on one shared ``adata_map`` built from
numpy the two packages must give equal frames, exactly. The whole chain
from each package's own ``map_cells_to_space`` runs on a fixture whose
top-spot margin exceeds the mapping tolerance (the two mappings agree to
~1e-5 here, not bit for bit), so the argmax counts cannot flip on a
near-tie; the test checks that margin before it compares. The spot-graph
cases of the JAX file (``neighbor_graph``, ``spatial_weights``,
``graph_format="knn"``, Delaunay, duplicate coordinates, the transpose
VJP) are held to the JAX package on the same inputs.
"""

import gzip
import pickle
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu.ops import core as jcore
from tangram_tpu_torch.ops import core as tcore

N_CELLS, N_SPOTS, N_GENES = 30, 8, 12


def make_inputs(seed=0):
    """The numpy inputs of the JAX file's fixture: expression, labels, spot
    coordinates, per-spot segmentation counts and centroids, and a mapping
    (Dirichlet rows, shared by both packages)."""
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (N_CELLS, N_GENES)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (N_SPOTS, N_GENES)) + 1).astype(np.float32)
    labels = rng.choice(["a", "b"], N_CELLS)
    coords = rng.random((N_SPOTS, 2)) * 100
    seg_labels = rng.integers(1, 5, N_SPOTS)
    centroids = [[tuple(rng.random(2) * 100) for _ in range(n)] for n in seg_labels]
    M = rng.dirichlet(np.ones(N_SPOTS) * 0.3, size=N_CELLS).astype(np.float32)
    return dict(S=S, G=G, labels=labels, coords=coords, seg_labels=seg_labels,
                centroids=centroids, M=M)


def build(pkg, inp, with_map=True):
    """(ad_sc, ad_sp, ad_map) in package ``pkg`` from ``make_inputs``."""
    n_cells, n_genes = inp["S"].shape
    n_spots = inp["G"].shape[0]
    genes = pd.DataFrame(index=[f"g{i}" for i in range(n_genes)])
    ad_sc = pkg.AnnData(
        X=inp["S"].copy(),
        obs=pd.DataFrame({"cell_type": pd.Categorical(inp["labels"])},
                         index=[f"c{i}" for i in range(n_cells)]),
        var=genes.copy())
    spot_index = [f"s{i}" for i in range(n_spots)]
    ad_sp = pkg.AnnData(X=inp["G"].copy(), obs=pd.DataFrame(index=spot_index),
                        var=genes.copy())
    ad_sp.obsm["spatial"] = inp["coords"].copy()
    ad_sp.obsm["image_features"] = pd.DataFrame(
        {"segmentation_label": inp["seg_labels"].copy(),
         "segmentation_centroid": pd.Series(list(inp["centroids"]), index=spot_index)},
        index=spot_index)
    ad_map = None
    if with_map:
        ad_map = pkg.AnnData(X=inp["M"].copy(), obs=ad_sc.obs.copy(),
                             var=ad_sp.obs.copy())
    return ad_sc, ad_sp, ad_map


@pytest.fixture
def pair():
    inp = make_inputs()
    return build(tg, inp), build(tgt, inp)


def assert_series_of_arrays_equal(got, want):
    assert list(got.index) == list(want.index)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_create_segment_cell_df(pair):
    (_, j_sp, _), (_, t_sp, _) = pair
    tg.create_segment_cell_df(j_sp)
    tgt.create_segment_cell_df(t_sp)
    seg = t_sp.uns["tangram_cell_segmentation"]
    pd.testing.assert_frame_equal(seg, j_sp.uns["tangram_cell_segmentation"])
    assert len(seg) == int(t_sp.obsm["image_features"]["segmentation_label"].sum())
    assert_series_of_arrays_equal(t_sp.obsm["tangram_spot_centroids"],
                                  j_sp.obsm["tangram_spot_centroids"])


def test_create_segment_requires_image_features():
    for pkg in (tg, tgt):
        with pytest.raises(ValueError, match="image_features"):
            pkg.create_segment_cell_df(pkg.AnnData(X=np.ones((3, 2))))


def run_counts(pair, F_out=None, threshold=0.5):
    tables = []
    for pkg, (ad_sc, ad_sp, ad_map) in zip((tg, tgt), pair):
        if F_out is not None:
            ad_map.obs["F_out"] = F_out
        pkg.create_segment_cell_df(ad_sp)
        pkg.count_cell_annotations(ad_map, ad_sc, ad_sp, annotation="cell_type",
                                   threshold=threshold)
        tables.append(ad_sp.obsm["tangram_ct_count"])
    pd.testing.assert_frame_equal(tables[1], tables[0])
    return tables[1]


def test_count_cell_annotations(pair):
    df = run_counts(pair)
    assert {"x", "y", "cell_n", "centroids", "a", "b"} <= set(df.columns)
    assert df[["a", "b"]].to_numpy().sum() == N_CELLS
    # the argmax count, written out
    inp = make_inputs()
    types = list(pd.unique(inp["labels"]))
    want = np.zeros((N_SPOTS, len(types)), np.int64)
    np.add.at(want, (inp["M"].argmax(1), [types.index(t) for t in inp["labels"]]), 1)
    np.testing.assert_array_equal(df[types].to_numpy(), want)


def test_count_cell_annotations_with_filter(pair):
    F_out = np.linspace(0, 1, N_CELLS)
    df = run_counts(pair, F_out=F_out)
    assert df[["a", "b"]].to_numpy().sum() == int((F_out > 0.5).sum())


def test_deconvolve_cell_annotations(pair):
    segments = []
    for pkg, (ad_sc, ad_sp, ad_map) in zip((tg, tgt), pair):
        pkg.create_segment_cell_df(ad_sp)
        pkg.project_cell_annotations(ad_map, ad_sp, annotation="cell_type")
        pkg.count_cell_annotations(ad_map, ad_sc, ad_sp, annotation="cell_type")
        segments.append(pkg.deconvolve_cell_annotations(ad_sp))
    want, got = segments
    assert isinstance(got, tgt.AnnData)
    pd.testing.assert_frame_equal(got.obs, want.obs)
    np.testing.assert_array_equal(got.obsm["spatial"], want.obsm["spatial"])
    assert got.obsm["spatial"].shape[1] == 2
    assert set(got.obs["cluster"]) <= {"a", "b"}
    # with a filter of annotations
    pd.testing.assert_frame_equal(
        tgt.deconvolve_cell_annotations(pair[1][1], filter_cell_annotation=["b"]).obs,
        tg.deconvolve_cell_annotations(pair[0][1], filter_cell_annotation=["b"]).obs)


def test_df_to_cell_types():
    df = pd.DataFrame({
        "a": [2, 0],
        "b": [1, 1],
        "centroids": [np.array(["c0", "c1", "c2"], dtype=object),
                      np.array(["c3"], dtype=object)],
    })
    out = tgt.df_to_cell_types(df, ["a", "b"])
    assert out == tg.df_to_cell_types(df, ["a", "b"])
    assert out["a"] == ["c0", "c1"]
    assert out["b"] == ["c2", "c3"]
    # counts past a spot's objects clamp, as in JAX
    rng = np.random.default_rng(4)
    df = pd.DataFrame({
        "a": rng.integers(0, 4, 20), "b": rng.integers(0, 4, 20),
        "centroids": [np.array([f"o{i}_{j}" for j in range(rng.integers(0, 6))],
                               dtype=object) for i in range(20)]})
    assert tgt.df_to_cell_types(df, ["b", "a"]) == tg.df_to_cell_types(df, ["b", "a"])


def test_read_pickle_plain_and_gzip(tmp_path):
    obj = {"x": [1, 2, 3]}
    plain = tmp_path / "o.pkl"
    with open(plain, "wb") as f:
        pickle.dump(obj, f)
    gz = tmp_path / "o.pkl.gz"
    with gzip.open(gz, "wb") as f:
        pickle.dump(obj, f)
    for path in (plain, gz):
        assert tgt.read_pickle(path) == tg.read_pickle(path) == obj


def spots(n, seed, **kw):
    rng = np.random.default_rng(seed)
    ad = tgt.AnnData(X=np.ones((n, 3), np.float32))
    ad.obsm["spatial"] = rng.random((n, 2))
    tg.spatial_neighbors(ad, **kw)  # one graph, read by both packages
    return ad


def test_neighbor_graph_matches_dense():
    ad = spots(25, 1)
    X = np.random.default_rng(2).normal(size=(25, 4)).astype(np.float32)
    for std, incl in [(True, True), (False, False), (True, False), (False, True)]:
        W = tgt.spatial_weights(ad, standardized=std, self_inclusion=incl)
        np.testing.assert_array_equal(W, tg.spatial_weights(ad, std, incl))
        graph = tgt.neighbor_graph(ad, standardized=std, self_inclusion=incl)
        got = tcore.graph_matmul(graph, torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, W @ X, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(graph.row_sums().numpy(), W.sum(1), rtol=1e-5)
        np.testing.assert_allclose(graph.col_sums().numpy(), W.sum(0), rtol=1e-5)


def test_neighbor_graph_max_neighbors_truncation():
    from tangram_tpu_torch.spatial import sparse_weights

    ad = spots(30, 3)
    nnz = int(np.diff(sparse_weights(ad, standardized=True).indptr).max())
    X = np.random.default_rng(5).normal(size=(30, 4)).astype(np.float32)
    for incl in (False, True):
        cap = nnz - 2 + (1 if incl else 0)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            graph = tgt.neighbor_graph(ad, standardized=True, self_inclusion=incl,
                                       max_neighbors=cap)
        assert any("drops" in str(w.message) for w in rec)
        want = tg.neighbor_graph(ad, standardized=True, self_inclusion=incl,
                                 max_neighbors=cap)
        np.testing.assert_allclose(
            tcore.graph_matmul(graph, torch.from_numpy(X)).numpy(),
            np.asarray(jcore.graph_matmul(want, jnp.asarray(X))), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no room"):
        tgt.neighbor_graph(ad, standardized=True, self_inclusion=True, max_neighbors=1)


def test_spatial_weights_semantics():
    ad = spots(12, 4, n_neighs=3)
    W = tgt.spatial_weights(ad, standardized=True, self_inclusion=False)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, rtol=1e-9)
    W_incl = tgt.spatial_weights(ad, standardized=True, self_inclusion=True)
    np.testing.assert_allclose(W_incl.sum(axis=1), 2.0, rtol=1e-9)
    np.testing.assert_allclose(np.diag(W_incl), 1.0)
    W_bin = tgt.spatial_weights(ad, standardized=False, self_inclusion=False)
    assert set(np.unique(W_bin)) <= {0.0, 1.0}
    assert np.diag(W_bin).sum() == 0
    for got, std, incl in ((W, True, False), (W_incl, True, True), (W_bin, False, False)):
        np.testing.assert_array_equal(got, tg.spatial_weights(ad, std, incl))


def test_knn_graph_format_in_mapping():
    """graph_format='knn' through the port's map_cells_to_space matches its
    dense path and the JAX package's knn result (one spot graph for both)."""
    rng = np.random.default_rng(0)
    n_cells, n_spots, n_genes = 20, 15, 10
    S = (rng.poisson(2.0, (n_cells, n_genes)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (n_spots, n_genes)) + 1).astype(np.float32)
    ct = rng.choice(["a", "b"], n_cells)
    xy = rng.random((n_spots, 2))
    maps = {}
    for pkg in (tg, tgt):
        ad_sc = pkg.AnnData(
            X=S.copy(), obs=pd.DataFrame({"ct": pd.Categorical(ct)},
                                         index=[f"c{i}" for i in range(n_cells)]),
            var=pd.DataFrame(index=[f"g{i}" for i in range(n_genes)]))
        ad_sp = pkg.AnnData(X=G.copy(),
                            var=pd.DataFrame(index=[f"g{i}" for i in range(n_genes)]))
        ad_sp.obsm["spatial"] = xy.copy()
        pkg.pp_adatas(ad_sc, ad_sp)
        if pkg is tgt:
            for key in ("spatial_connectivities", "spatial_distances"):
                ad_sp.obsp[key] = maps["jax_obsp"][key]
        else:
            maps["jax_obsp"] = {k: ad_sp.obsp[k].copy() for k in
                                ("spatial_connectivities", "spatial_distances")}
        kw = dict(mode="cells", cluster_label="ct", num_epochs=25, random_state=7,
                  verbose=False, lambda_neighborhood_g1=0.5, lambda_ct_islands=0.5,
                  lambda_getis_ord=0.3, density_prior="uniform")
        if pkg is tgt:
            kw["device"] = "cpu"
            maps["dense"] = pkg.map_cells_to_space(ad_sc, ad_sp, graph_format="dense",
                                                   **kw).X
        maps[pkg.__name__] = pkg.map_cells_to_space(ad_sc, ad_sp, graph_format="knn",
                                                    **kw).X
    np.testing.assert_allclose(maps["tangram_tpu_torch"], maps["dense"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(maps["tangram_tpu_torch"], maps["tangram_tpu"], rtol=1e-3,
                               atol=1e-5)


def test_delaunay_spatial_neighbors():
    rng = np.random.default_rng(6)
    xy = rng.random((30, 2))
    ads = []
    for pkg in (tg, tgt):
        ad = pkg.AnnData(X=np.ones((30, 3), np.float32))
        ad.obsm["spatial"] = xy
        pkg.spatial_neighbors(ad, delaunay=True)
        ads.append(ad)
    conn = ads[1].obsp["spatial_connectivities"]
    dists = ads[1].obsp["spatial_distances"]
    assert conn.shape == (30, 30)
    assert conn.nnz > 0 and dists.nnz == conn.nnz
    assert (conn != conn.T).nnz == 0
    assert conn.diagonal().sum() == 0
    for key in ("spatial_connectivities", "spatial_distances"):
        np.testing.assert_array_equal(ads[1].obsp[key].toarray(),
                                      ads[0].obsp[key].toarray())


def test_spatial_neighbors_duplicate_coords_no_self_loop():
    coords = np.random.default_rng(7).random((12, 2))
    coords[6] = coords[3]
    coords[9] = coords[3]
    ad = tgt.AnnData(X=np.ones((12, 3), np.float32))
    ad.obsm["spatial"] = coords
    tgt.spatial_neighbors(ad, n_neighs=4)
    conn = ad.obsp["spatial_connectivities"]
    assert conn.diagonal().sum() == 0
    assert (np.asarray(conn.sum(axis=1)).ravel() >= 4).all()


def test_graph_matmul_transpose_vjp():
    rng = np.random.default_rng(8)
    s, g = 18, 5
    W = (rng.random((s, s)) * (rng.random((s, s)) < 0.3)).astype(np.float32)
    X = rng.normal(size=(s, g)).astype(np.float32)
    graph = tcore.neighbor_graph_from_dense(torch.from_numpy(W))
    assert graph.t_indices is not None
    Xt = torch.from_numpy(X).requires_grad_()
    torch.sin(tcore.graph_matmul(graph, Xt)).sum().backward()
    Xd = torch.from_numpy(X).requires_grad_()
    torch.sin(torch.from_numpy(W) @ Xd).sum().backward()
    np.testing.assert_allclose(Xt.grad.numpy(), Xd.grad.numpy(), rtol=1e-5, atol=1e-6)
    jgraph = jcore.neighbor_graph_from_dense(W)
    want = jax.grad(lambda x: jnp.sum(jnp.sin(jcore.graph_matmul(jgraph, x))))(
        jnp.asarray(X))
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(graph.col_sums().numpy(), W.sum(0), rtol=1e-5)


# ---------------------------------------------------------------------------
# the chain, on a shared map and from each package's own mapping
# ---------------------------------------------------------------------------


def chain(pkg, ad_sc, ad_sp, ad_map):
    """Every downstream product of one mapping, in package ``pkg``."""
    pkg.create_segment_cell_df(ad_sp)
    pkg.project_cell_annotations(ad_map, ad_sp, annotation="cell_type")
    pkg.count_cell_annotations(ad_map, ad_sc, ad_sp, annotation="cell_type")
    segment = pkg.deconvolve_cell_annotations(ad_sp)
    ad_map.obs["cell_types"] = ad_map.obs["cell_type"]
    pkg.cell_type_mapping(ad_map)
    return dict(pred=ad_sp.obsm["tangram_ct_pred"], count=ad_sp.obsm["tangram_ct_count"],
                segment=segment.obs, ct_map=ad_map.varm["ct_map"])


def test_chain_on_a_shared_map_equals_jax(pair):
    want, got = (chain(pkg, *ads) for pkg, ads in zip((tg, tgt), pair))
    for key in ("pred", "count", "segment", "ct_map"):
        pd.testing.assert_frame_equal(got[key], want[key], check_exact=True, obj=key)
    ct_map = got["ct_map"].to_numpy()
    assert ct_map.min() == 0.0 and ct_map.max() == 1.0
    # the transfer helpers and the gene matcher on the same map
    M = make_inputs()["M"]
    onehot = tgt.one_hot_encoding(make_inputs()["labels"]).to_numpy(float)
    keep = np.linspace(0, 1, N_CELLS) > 0.3
    np.testing.assert_array_equal(tgt.transfer_annotations_prob(M, onehot),
                                  tg.transfer_annotations_prob(M, onehot))
    np.testing.assert_array_equal(
        tgt.transfer_annotations_prob_filter(M, keep, onehot),
        tg.transfer_annotations_prob_filter(M, keep, onehot))
    prior, sn = ["g1", "g2", "g1", "g4"], ["g4", "g9", "g1", "g2"]
    assert (tgt.get_matched_genes(prior, sn, excluded_genes=["g2"])
            == tg.get_matched_genes(prior, sn, excluded_genes=["g2"]))


def test_constrained_maps_filter_the_chain(pair):
    """cell_type_mapping and count_cell_annotations read F_out as JAX does."""
    F_out = np.random.default_rng(9).random(N_CELLS)
    for _, _, ad_map in pair:
        ad_map.obs["F_out"] = F_out
    want, got = (chain(pkg, *ads) for pkg, ads in zip((tg, tgt), pair))
    for key in ("count", "segment", "ct_map"):
        pd.testing.assert_frame_equal(got[key], want[key], check_exact=True, obj=key)


MAP_RTOL = 1e-3  # the port's mapping against JAX's (f32, sums in another order)


def test_chain_from_each_packages_own_mapping():
    """Each package maps its own pair; the cells have a clear best spot
    (each spot holds one cell's profile), so the argmax counts are equal
    and the float products agree to the mapping tolerance."""
    rng = np.random.default_rng(10)
    n, g = 16, 24
    S = (rng.poisson(1.0, (n, g)) + 10 * (rng.random((n, g)) < 0.2)).astype(np.float32)
    S[S.sum(1) == 0, 0] = 1
    perm = rng.permutation(n)
    inp = make_inputs()
    inp.update(S=S, G=S[np.argsort(perm)].copy(), labels=rng.choice(["a", "b", "c"], n),
               coords=rng.random((n, 2)) * 100)
    seg = rng.integers(1, 5, n)
    inp.update(seg_labels=seg,
               centroids=[[tuple(rng.random(2) * 100) for _ in range(k)] for k in seg])
    out = {}
    for pkg in (tg, tgt):
        ad_sc, ad_sp, _ = build(pkg, inp, with_map=False)
        pkg.pp_adatas(ad_sc, ad_sp)
        kw = dict(device="cpu") if pkg is tgt else {}
        ad_map = pkg.map_cells_to_space(ad_sc, ad_sp, num_epochs=100, random_state=3,
                                        verbose=False, density_prior="uniform", **kw)
        out[pkg] = (ad_map.X.copy(), chain(pkg, ad_sc, ad_sp, ad_map))
    (Mj, want), (Mt, got) = out[tg], out[tgt]
    np.testing.assert_allclose(Mt, Mj, rtol=MAP_RTOL, atol=1e-6)
    # the premise: every cell's best spot is its own profile's, by a margin
    # far above the mapping tolerance
    np.testing.assert_array_equal(Mj.argmax(1), perm)
    top2 = np.sort(Mj, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 10 * MAP_RTOL * Mj.max()
    np.testing.assert_array_equal(Mt.argmax(1), Mj.argmax(1))
    pd.testing.assert_frame_equal(got["count"], want["count"], check_exact=True)
    pd.testing.assert_frame_equal(got["segment"], want["segment"], check_exact=True)
    for key in ("pred", "ct_map"):
        pd.testing.assert_frame_equal(got[key], want[key], check_exact=False,
                                      rtol=MAP_RTOL, atol=1e-6, obj=key)
