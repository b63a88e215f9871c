"""The port's AnnData container and h5ad IO (``tangram_tpu_torch.adlite``)
against the JAX package's (``tangram_tpu.adlite``).

The port's module is a copy of the JAX package's, so every case of
``tests/test_adlite.py`` and ``tests/test_h5ad_spec.py`` runs here on both
modules (parametrized by package name). Then a file written by each package
is read by the other: a hand-built AnnData with every element kind
(``X`` dense and CSR, categorical and string ``obs`` columns, ``var``,
``obsm``, ``obsp`` as CSR, nested ``uns``), and a real
``map_cells_to_space`` output of each package (``device="cpu"`` for the
port), whose ``uns["train_genes_df"]`` and ``uns["training_history"]`` must
survive. A value read back equals the written one exactly, in its dtype,
but for a bool column of a DataFrame, which both packages' readers give
back as uint8: a file read by the other package equals the writing
package's own reading of it, frame for frame.
"""

import importlib

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

h5py = pytest.importorskip("h5py")

PACKAGES = ("tangram_tpu", "tangram_tpu_torch")
CROSS = [("tangram_tpu", "tangram_tpu_torch"), ("tangram_tpu_torch", "tangram_tpu")]


def adlite(package):
    return importlib.import_module(f"{package}.adlite")


@pytest.fixture(params=PACKAGES)
def ad(request):
    """One package's adlite module."""
    return adlite(request.param)


# ---------------------------------------------------------------------------
# tests/test_adlite.py on both modules
# ---------------------------------------------------------------------------


def make_adata(ad, rng):
    X = rng.poisson(1.0, (6, 5)).astype(np.float32)
    obs = pd.DataFrame(
        {"celltype": pd.Categorical(["a", "b", "a", "c", "b", "a"]), "depth": np.arange(6)},
        index=[f"cell{i}" for i in range(6)],
    )
    var = pd.DataFrame({"hv": [True, False, True, False, True]},
                       index=[f"g{i}" for i in range(5)])
    a = ad.AnnData(X=X, obs=obs, var=var)
    a.uns["training_genes"] = ["g0", "g2"]
    a.uns["meta"] = {"alpha": 1.5, "name": "test"}
    a.obsm["spatial"] = rng.random((6, 2))
    a.obsp["graph"] = sp.random(6, 6, density=0.4, format="csr", random_state=rng)
    a.layers["counts"] = X.copy()
    return a


def test_basic_attributes(ad, rng):
    a = make_adata(ad, rng)
    assert a.shape == (6, 5)
    assert a.n_obs == 6 and a.n_vars == 5
    assert list(a.var_names) == [f"g{i}" for i in range(5)]


def test_var_subset_by_name(ad, rng):
    a = make_adata(ad, rng)
    sub = a[:, ["g1", "g3"]]
    assert sub.shape == (6, 2)
    np.testing.assert_array_equal(sub.X, a.X[:, [1, 3]])
    assert list(sub.var_names) == ["g1", "g3"]


def test_obs_subset_by_bool(ad, rng):
    a = make_adata(ad, rng)
    mask = a.obs["celltype"] == "a"
    sub = a[mask]
    assert sub.n_obs == 3
    np.testing.assert_array_equal(sub.X, a.X[np.asarray(mask)])
    assert sub.obsm["spatial"].shape == (3, 2)


def test_var_names_make_unique(ad):
    a = ad.AnnData(X=np.zeros((1, 3)), var=pd.DataFrame(index=["a", "a", "b"]))
    a.var_names_make_unique()
    assert list(a.var_names) == ["a", "a-1", "b"]


def test_filter_genes(ad, rng):
    X = rng.poisson(1.0, (6, 5)).astype(np.float32)
    X[:, 2] = 0
    a = ad.AnnData(X=X)
    ad.filter_genes(a, min_cells=1)
    assert a.n_vars == 4
    assert (np.asarray(a.X) != 0).sum(axis=0).min() >= 1


def test_filter_genes_sparse(ad, rng):
    X = rng.poisson(0.5, (10, 8)).astype(np.float32)
    X[:, 3] = 0
    a = ad.AnnData(X=sp.csr_matrix(X))
    ad.filter_genes(a, min_cells=1)
    assert a.n_vars < 8
    assert np.asarray((a.X != 0).sum(axis=0)).min() >= 1


def test_h5ad_roundtrip(ad, rng, tmp_path):
    a = make_adata(ad, rng)
    path = tmp_path / "x.h5ad"
    ad.write_h5ad(path, a)
    back = ad.read_h5ad(path)

    np.testing.assert_allclose(np.asarray(back.X), np.asarray(a.X))
    assert list(back.obs.index) == list(a.obs.index)
    assert list(back.obs["celltype"]) == list(a.obs["celltype"])
    assert list(back.var.index) == list(a.var.index)
    assert list(back.uns["training_genes"]) == ["g0", "g2"]
    assert back.uns["meta"]["alpha"] == 1.5
    assert back.uns["meta"]["name"] == "test"
    np.testing.assert_allclose(back.obsm["spatial"], a.obsm["spatial"])
    assert sp.issparse(back.obsp["graph"])
    np.testing.assert_allclose(back.obsp["graph"].toarray(), a.obsp["graph"].toarray())
    np.testing.assert_allclose(np.asarray(back.layers["counts"]), np.asarray(a.X))


def test_h5ad_sparse_X_roundtrip(ad, tmp_path):
    X = sp.random(20, 10, density=0.3, format="csr", dtype=np.float32, random_state=0)
    a = ad.AnnData(X=X)
    path = tmp_path / "sparse.h5ad"
    a.write_h5ad(path)
    back = ad.read_h5ad(path)
    assert sp.issparse(back.X)
    np.testing.assert_allclose(back.X.toarray(), X.toarray())


def random_adata(ad, seed):
    """``tests/test_adlite.py::test_h5ad_roundtrip_randomized``'s random
    container: dense f32/f64 and CSR/CSC X, numeric/string/categorical/bool
    obs columns, nested uns, random obsm/varm/obsp/layers presence."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 15))
    m = int(rng.integers(2, 12))
    dense = rng.poisson(1.0, (n, m)).astype(np.float64 if rng.random() < 0.3 else np.float32)
    xkind = rng.choice(["dense", "csr", "csc"])
    X = {"dense": dense, "csr": sp.csr_matrix(dense), "csc": sp.csc_matrix(dense)}[xkind]
    obs = pd.DataFrame(index=[f"cell-{i}" for i in range(n)])
    if rng.random() < 0.8:
        obs["f"] = rng.random(n)
    if rng.random() < 0.8:
        obs["i"] = rng.integers(0, 5, n)
    if rng.random() < 0.8:
        obs["s"] = [f"s{int(v)}" for v in rng.integers(0, 3, n)]
    if rng.random() < 0.8:
        obs["cat"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    if rng.random() < 0.5:
        obs["flag"] = rng.random(n) < 0.5
    var = pd.DataFrame(index=[f"gene_{j}" for j in range(m)])
    if rng.random() < 0.5:
        var["score"] = rng.random(m)
    a = ad.AnnData(X=X, obs=obs, var=var)
    a.uns["nested"] = {
        "alpha": float(rng.random()),
        "count": int(rng.integers(0, 100)),
        "name": "trial",
        "arr": rng.random(4),
        "genes": [f"gene_{j}" for j in range(min(3, m))],
        "inner": {"k": 2},
    }
    if rng.random() < 0.7:
        a.obsm["spatial"] = rng.random((n, 2))
    if rng.random() < 0.5:
        a.varm["pcs"] = rng.random((m, 3))
    if rng.random() < 0.7:
        a.obsp["graph"] = sp.random(n, n, density=0.4, format="csr", random_state=rng)
    if rng.random() < 0.5:
        a.layers["counts"] = dense.copy()
    return a, dense


def as_dense(v):
    return v.toarray() if sp.issparse(v) else np.asarray(v)


def assert_random_adata_equal(back, a, dense):
    np.testing.assert_allclose(as_dense(back.X), dense)
    assert sp.issparse(back.X) == sp.issparse(a.X)
    assert list(back.obs.index) == list(a.obs.index)
    assert list(back.var.index) == list(a.var.index)
    assert list(back.obs.columns) == list(a.obs.columns)
    for col in a.obs.columns:
        np.testing.assert_array_equal(np.asarray(back.obs[col]), np.asarray(a.obs[col]),
                                      err_msg=f"obs[{col}]")
    for col in a.var.columns:
        np.testing.assert_array_equal(np.asarray(back.var[col]), np.asarray(a.var[col]))
    nested = back.uns["nested"]
    assert nested["alpha"] == pytest.approx(a.uns["nested"]["alpha"])
    assert int(nested["count"]) == a.uns["nested"]["count"]
    assert nested["name"] == "trial"
    np.testing.assert_allclose(np.asarray(nested["arr"]), a.uns["nested"]["arr"])
    assert list(nested["genes"]) == a.uns["nested"]["genes"]
    assert int(nested["inner"]["k"]) == 2
    for grp in ("obsm", "varm", "obsp", "layers"):
        ours, theirs = getattr(a, grp), getattr(back, grp)
        assert set(ours.keys()) == set(theirs.keys()), grp
        for k in ours:
            np.testing.assert_allclose(as_dense(theirs[k]), as_dense(ours[k]),
                                       err_msg=f"{grp}[{k}]")


@pytest.mark.parametrize("seed", range(6))
def test_h5ad_roundtrip_randomized(ad, seed, tmp_path):
    a, dense = random_adata(ad, seed)
    path = tmp_path / f"rt{seed}.h5ad"
    a.write_h5ad(path)
    assert_random_adata_equal(ad.read_h5ad(path), a, dense)


def test_copy_is_deep(ad, rng):
    a = make_adata(ad, rng)
    cp = a.copy()
    cp.X[0, 0] = 99
    cp.obs.iloc[0, 1] = -1
    assert a.X[0, 0] != 99
    assert a.obs.iloc[0, 1] != -1


def test_missing_obs_name_raises(ad, rng):
    a = make_adata(ad, rng)
    with pytest.raises(KeyError, match="obs names not found"):
        a[["nope"]]


def test_integer_scalar_indexing(ad, rng):
    a = make_adata(ad, rng)
    sub = a[2]
    assert sub.n_obs == 1
    np.testing.assert_array_equal(np.asarray(sub.X)[0], np.asarray(a.X)[2])
    sub2 = a[:, 3]
    assert sub2.n_vars == 1


# ---------------------------------------------------------------------------
# tests/test_h5ad_spec.py on both modules: the anndata on-disk layout
# ---------------------------------------------------------------------------


def rich_adata(ad, rng):
    """``tests/test_h5ad_spec.py``'s ``rich_adata`` fixture."""
    n_obs, n_var = 7, 5
    obs = pd.DataFrame(
        {
            "subclass_label": pd.Categorical(["a", "b", "a", "c", "b", "a", "c"]),
            "n_counts": np.arange(n_obs, dtype=np.float64),
            "batch": ["x1", "x2", "x1", "x1", "x2", "x2", "x1"],
        },
        index=[f"cell{i}" for i in range(n_obs)],
    )
    var = pd.DataFrame({"sparsity": rng.random(n_var).astype(np.float64)},
                       index=[f"g{i}" for i in range(n_var)])
    a = ad.AnnData(X=rng.poisson(2.0, (n_obs, n_var)).astype(np.float32), obs=obs, var=var)
    a.obsm["spatial"] = rng.random((n_obs, 2))
    a.obsp["spatial_connectivities"] = sp.csr_matrix(
        (np.ones(4), ([0, 1, 2, 3], [1, 0, 3, 2])), shape=(n_obs, n_obs))
    a.uns["training_genes"] = [f"g{i}" for i in range(n_var)]
    a.uns["overlap_genes"] = [f"g{i}" for i in range(n_var)]
    a.uns["meta"] = {"version": "1.0", "n_epochs": 1000, "scaled": True}
    a.layers["counts"] = rng.poisson(1.0, (n_obs, n_var)).astype(np.float32)
    return a


@pytest.fixture
def h5(ad, rng, tmp_path):
    path = tmp_path / "spec.h5ad"
    a = rich_adata(ad, rng)
    ad.write_h5ad(path, a)
    with h5py.File(path, "r") as f:
        yield f, a


def _enc(node):
    dec = (lambda x: x.decode() if isinstance(x, bytes) else x)  # noqa: E731
    return dec(node.attrs.get("encoding-type")), dec(node.attrs.get("encoding-version"))


def _str(x):
    return x.decode() if isinstance(x, bytes) else x


def test_root_encoding(h5):
    f, _ = h5
    assert _enc(f) == ("anndata", "0.1.0")
    for key in ("obs", "var", "uns", "obsm", "varm", "obsp", "layers"):
        assert key in f, key
        assert isinstance(f[key], h5py.Group)


def test_dense_array_encoding(h5):
    f, _ = h5
    for key in ("X", "obsm/spatial", "layers/counts"):
        node = f[key]
        assert isinstance(node, h5py.Dataset), key
        assert _enc(node) == ("array", "0.2.0"), key
        assert node.dtype.kind == "f", key


def test_dataframe_encoding(h5):
    f, _ = h5
    for axis in ("obs", "var"):
        g = f[axis]
        assert _enc(g) == ("dataframe", "0.2.0")
        index_key = _str(g.attrs["_index"])
        assert index_key in g
        assert h5py.check_string_dtype(g[index_key].dtype) is not None
        for col in (_str(c) for c in g.attrs["column-order"]):
            assert col in g, f"{axis}.{col} listed in column-order but absent"


def test_categorical_encoding(h5):
    f, _ = h5
    g = f["obs/subclass_label"]
    assert isinstance(g, h5py.Group)
    assert _enc(g) == ("categorical", "0.2.0")
    assert "ordered" in g.attrs and not bool(g.attrs["ordered"])
    assert g["codes"].dtype.kind in "iu"
    assert h5py.check_string_dtype(g["categories"].dtype) is not None
    codes = g["codes"][()]
    assert codes.min() >= 0 and codes.max() < g["categories"].shape[0]


def test_string_column_encoding(h5):
    f, _ = h5
    ds = f["obs/batch"]
    assert _enc(ds) == ("string-array", "0.2.0")
    assert h5py.check_string_dtype(ds.dtype) is not None


def test_csr_obsp_encoding(h5):
    f, a = h5
    g = f["obsp/spatial_connectivities"]
    assert isinstance(g, h5py.Group)
    assert _enc(g) == ("csr_matrix", "0.1.0")
    shape = np.asarray(g.attrs["shape"])
    assert shape.shape == (2,) and shape.dtype.kind == "i"
    assert tuple(shape) == (a.n_obs, a.n_obs)
    for member in ("data", "indices", "indptr"):
        assert member in g and isinstance(g[member], h5py.Dataset), member
    assert g["indptr"].shape[0] == a.n_obs + 1
    assert g["indices"].dtype.kind in "iu"
    indptr = g["indptr"][()]
    assert indptr[0] == 0 and indptr[-1] == g["data"].shape[0]
    assert (np.diff(indptr) >= 0).all()


def test_uns_encodings(h5):
    f, _ = h5
    g = f["uns"]
    assert _enc(g["meta"]) == ("dict", "0.1.0")
    assert _enc(g["meta/version"]) == ("string", "0.2.0")
    assert _enc(g["meta/n_epochs"]) == ("numeric-scalar", "0.2.0")
    assert _enc(g["meta/scaled"]) == ("numeric-scalar", "0.2.0")
    assert _enc(g["training_genes"]) == ("string-array", "0.2.0")


def test_every_element_carries_encoding_attrs(h5):
    f, _ = h5
    problems = []

    def visit(name, node):
        if name.split("/")[0] not in ("X", "obs", "var", "uns", "obsm", "varm", "obsp",
                                      "layers"):
            return
        parent = name.rsplit("/", 1)[0] if "/" in name else ""
        if parent and _str(f[parent].attrs.get("encoding-type", b"")) in (
                "csr_matrix", "csc_matrix", "categorical"):
            return
        t, v = _enc(node)
        if t is None or v is None:
            problems.append(name)

    f.visititems(visit)
    problems = [p for p in problems if p not in ("obsm", "varm", "obsp", "layers", "uns")]
    assert not problems, f"elements missing encoding attrs: {problems}"


def test_roundtrip_preserves_semantics(ad, rng, tmp_path):
    a = rich_adata(ad, rng)
    path = tmp_path / "rt.h5ad"
    ad.write_h5ad(path, a)
    back = ad.read_h5ad(path)
    np.testing.assert_array_equal(back.X, a.X)
    assert list(back.obs.index) == list(a.obs.index)
    assert list(back.obs["subclass_label"]) == list(a.obs["subclass_label"])
    assert isinstance(back.obs["subclass_label"].dtype, pd.CategoricalDtype)
    np.testing.assert_array_equal(back.obsm["spatial"], a.obsm["spatial"])
    got = back.obsp["spatial_connectivities"]
    assert sp.isspmatrix_csr(got)
    np.testing.assert_array_equal(got.toarray(),
                                  a.obsp["spatial_connectivities"].toarray())
    assert list(back.uns["training_genes"]) == list(a.uns["training_genes"])
    assert back.uns["meta"]["version"] == "1.0"
    assert int(back.uns["meta"]["n_epochs"]) == 1000


def test_csc_matrix_encoding(ad, tmp_path):
    X = sp.random(6, 4, density=0.5, format="csc", random_state=0)
    a = ad.AnnData(X=X.astype(np.float32), obs=pd.DataFrame(index=[f"c{i}" for i in range(6)]),
                   var=pd.DataFrame(index=[f"g{i}" for i in range(4)]))
    path = tmp_path / "csc.h5ad"
    ad.write_h5ad(path, a)
    with h5py.File(path, "r") as f:
        assert _enc(f["X"]) == ("csc_matrix", "0.1.0")
        assert f["X/indptr"].shape[0] == 4 + 1
    back = ad.read_h5ad(path)
    assert sp.isspmatrix_csc(back.X)
    np.testing.assert_allclose(back.X.toarray(), X.toarray())


# ---------------------------------------------------------------------------
# files written by one package and read by the other
# ---------------------------------------------------------------------------


def exchange_adata(ad, x_format):
    """Every element kind a mapping workflow stores."""
    rng = np.random.default_rng(3)
    n, m = 9, 6
    X = rng.poisson(1.5, (n, m)).astype(np.float32)
    obs = pd.DataFrame(
        {"cell_type": pd.Categorical(rng.choice(["L2/3 IT", "Pvalb", "Astro"], n)),
         "batch": [f"b{i % 2}" for i in range(n)],
         "n_counts": X.sum(axis=1).astype(np.float64),
         "flag": rng.random(n) < 0.5},
        index=[f"cell{i}" for i in range(n)])
    var = pd.DataFrame({"sparsity": rng.random(m), "is_training": rng.random(m) < 0.5},
                       index=[f"Gene{j}" for j in range(m)])
    a = ad.AnnData(X=sp.csr_matrix(X) if x_format == "csr" else X, obs=obs, var=var)
    a.obsm["spatial"] = rng.random((n, 2))
    a.obsp["spatial_connectivities"] = sp.random(n, n, density=0.3, format="csr",
                                                 random_state=rng)
    a.uns["training_genes"] = [f"gene{j}" for j in range(0, m, 2)]
    a.uns["run"] = {"learning_rate": 0.1, "num_epochs": 1000, "mode": "cells",
                    "converged": True, "scores": rng.random(5).astype(np.float32),
                    "inner": {"lambda_d": 0.5, "genes": ["gene0", "gene2"],
                              "grid": np.arange(6).reshape(2, 3)}}
    return a, X


@pytest.mark.parametrize("x_format", ["dense", "csr"])
@pytest.mark.parametrize("writer,reader", CROSS)
def test_file_of_one_package_reads_in_the_other(writer, reader, x_format, tmp_path):
    a, X = exchange_adata(adlite(writer), x_format)
    path = tmp_path / "exchange.h5ad"
    adlite(writer).write_h5ad(path, a)
    back = adlite(reader).read_h5ad(path)

    assert type(back).__module__ == f"{reader}.adlite"
    assert sp.issparse(back.X) == (x_format == "csr")
    if x_format == "csr":
        assert sp.isspmatrix_csr(back.X)
    np.testing.assert_array_equal(as_dense(back.X), X)
    assert as_dense(back.X).dtype == np.float32
    # both readers give a bool column back as uint8 (h5py stores bools so):
    # the reading package returns what the writing package's own reader does
    same = adlite(writer).read_h5ad(path)
    for axis in ("obs", "var"):
        pd.testing.assert_frame_equal(getattr(back, axis), getattr(same, axis))
        pd.testing.assert_frame_equal(getattr(back, axis), getattr(a, axis),
                                      check_dtype=False)
    assert back.obs["flag"].dtype == np.uint8
    np.testing.assert_array_equal(back.obsm["spatial"], a.obsm["spatial"])
    got = back.obsp["spatial_connectivities"]
    assert sp.isspmatrix_csr(got)
    np.testing.assert_array_equal(got.toarray(), a.obsp["spatial_connectivities"].toarray())
    assert list(back.uns["training_genes"]) == a.uns["training_genes"]
    run, want = back.uns["run"], a.uns["run"]
    assert set(run) == set(want)
    assert run["learning_rate"] == want["learning_rate"]
    assert int(run["num_epochs"]) == want["num_epochs"]
    assert run["mode"] == "cells" and bool(run["converged"])
    np.testing.assert_array_equal(run["scores"], want["scores"])
    assert run["scores"].dtype == np.float32
    assert run["inner"]["lambda_d"] == 0.5
    assert list(run["inner"]["genes"]) == ["gene0", "gene2"]
    np.testing.assert_array_equal(run["inner"]["grid"], want["inner"]["grid"])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("writer,reader", CROSS)
def test_random_containers_cross_packages(writer, reader, seed, tmp_path):
    """``random_adata``'s containers (CSC X, varm and layers included)
    written by one package and read by the other."""
    a, dense = random_adata(adlite(writer), seed)
    path = tmp_path / "random.h5ad"
    adlite(writer).write_h5ad(path, a)
    assert_random_adata_equal(adlite(reader).read_h5ad(path), a, dense)


def mapping_output(package):
    """A cells-mode ``map_cells_to_space`` result of ``package`` on a small
    pair (the port on the CPU)."""
    api = importlib.import_module(package)
    rng = np.random.default_rng(8)
    c, s, g = 20, 14, 10
    genes = pd.DataFrame(index=[f"Gene{j}" for j in range(g)])
    ad_sc = api.AnnData(
        X=(rng.poisson(2.0, (c, g)) + 1).astype(np.float32),
        obs=pd.DataFrame({"cell_type": pd.Categorical(rng.choice(["a", "b"], c))},
                         index=[f"c{i}" for i in range(c)]),
        var=genes.copy())
    ad_sp = api.AnnData(X=(rng.poisson(2.0, (s, g)) + 1).astype(np.float32),
                        obs=pd.DataFrame(index=[f"s{i}" for i in range(s)]),
                        var=genes.copy())
    api.pp_adatas(ad_sc, ad_sp)
    kw = dict(device="cpu") if package == "tangram_tpu_torch" else {}
    return api.map_cells_to_space(ad_sc, ad_sp, num_epochs=12, random_state=3,
                                  verbose=False, **kw)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_mapping_output_crosses_packages(writer, reader, tmp_path):
    ad_map = mapping_output(writer)
    path = tmp_path / "map.h5ad"
    ad_map.write_h5ad(path)
    back = adlite(reader).read_h5ad(path)

    np.testing.assert_array_equal(np.asarray(back.X), np.asarray(ad_map.X))
    pd.testing.assert_frame_equal(back.obs, ad_map.obs)
    pd.testing.assert_frame_equal(back.var, ad_map.var)
    df, want = back.uns["train_genes_df"], ad_map.uns["train_genes_df"]
    assert isinstance(df, pd.DataFrame)
    pd.testing.assert_frame_equal(df, want)
    hist, want_hist = back.uns["training_history"], ad_map.uns["training_history"]
    assert set(hist) == set(want_hist)
    for key, values in want_hist.items():
        np.testing.assert_array_equal(np.asarray(hist[key], dtype=np.float64),
                                      np.asarray(values, dtype=np.float64), err_msg=key)
    assert len(hist["main_loss"]) == 12


# ---------------------------------------------------------------------------
# the port's column pick and gene count on every kind of X
# ---------------------------------------------------------------------------

X_KINDS = ("csr", "csr_duplicates", "csr_explicit_zeros", "csr_unsorted", "csr_read_only",
           "csc", "dense")


def x_of_kind(kind, seed=0, shape=(12, 9)):
    """A small count matrix stored as ``kind``: a canonical CSR; one whose
    rows store each entry as two halves, plus a pair on one column that
    sums to zero; one with stored zeros (still canonical); one with each
    row's entries in reverse order; a canonical one whose arrays are
    read-only (as a mapped file's); a CSC; a dense array."""
    dense = np.random.default_rng(seed).poisson(0.8, shape).astype(np.float32)
    dense[:, 4] = 0  # a gene no cell expresses, where the duplicates cancel
    if kind == "dense":
        return dense
    if kind == "csc":
        return sp.csc_matrix(dense)
    X = sp.csr_matrix(dense)
    rows = [(X.indices[a:b], X.data[a:b]) for a, b in zip(X.indptr[:-1], X.indptr[1:])]
    if kind == "csr_duplicates":
        rows = [(np.concatenate([j, j, [4, 4]]),
                 np.concatenate([v / 2, v / 2, [2.0, -2.0]]).astype(np.float32))
                for j, v in rows]
    elif kind == "csr_unsorted":
        rows = [(j[::-1], v[::-1]) for j, v in rows]
    elif kind == "csr_explicit_zeros":
        rows = [(j, np.where(np.arange(len(v)) % 3 == 0, 0, v).astype(np.float32))
                for j, v in rows]
    elif kind not in ("csr", "csr_read_only"):
        raise ValueError(kind)
    indptr = np.concatenate([[0], np.cumsum([len(j) for j, _ in rows])]).astype(np.int32)
    indices = np.concatenate([j for j, _ in rows]).astype(np.int32)
    data = np.concatenate([v for _, v in rows]).astype(np.float32)
    X = sp.csr_matrix((data, indices, indptr), shape=shape)
    if kind == "csr_read_only":
        for a in (X.data, X.indices, X.indptr):
            a.flags.writeable = False
    return X


def test_x_kinds_are_what_they_say():
    canonical = {kind: x_of_kind(kind).has_canonical_format
                 for kind in X_KINDS if kind.startswith("csr")}
    assert canonical == {"csr": True, "csr_duplicates": False, "csr_explicit_zeros": True,
                         "csr_unsorted": False, "csr_read_only": True}
    assert (x_of_kind("csr_explicit_zeros").data == 0).any()


def assert_same_storage(got, want):
    """The same matrix in the same storage: format, dtypes and every array
    of a sparse one in its stored order."""
    assert type(got) is type(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    arrays = ("data", "indices", "indptr") if sp.issparse(want) else ()
    for name in arrays:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if not arrays:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", X_KINDS)
def test_column_pick_keeps_the_row_path_storage(kind):
    """``adata[:, genes]`` keeps every row and picks columns alone; its X
    and layers store what the row-and-column path and the JAX package's
    container store, bit for bit, and the counter says which path ran."""
    port = adlite("tangram_tpu_torch")
    genes = ["g7", "g2", "g4", "g5"]
    made = [port.AnnData(X=x_of_kind(kind), layers={"counts": x_of_kind(kind, seed=1)},
                         var=pd.DataFrame(index=[f"g{j}" for j in range(9)]))
            for _ in range(2)]
    jax = adlite("tangram_tpu").AnnData(
        X=x_of_kind(kind), layers={"counts": x_of_kind(kind, seed=1)},
        var=pd.DataFrame(index=[f"g{j}" for j in range(9)]))
    port.SPARSE_SLICES.clear()
    picked = made[0][:, genes]
    sparse = sp.issparse(picked.X)
    assert port.SPARSE_SLICES == ({"columns": 2} if sparse else {})
    port.SPARSE_SLICES.clear()
    both = made[1][np.arange(12)][:, genes]
    assert port.SPARSE_SLICES == ({"rows": 2, "columns": 2} if sparse else {})
    for want in (both, jax[:, genes]):
        assert_same_storage(picked.X, want.X)
        assert_same_storage(picked.layers["counts"], want.layers["counts"])
    assert list(picked.var.index) == genes


@pytest.mark.parametrize("kind", X_KINDS)
def test_gene_count_equals_the_boolean_sum(kind):
    """``annotate_gene_sparsity`` counts what ``(X != 0).sum(axis=0)``
    counts (the JAX package's form), with no warning, and leaves X as that
    form leaves it: a non-canonical CSR sorted with its duplicates summed,
    any other X untouched."""
    import warnings

    from tangram_tpu.utils import annotate_gene_sparsity as jax_count
    from tangram_tpu_torch.utils import annotate_gene_sparsity

    ours, theirs = (adlite(p).AnnData(X=x_of_kind(kind))
                    for p in ("tangram_tpu_torch", "tangram_tpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        annotate_gene_sparsity(ours)
    jax_count(theirs)
    np.testing.assert_array_equal(ours.var["sparsity"].to_numpy(),
                                  theirs.var["sparsity"].to_numpy())
    assert ours.var["sparsity"].dtype == np.float64
    nonzero = np.count_nonzero(x_of_kind(kind) if kind == "dense"
                               else x_of_kind(kind).toarray(), axis=0)
    np.testing.assert_array_equal(ours.var["sparsity"].to_numpy(), 1.0 - nonzero / 12.0)
    assert_same_storage(ours.X, theirs.X)
    if kind in ("csr_duplicates", "csr_unsorted"):
        assert ours.X.has_canonical_format
        # each row's cancelled pair stays as one stored zero
        cancelled = 12 if kind == "csr_duplicates" else 0
        assert ours.X.nnz == sp.csr_matrix(x_of_kind(kind).toarray()).nnz + cancelled
    else:
        assert_same_storage(ours.X, x_of_kind(kind))
