"""The PyTorch port's cell sampling and training-gene selection against the
JAX package's, case for case with ``tests/test_gene_selection.py`` and the
cell-selection cases of ``tests/test_checkpoint_and_extras.py``.

Both are host code on numpy, pandas and scipy, so the port must give the
JAX package's answers on the same inputs: ``cell_sampling`` bit for bit
(the same ``default_rng`` draws in the same order), the gene lists exactly,
``svg``'s Moran's I, p-values and adjusted p-values to 1e-12 (float64, on
one spot graph: the JAX package's ``obsp`` is copied onto the port's
AnnData).
"""

import numpy as np
import pandas as pd
import pytest

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu import cell_selection as jcs
from tangram_tpu import gene_selection as jgs
from tangram_tpu_torch import cell_selection as tcs
from tangram_tpu_torch import gene_selection as tgs


def both(X, obs=None, genes=None):
    """The same AnnData in both packages."""
    var = pd.DataFrame(index=genes if genes is not None
                       else [f"g{i}" for i in range(X.shape[1])])
    return tuple(pkg.AnnData(X=X.copy(), obs=None if obs is None else obs.copy(),
                             var=var.copy()) for pkg in (tg, tgt))


def test_ctg_recovers_planted_markers(rng):
    n_per, g = 40, 30
    base = rng.poisson(2.0, (2 * n_per, g)).astype(float)
    base[:n_per, 0:5] += 20
    base[n_per:, 5:10] += 20
    obs = pd.DataFrame({"ct": pd.Categorical(["A"] * n_per + ["B"] * n_per)})
    j, t = both(base, obs)
    markers = tgs.ctg(t, "ct", n_genes=5)
    assert markers == jgs.ctg(j, "ct", n_genes=5)
    assert set(markers) == {f"g{i}" for i in range(10)}


def test_hvg_recovers_high_dispersion(rng):
    n, g = 1000, 500
    rates = rng.uniform(1.0, 10.0, g)
    X = rng.poisson(rates, (n, g)).astype(float)
    for j in range(5):
        X[:, j] = np.where(rng.random(n) < 0.5, 10.0, 0.0)
    j_ad, t_ad = both(X)
    top = tgs.hvg(t_ad, n_top_genes=10)
    assert top == jgs.hvg(j_ad, n_top_genes=10)
    assert len({f"g{i}" for i in range(5)} & set(top)) >= 4


def test_svg_recovers_spatial_pattern(rng):
    n, g = 150, 20
    coords = rng.random((n, 2))
    X = rng.poisson(3.0, (n, g)).astype(float)
    for j in range(3):
        X[:, j] = 20 * (coords[:, 0] + coords[:, 1]) + rng.normal(0, 0.5, n)
    j_ad, t_ad = both(X)
    j_ad.obsm["spatial"] = coords
    t_ad.obsm["spatial"] = coords
    want = jgs.svg(j_ad, alpha=0.05)
    for key in ("spatial_connectivities", "spatial_distances"):
        t_ad.obsp[key] = j_ad.obsp[key].copy()
    found = tgs.svg(t_ad, alpha=0.05)
    assert found == want
    assert {"g0", "g1", "g2"} <= set(found)
    assert len(found) <= 8
    res, ref = t_ad.uns["svg_results"], j_ad.uns["svg_results"]
    assert list(res.columns) == ["gene", "moran_i", "pval", "padj"]
    assert list(res["gene"]) == list(ref["gene"])
    for col in ("moran_i", "pval", "padj"):
        np.testing.assert_allclose(res[col], ref[col], rtol=1e-12, atol=1e-300,
                                   err_msg=col)


def test_svg_builds_its_own_graph(rng):
    """Without a graph in obsp, svg builds the port's own k-NN graph; on
    random coordinates (no distance ties) it is JAX's graph."""
    n, g = 120, 12
    coords = rng.random((n, 2))
    X = rng.poisson(3.0, (n, g)).astype(float)
    X[:, 0] = 10 * coords[:, 0] + rng.normal(0, 0.5, n)
    j_ad, t_ad = both(X)
    j_ad.obsm["spatial"] = coords
    t_ad.obsm["spatial"] = coords
    assert tgs.svg(t_ad, n_neighs=4) == jgs.svg(j_ad, n_neighs=4)
    np.testing.assert_allclose(t_ad.uns["svg_results"]["padj"],
                               j_ad.uns["svg_results"]["padj"], rtol=1e-12)


def test_spapros_requires_package():
    with pytest.raises(ImportError, match="spapros"):
        tgs.spapros(tgt.AnnData(X=np.ones((2, 2))))


@pytest.fixture
def sc_sp_pair(rng):
    c, s, g = 60, 20, 15
    centers = rng.normal(0, 1, (3, g)) * 1.5
    labels = rng.integers(0, 3, c)
    S = rng.poisson(np.exp(centers[labels] * 0.5) + 1).astype(np.float32)
    mix = rng.dirichlet([1, 1, 1], s)
    G = rng.poisson((mix @ np.exp(centers * 0.5)) * 5 + 1).astype(np.float32)
    obs = pd.DataFrame({"cell_subclass": pd.Categorical([f"t{l}" for l in labels])},
                       index=[f"c{i}" for i in range(c)])
    return both(S, obs), both(G)


def test_fraction_estimation_sums_to_one(sc_sp_pair):
    (j_sc, t_sc), (j_sp, t_sp) = sc_sp_pair
    fr = tcs.estimate_cell_type_fractions(t_sc, t_sp, "cell_subclass")
    pd.testing.assert_series_equal(
        fr, jcs.estimate_cell_type_fractions(j_sc, j_sp, "cell_subclass"),
        check_exact=True)
    assert fr.sum() == pytest.approx(1.0)
    assert (fr >= 0).all()
    assert set(fr.index) == {"t0", "t1", "t2"}


def test_cell_number_estimation(sc_sp_pair):
    _, (j_sp, t_sp) = sc_sp_pair
    counts = tcs.estimate_cell_number_rna_reads(t_sp, mean_cell_numbers=5)
    np.testing.assert_array_equal(counts,
                                  jcs.estimate_cell_number_rna_reads(j_sp, 5))
    assert counts.min() >= 1
    assert counts.mean() == pytest.approx(5, abs=1.5)


@pytest.mark.parametrize("random_state", [0, 7])
def test_downsample_transcripts(rng, random_state):
    X = rng.poisson(10, (5, 40)).astype(np.float64) * 100
    out = tcs.downsample_transcripts(X, max_transcripts_per_cell=200,
                                     random_state=random_state)
    np.testing.assert_array_equal(out, jcs.downsample_transcripts(
        X, max_transcripts_per_cell=200, random_state=random_state))
    assert (out.sum(axis=1) <= 200 + 1e-9).all()


@pytest.mark.parametrize("sampling_method", ["duplicates", "place_holders"])
def test_cell_sampling_end_to_end(sc_sp_pair, sampling_method):
    (j_sc, t_sc), (j_sp, t_sp) = sc_sp_pair
    kw = dict(cell_type_key="cell_subclass", mean_cell_numbers=3,
              max_transcripts_per_cell=500, sampling_method=sampling_method)
    out = tcs.cell_sampling(t_sc, t_sp, **kw)
    want = jcs.cell_sampling(j_sc, j_sp, **kw)
    assert isinstance(out, tgt.AnnData)
    np.testing.assert_array_equal(np.asarray(out.X), np.asarray(want.X))
    pd.testing.assert_frame_equal(out.obs, want.obs)
    pd.testing.assert_frame_equal(out.var, want.var)
    assert out.uns["cell_sampling"] == want.uns["cell_sampling"]
    assert out.n_vars == t_sc.n_vars
    assert set(out.obs["cell_subclass"]) <= {"t0", "t1", "t2"}
