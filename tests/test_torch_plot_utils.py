"""The PyTorch port's plotting suite against the JAX package's, case for case
with ``tests/test_plot_utils.py``, on the Agg backend.

Plotting is host code, so on the same inputs the port must draw the same
data: both packages start from one mapping (the JAX package's, copied into
the port's AnnData), every figure each call leaves open is drawn, and the
scatter offsets, color arrays and limits, bar and box geometry, lines,
images and titles of every axes must be equal, as must the frames the
calls write (``obsm['tangram_ct_pred']``, ``obs['entropy']``, the score
tables).
"""

import copy

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import tangram_tpu as tg  # noqa: E402
import tangram_tpu_torch as tgt  # noqa: E402
from tangram_tpu import plot_utils as jpu  # noqa: E402
from tangram_tpu_torch import plot_utils as tpu  # noqa: E402

N_CELLS, N_SPOTS, N_GENES = 40, 30, 15


@pytest.fixture(scope="module")
def jax_mapping():
    """The numpy inputs and one JAX mapping of them (the JAX file's
    fixture), computed once."""
    rng = np.random.default_rng(0)
    inp = dict(
        S=(rng.poisson(2.0, (N_CELLS, N_GENES)) + 1).astype(np.float32),
        G=(rng.poisson(2.0, (N_SPOTS, N_GENES)) + 1).astype(np.float32),
        labels=rng.choice(["a", "b"], N_CELLS),
        coords=rng.random((N_SPOTS, 2)),
    )
    ad_sc, ad_sp = adatas(tg, inp)
    tg.pp_adatas(ad_sc, ad_sp)
    ad_map = tg.map_cells_to_space(ad_sc, ad_sp, mode="cells", num_epochs=20,
                                   random_state=0, verbose=False)
    return inp, ad_map


def adatas(pkg, inp):
    ad_sc = pkg.AnnData(
        X=inp["S"].copy(),
        obs=pd.DataFrame({"cell_type": pd.Categorical(inp["labels"])},
                         index=[f"c{i}" for i in range(N_CELLS)]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(N_GENES)]))
    coords = inp["coords"]
    ad_sp = pkg.AnnData(
        X=inp["G"].copy(),
        obs=pd.DataFrame({"x": coords[:, 0], "y": coords[:, 1]},
                         index=[f"s{i}" for i in range(N_SPOTS)]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(N_GENES)]))
    ad_sp.obsm["spatial"] = coords.copy()
    return ad_sc, ad_sp


@pytest.fixture
def mapped(jax_mapping):
    """{package: (ad_sc, ad_sp, ad_map)}, the maps equal to the JAX one."""
    inp, jmap = jax_mapping
    out = {}
    for pkg in (tg, tgt):
        ad_sc, ad_sp = adatas(pkg, inp)
        pkg.pp_adatas(ad_sc, ad_sp)
        ad_map = pkg.AnnData(X=np.asarray(jmap.X).copy(), obs=jmap.obs.copy(),
                             var=jmap.var.copy(), uns=copy.deepcopy(dict(jmap.uns)))
        ad_map.var["x"] = inp["coords"][:, 0]
        ad_map.var["y"] = inp["coords"][:, 1]
        out[pkg] = (ad_sc, ad_sp, ad_map)
    return out


def teardown_function(_):
    plt.close("all")


def drawn():
    """What every open figure draws, axes by axes, then closes them."""
    out = []
    for num in plt.get_fignums():
        fig = plt.figure(num)
        fig.canvas.draw()
        for ax in fig.axes:
            out.append(("title", ax.get_title(), ax.get_xlabel(), ax.get_ylabel()))
            out.append(("limits", ax.get_xlim(), ax.get_ylim()))
            for c in ax.collections:
                out.append(("offsets", np.asarray(c.get_offsets(), dtype=float)))
                if c.get_array() is not None:
                    out.append(("colors", np.asarray(c.get_array(), dtype=float),
                                c.get_clim()))
                out.append(("facecolors", np.asarray(c.get_facecolors())))
            for p in ax.patches:
                out.append(("patch", np.asarray(p.get_extents().bounds)))
            for line in ax.lines:
                out.append(("line", np.asarray(line.get_xydata(), dtype=float)))
            for im in ax.images:
                out.append(("image", np.asarray(im.get_array())))
            for text in ax.texts:
                out.append(("text", text.get_text()))
    plt.close("all")
    return out


def assert_same_drawing(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=g[0])
            else:
                assert a == b, g[0]


def draw_both(mapped, call):
    """``call(pkg, plot_module, (ad_sc, ad_sp, ad_map))`` in each package;
    returns (its results, JAX's results), the drawings held equal."""
    results, drawings = [], []
    for pkg, pu in ((tg, jpu), (tgt, tpu)):
        plt.close("all")
        results.append(call(pkg, pu, mapped[pkg]))
        drawings.append(drawn())
    assert_same_drawing(drawings[1], drawings[0])
    return results[1], results[0]


def test_q_value(rng):
    data = rng.random(100)
    vmin, vmax = tpu.q_value(data, 5)
    assert (vmin, vmax) == jpu.q_value(data, 5)
    assert vmin < vmax


def test_ordered_predictions():
    xs, ys, vs = tpu.ordered_predictions([1, 2, 3], [4, 5, 6], [0.3, 0.1, 0.2])
    assert (xs, ys, vs) == jpu.ordered_predictions([1, 2, 3], [4, 5, 6], [0.3, 0.1, 0.2])
    assert vs == sorted(vs)
    assert xs == [2, 3, 1]


def test_plot_training_scores(mapped):
    draw_both(mapped, lambda pkg, pu, ads: pu.plot_training_scores(ads[2]))


def test_plot_cell_annotation(mapped):
    draw_both(mapped, lambda pkg, pu, ads: pu.plot_cell_annotation(
        ads[2], ads[1], annotation="cell_type", nrows=1, ncols=2))
    pd.testing.assert_frame_equal(mapped[tgt][1].obsm["tangram_ct_pred"],
                                  mapped[tg][1].obsm["tangram_ct_pred"], check_exact=True)


def test_plot_cell_annotation_sc(mapped):
    def call(pkg, pu, ads):
        pkg.project_cell_annotations(ads[2], ads[1], annotation="cell_type")
        pu.plot_cell_annotation_sc(ads[1], ["a", "b"], spot_size=30, scale_factor=1.0)
        return list(ads[1].obs.columns)

    got, want = draw_both(mapped, call)
    assert got == want and not {"a", "b"} & set(got)  # obs left as it was


def test_plot_genes_and_quick(mapped):
    def call(pkg, pu, ads):
        ad_sc, ad_sp, ad_map = ads
        ad_ge = pkg.project_genes(ad_map, ad_sc)
        ad_ge.obs["x"] = ad_sp.obs["x"].to_numpy()
        ad_ge.obs["y"] = ad_sp.obs["y"].to_numpy()
        genes = sorted(ad_sc.uns["training_genes"])[:2]
        pu.plot_genes(genes, ad_sp, ad_ge)
        pu.quick_plot_gene(genes[0], ad_sp)
        return np.asarray(ad_ge.X)

    got, want = draw_both(mapped, call)
    np.testing.assert_array_equal(got, want)


def test_plot_genes_log_measured_panel_autoscales(mapped):
    def call(pkg, pu, ads):
        ad_sc, ad_sp, ad_map = ads
        ad_ge = pkg.project_genes(ad_map, ad_sc)
        ad_ge.obs["x"] = ad_sp.obs["x"].to_numpy()
        ad_ge.obs["y"] = ad_sp.obs["y"].to_numpy()
        gene = sorted(ad_sc.uns["training_genes"])[0]
        fig = pu.plot_genes([gene], ad_sp, ad_ge, log=True)
        fig.canvas.draw()
        vals = np.log1p(np.asarray(ad_sp[:, gene].X).ravel())
        return fig.axes[0].collections[0].get_clim(), (vals.min(), vals.max())

    (clim, (lo, hi)), (want_clim, _) = draw_both(mapped, call)
    assert clim == want_clim
    assert clim[1] == pytest.approx(hi)
    assert clim[0] == pytest.approx(lo)


def test_plot_genes_sc(mapped):
    def call(pkg, pu, ads):
        ad_sc, ad_sp, ad_map = ads
        ad_ge = pkg.project_genes(ad_map, ad_sc)
        genes = sorted(ad_sc.uns["training_genes"])[:2]
        return pu.plot_genes_sc(genes, ad_sp, ad_ge, spot_size=30, scale_factor=1.0,
                                return_figure=True) is not None

    assert draw_both(mapped, call) == (True, True)


def test_plot_annotation_entropy(mapped):
    def call(pkg, pu, ads):
        pu.plot_annotation_entropy(ads[2], annotation="cell_type")
        return ads[2].obs["entropy"]

    got, want = draw_both(mapped, call)
    pd.testing.assert_series_equal(got, want, check_exact=True)


def test_plot_test_scores_and_auc(mapped):
    def call(pkg, pu, ads):
        ad_sc, ad_sp, ad_map = ads
        ad_ge = pkg.project_genes(ad_map, ad_sc)
        df = pkg.compare_spatial_geneexp(ad_ge, ad_sp, ad_sc)
        pu.plot_test_scores(df.assign(is_training=False))
        pu.plot_auc(df.assign(is_training=False))
        return df

    got, want = draw_both(mapped, call)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_plot_test_scores_missing_columns():
    for pu in (jpu, tpu):
        with pytest.raises(ValueError, match="missing columns"):
            pu.plot_test_scores(pd.DataFrame({"score": [0.5]}))


def test_robust_perc_validation(mapped):
    _, ad_sp, ad_map = mapped[tgt]
    with pytest.raises(ValueError, match="perc cannot be zero"):
        tpu.plot_cell_annotation(ad_map, ad_sp, annotation="cell_type", robust=True,
                                 perc=0)
    with pytest.raises(ValueError, match="perc is zero"):
        tpu.quick_plot_gene("g0", ad_sp, robust=False, perc=5)


def test_mapping_colors_table():
    assert tpu.mapping_colors == jpu.mapping_colors
    assert "L6 CT" in tpu.mapping_colors
    assert len(tpu.mapping_colors) == 27


def test_plot_gene_sparsity_and_obs_helpers(mapped):
    def call(pkg, pu, ads):
        ad_sc, ad_sp, _ = ads
        pu.plot_gene_sparsity(ad_sc, ad_sp)
        pu.convert_adata_array(ad_sp)
        frame = pd.DataFrame(np.asarray(ad_sp.X)[:, :3], index=ad_sp.obs.index,
                             columns=["u", "v", "w"])
        pu.construct_obs_plot(frame, ad_sp, perc=0.1, suffix="s")
        return ad_sp.obs, ad_sc.var["sparsity"]

    (obs, sparsity), (want_obs, want_sparsity) = draw_both(mapped, call)
    pd.testing.assert_frame_equal(obs, want_obs, check_exact=True)
    pd.testing.assert_series_equal(sparsity, want_sparsity, check_exact=True)


def test_flat_namespace_reaches_the_plots():
    for name in ("plot_training_scores", "plot_cell_annotation", "q_value",
                 "mapping_colors"):
        assert getattr(tgt, name) is getattr(tpu, name)
