"""The port's hyperparameter tuner (``tangram_tpu_torch.tuning``) against the
JAX package's, on the CPU (``device="cpu"``).

Every input is made from a numpy seed and goes through both packages.
Tolerances, stated before measuring and each far below what the tuner
ranks on:

* host functions (``pearson_corr``, ``vote_entropy``, ``consensus_entropy``,
  ``_coerce_domain``, the active-λ sets, ``_halving_rungs``,
  ``_select_order``): float64 numpy on both sides, so 1e-12 (and exact
  where nothing is computed);
* ``_tuner_loss``: the value to 1e-5 relative and the gradient to 1e-4 of
  its largest entry (f32 sums in two libraries' orders, as
  ``tests/test_torch_losses.py`` holds the loss terms);
* ``_device_metrics``: to JAX's to 1e-5 absolute (the same f32 formulas),
  to the host float64 reference to JAX's own 1e-4 relative and 1e-5
  absolute (``tests/test_tuning.py``);
* ``_PopulationSetup.M0s``: bit for bit, under the same ambient seed;
* trained populations (``_run_population``, the four search modes): the
  sampled configs identical, each metric within 2e-5 absolute after 30
  epochs of f32 Adam (a two-library f32 spread; a rank swap needs ~1e-3),
  halving's survivors and ``trained_epochs`` identical on a fixture whose
  ranking margins at every rung the test checks first (> 100× that
  tolerance).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu import tuning as jt
from tangram_tpu_torch import tuning as tt


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fixtures are tiny: one intra-op thread keeps these tests from
    contending for every core with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HOST_TOL = 1e-12
METRIC_ATOL = 2e-5


def tuner_adatas(api, seed=0, n_cells=30, n_spots=24, n_genes=12):
    """``tests/test_tuning.py``'s ``tuner_adatas`` fixture (30 cells × 24
    spots × 12 genes, 3 cell types), through ``api``'s AnnData."""
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (n_cells, n_genes)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (n_spots, n_genes)) + 1).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(n_genes)])
    ad_sc = api.AnnData(
        X=S,
        obs=pd.DataFrame(
            {"subclass_label": pd.Categorical(rng.choice(["a", "b", "c"], n_cells))},
            index=[f"c{i}" for i in range(n_cells)],
        ),
        var=genes.copy(),
    )
    ad_sp = api.AnnData(X=G, obs=pd.DataFrame(index=[f"s{i}" for i in range(n_spots)]),
                        var=genes.copy())
    ad_sp.obsm["spatial"] = rng.random((n_spots, 2))
    api.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, port pair) on the same data; the port's spot graph is
    JAX's (the two neighbor searches may break distance ties apart)."""
    jsc, jsp = tuner_adatas(tg)
    tsc, tsp = tuner_adatas(tgt)
    for key in ("spatial_connectivities", "spatial_distances"):
        tsp.obsp[key] = jsp.obsp[key].copy()
    return (jsc, jsp), (tsc, tsp)


def space(mod, graph=True, num_epochs=30):
    out = {"learning_rate": mod.loguniform(0.02, 0.5), "lambda_d": mod.uniform(0.0, 1.0),
           "lambda_r": mod.loguniform(1e-6, 1e-2), "num_epochs": num_epochs}
    if graph:
        out.update(lambda_neighborhood_g1=mod.uniform(0.0, 1.0),
                   lambda_ct_islands=mod.uniform(0.0, 1.0),
                   lambda_getis_ord=mod.uniform(0.0, 1.0))
    return out


def loss_arrays(seed=5, c=12, s=9, g=7, masked=(1, 4)):
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (c, g)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.5).astype(np.float32)
    d = rng.random(s).astype(np.float32)
    d /= d.sum()
    mask = np.ones(g, np.float32)
    mask[list(masked)] = 0.0
    W = (rng.random((s, s)) * (rng.random((s, s)) < 0.5)).astype(np.float32)
    ct = np.zeros((c, 3), np.float32)
    ct[np.arange(c), rng.integers(0, 3, c)] = 1
    Gm = G * mask
    getis_ref = ((W @ Gm) / Gm.sum(axis=0).clip(1e-30)).astype(np.float32)
    return (S, G, d, mask, W, W.T.copy(), ct, W + np.eye(s, dtype=np.float32), getis_ref)


LAM = dict(lambda_g1=0.9, lambda_g2=0.4, lambda_d=0.6, lambda_r=0.05, lambda_l1=0.02,
           lambda_l2=0.01, lambda_neighborhood_g1=0.3, lambda_ct_islands=0.25,
           lambda_getis_ord=0.35)


# ---------------------------------------------------------------------------
# host functions, to 1e-12
# ---------------------------------------------------------------------------


def cubes():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 14, 11)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    zero_var = probs.copy()
    zero_var[1] = 1.0 / 11  # one run with no variance
    high_mean = 1e8 + rng.normal(size=(3, 50, 60)) * 0.1
    ties = np.zeros((4, 6, 5))
    ties[:, :, 1] = 1.0
    ties[2, :3] = 0.2  # tied argmax rows
    return {"random": probs, "zero_var": zero_var, "high_mean": high_mean, "ties": ties}


@pytest.mark.parametrize("name", list(cubes()))
@pytest.mark.parametrize("fn", ["pearson_corr", "vote_entropy", "consensus_entropy"])
def test_host_metrics_match_jax(fn, name):
    cube = cubes()[name]
    got, want = getattr(tt, fn)(cube), getattr(jt, fn)(cube)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=HOST_TOL, atol=HOST_TOL)


class _RaySampler:
    def __init__(self, base=None):
        if base is not None:
            self.base = base


class _RayFloat:
    """Structural twin of ray.tune.sample.Float (lower/upper + sampler)."""

    def __init__(self, lower, upper, log=False):
        self.lower, self.upper = lower, upper
        self.sampler = _RaySampler(base=10 if log else None)


class _RayCategorical:
    def __init__(self, categories):
        self.categories = categories


class _OptunaFloatDistribution:
    def __init__(self, low, high, log=False):
        self.low, self.high, self.log = low, high, log


class _OptunaIntDistribution:
    def __init__(self, low, high):
        self.low, self.high = low, high


class _OptunaCategoricalDistribution:
    def __init__(self, choices):
        self.choices = choices


DOMAINS = {
    "uniform": lambda m: m.uniform(0.1, 0.9),
    "loguniform": lambda m: m.loguniform(1e-3, 1.0),
    "choice": lambda m: m.choice([100, 500, 1000]),
    "int": lambda m: 3,
    "float": lambda m: 0.25,
    "ray_float": lambda m: _RayFloat(0.1, 0.9),
    "ray_log": lambda m: _RayFloat(1e-3, 1.0, log=True),
    "ray_choice": lambda m: _RayCategorical([4, 6]),
    "optuna_float": lambda m: _OptunaFloatDistribution(0.0, 2.0),
    "optuna_log": lambda m: _OptunaFloatDistribution(1e-2, 10.0, log=True),
    "optuna_int": lambda m: _OptunaIntDistribution(1, 9),
    "optuna_choice": lambda m: _OptunaCategoricalDistribution(("a", "b")),
}


@pytest.mark.parametrize("name", list(DOMAINS))
def test_coerce_domain_matches_jax(name):
    got = tt._coerce_domain(DOMAINS[name](tt))
    want = jt._coerce_domain(DOMAINS[name](jt))
    assert type(got).__name__ == type(want).__name__
    assert got.__dict__ == want.__dict__
    for u in (0.0, 0.13, 0.5, 0.77, 0.999):
        g, w = got.from_unit(u), want.from_unit(u)
        if isinstance(w, str):
            assert g == w
        else:
            assert g == pytest.approx(w, rel=HOST_TOL, abs=HOST_TOL)


def test_coerce_domain_rejects_like_jax():
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="Unsupported"):
            mod._coerce_domain("not-a-domain")


def test_active_lambda_sets_match_jax():
    keys = [k for k in tt.TUNABLE_KEYS if k.startswith("lambda")]
    assert keys == [k for k in jt.TUNABLE_KEYS if k.startswith("lambda")]
    configs = [{"lambda_g1": 1.0, "lambda_d": 0.0}, {"lambda_d": 0.5, "lambda_r": 0.0},
               {"lambda_getis_ord": 1e-9}]
    assert tt._active_lambdas(configs, keys) == jt._active_lambdas(configs, keys)
    assert tt._active_lambdas(configs, keys) == {"lambda_g1", "lambda_d", "lambda_getis_ord"}

    def domains(mod):
        return {
            "lambda_g1": mod.uniform(0.5, 1.0),
            "lambda_d": mod._coerce_domain(0.0),       # fixed 0: inactive
            "lambda_r": mod._coerce_domain(0.3),       # fixed nonzero
            "lambda_getis_ord": mod.choice([0.0, 0.0]),  # all-zero choice
            "lambda_ct_islands": mod.choice([0.0, 0.5]),
            "lambda_l1": mod.loguniform(1e-6, 1e-2),
            "lambda_l2": 0.0,
            "lambda_neighborhood_g1": object(),        # unrecognized: active
        }

    got = tt._space_active_lambdas(domains(tt), keys)
    assert got == jt._space_active_lambdas(domains(jt), keys)
    assert got == {"lambda_g1", "lambda_r", "lambda_ct_islands", "lambda_l1",
                   "lambda_neighborhood_g1"}


@pytest.mark.parametrize("n,total,eta", [(1, 10, 3), (4, 16, 3), (8, 30, 3), (27, 300, 3),
                                         (10, 7, 2), (50, 1000, 4)])
def test_halving_rungs_match_jax(n, total, eta):
    assert tt._halving_rungs(n, total, eta) == jt._halving_rungs(n, total, eta)


@pytest.mark.parametrize("m,nan_rows", [(1, 0), (2, 0), (3, 2), (1, 3)])
def test_select_order_matches_jax(m, nan_rows):
    rng = np.random.default_rng(m + nan_rows)
    Y = np.round(rng.random((15, m)) * 4) / 4
    Y[:nan_rows, 0] = np.nan
    np.testing.assert_array_equal(tt._select_order(Y), jt._select_order(Y))


def test_result_grid_matches_jax():
    df = pd.DataFrame({
        "gene_expr_correctness": [0.2, 0.9, 0.5, np.nan],
        "cell_map_consistency": [0.8, 0.1, 0.7, 0.9],
        "config/learning_rate": [0.1, 0.2, 0.3, 0.4],
        "config/num_epochs": np.array([10, 20, 30, 40], dtype=np.int64),
    })
    for metric, mode in (("gene_expr_correctness", "max"), ("gene_expr_correctness", "min"),
                         (["gene_expr_correctness", "cell_map_consistency"], "max"),
                         ("cell_map_consistency", "min")):
        got = tt.TunerResult(df).get_results().get_best_result(metric=metric, mode=mode)
        want = jt.TunerResult(df).get_results().get_best_result(metric=metric, mode=mode)
        assert got.config == want.config
        assert [type(v) for v in got.config.values()] == [type(v) for v in want.config.values()]
        np.testing.assert_equal(got.metrics, want.metrics)
    grid = tt.TunerResult(df).fit()
    assert grid.get_dataframe() is df
    with pytest.raises(ValueError, match="metric"):
        grid.get_best_result()
    with pytest.raises(ValueError, match="mode"):
        grid.get_best_result(metric="gene_expr_correctness", mode="bogus")


# ---------------------------------------------------------------------------
# the loss, the device metrics and the inits
# ---------------------------------------------------------------------------

ACTIVE_SETS = {
    "all": None,
    "no_graph": frozenset({"lambda_d", "lambda_r", "lambda_l1", "lambda_l2"}),
    "graph_only": frozenset({"lambda_neighborhood_g1", "lambda_ct_islands",
                             "lambda_getis_ord"}),
}


@pytest.mark.parametrize("active", list(ACTIVE_SETS))
def test_tuner_loss_matches_jax(active):
    """Value and gradient of each member of a population of 3 (each with
    its own λs) against JAX's loss of that member alone. Genes are masked
    only without the graph terms: with a masked gene and Getis-Ord on,
    JAX's gradient is NaN (the masked column's Σ G_pred is 0, and the
    gradient of x / max(Σ, 1e-30) there is 0 · (−0 / 1e-60) in f32), where
    the port's clamp passes no gradient to the clamped sum."""
    import jax
    import jax.numpy as jnp

    arrays = loss_arrays(masked=(1, 4) if active == "no_graph" else ())
    rng = np.random.default_rng(11)
    c, s = arrays[0].shape[0], arrays[1].shape[0]
    Ms = rng.normal(size=(3, c, s)).astype(np.float32)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    act = ACTIVE_SETS[active]

    lam_t = {k: torch.tensor(v * scales) for k, v in LAM.items()}
    Mv = torch.tensor(Ms, requires_grad=True)
    total, gv = tt._tuner_loss(Mv, lam_t, tuple(torch.tensor(a) for a in arrays), act)
    (grad,) = torch.autograd.grad(total.sum(), (Mv,))
    assert total.shape == gv.shape == (3,)

    j_arrays = tuple(jnp.asarray(a) for a in arrays)
    for m in range(3):
        lam_j = {k: jnp.float32(v * scales[m]) for k, v in LAM.items()}
        (v_j, gv_j), g_j = jax.value_and_grad(
            lambda x: jt._tuner_loss(x, lam_j, j_arrays, act), has_aux=True)(
                jnp.asarray(Ms[m]))
        assert float(total[m].detach()) == pytest.approx(float(v_j), rel=1e-5)
        assert float(gv[m].detach()) == pytest.approx(float(gv_j), rel=1e-5)
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(grad[m].numpy(), g_j, rtol=0,
                                   atol=1e-4 * np.abs(g_j).max())


def test_tuner_loss_active_skip_is_exact():
    """Skipping the terms whose λ is zero across the population is bit
    for bit computing them with λ = 0: value and gradient."""
    arrays = tuple(torch.tensor(a) for a in loss_arrays(seed=6))
    rng = np.random.default_rng(5)
    M = torch.tensor(rng.normal(size=(2,) + (arrays[0].shape[0], arrays[1].shape[0])),
                     dtype=torch.float32)
    lam = {k: torch.zeros(2) for k in LAM}
    lam.update(lambda_g1=torch.tensor([1.0, 0.8]), lambda_d=torch.tensor([0.7, 0.1]),
               lambda_r=torch.tensor([0.01, 0.0]))
    active = tt._active_lambdas([{"lambda_g1": 1.0, "lambda_d": 0.7, "lambda_r": 0.01}],
                                list(LAM))
    assert "lambda_getis_ord" not in active

    def value_and_grad(act):
        Mv = M.clone().requires_grad_()
        total, _ = tt._tuner_loss(Mv, lam, arrays, act)
        return total.detach(), torch.autograd.grad(total.sum(), (Mv,))[0]

    (v_full, g_full), (v_skip, g_skip) = value_and_grad(None), value_and_grad(active)
    assert torch.equal(v_full, v_skip)
    assert torch.equal(g_full, g_skip)


def test_device_metrics_match_jax_and_host():
    """One config's cube against JAX's device metrics and the host float64
    functions; a batch of configs gives each config's metrics."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    p, c, s, gv = 3, 14, 11, 6
    logits = rng.normal(size=(4, p, c, s)).astype(np.float32) * 2.0
    logits[1, 2] = logits[1, 0]  # two runs vote alike
    cubes_ = np.exp(logits)
    cubes_ /= cubes_.sum(axis=-1, keepdims=True)
    S_val = rng.random((c, gv)).astype(np.float32)
    val_sims = rng.random((4, p)).astype(np.float32)

    batch = tt._device_metrics(torch.tensor(cubes_), torch.tensor(val_sims),
                               torch.tensor(S_val))
    assert list(batch) == tt.METRIC_KEYS
    for b in range(4):
        cube = cubes_[b]
        one = tt._device_metrics(torch.tensor(cube), torch.tensor(val_sims[b]),
                                 torch.tensor(S_val))
        jax_m = jt._device_metrics(jnp.asarray(cube), jnp.asarray(val_sims[b]),
                                   jnp.asarray(S_val))
        gene_cube = np.array([S_val.T.astype(np.float64) @ cube[r] for r in range(p)])
        host = {
            "cell_map_consistency": float(tt.pearson_corr(cube).mean()),
            "cell_map_agreement": float(1 - tt.vote_entropy(cube).mean()),
            "cell_map_certainty": float(1 - tt.consensus_entropy(cube).mean()),
            "gene_expr_consistency": float(tt.pearson_corr(gene_cube).mean()),
            "gene_expr_correctness": float(val_sims[b].mean()),
        }
        for k in tt.METRIC_KEYS:
            assert float(one[k]) == pytest.approx(float(jax_m[k]), abs=1e-5), k
            assert float(one[k]) == pytest.approx(host[k], rel=1e-4, abs=1e-5), k
            assert float(batch[k][b]) == pytest.approx(float(one[k]), abs=1e-6), k


def test_repeat_inits_match_jax_bit_for_bit():
    """Run 0 continues the ambient numpy stream, runs 1 and 2 reseed: the
    port's three inits are JAX's under the same ambient seed."""
    arrays = loss_arrays(c=14, s=9)
    args = (arrays[0], arrays[1], arrays[2], arrays[4], arrays[5], arrays[6], arrays[7],
            list(range(7)), [0, 2, 5])
    np.random.seed(777)
    got = tt._PopulationSetup(*args, device="cpu").M0s
    np.random.seed(777)
    want = np.asarray(jt._PopulationSetup(*args).M0s)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 14, 9)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# trained populations against JAX
# ---------------------------------------------------------------------------


def population_kwargs(pair, mod, train_genes_idx=None, val_genes_idx=None):
    """The arrays mapping_hyperparameter_tuning builds, from ``mod``'s
    spot graph and one-hot helpers, for the direct trainers (every gene
    trains and validates by default, as the tuner's default)."""
    ad_sc, ad_sp = pair
    genes = ad_sc.uns["overlap_genes"]
    S = np.asarray(ad_sc[:, genes].X, dtype=np.float32)
    G = np.asarray(ad_sp[:, genes].X, dtype=np.float32)
    sw = mod.spatial
    return dict(
        S=S, G=G, d=np.asarray(ad_sp.obs["rna_count_based_density"], np.float32),
        voxel_weights=sw.spatial_weights(ad_sp, standardized=True, self_inclusion=True),
        neighborhood_filter=sw.spatial_weights(ad_sp, standardized=False,
                                               self_inclusion=False),
        ct_encode=mod.utils.one_hot_encoding(ad_sc.obs["subclass_label"]).values,
        spatial_weights=sw.spatial_weights(ad_sp, standardized=False, self_inclusion=True),
        train_genes_idx=list(range(len(genes))) if train_genes_idx is None else train_genes_idx,
        val_genes_idx=list(range(len(genes))) if val_genes_idx is None else val_genes_idx,
    )


@pytest.mark.parametrize("genes", ["all", "split"])
def test_run_population_matches_jax(pairs, genes):
    """4 configs, constant and cosine learning rates and the graph terms,
    30 epochs, in batches of 3 (one batch of 3 configs, one of 1); every
    gene, or a train/val split of the genes. With the split the Getis-Ord
    config is left out: with a gene masked out of training, JAX's
    Getis-Ord gradient is NaN (see test_tuner_loss_matches_jax)."""
    configs = [
        {"learning_rate": 0.1, "lambda_g1": 1.0, "lambda_d": 0.4, "num_epochs": 30},
        {"lr_peak": 0.3, "lr_end": 0.01, "lambda_g1": 0.8, "lambda_r": 1e-3,
         "num_epochs": 30},
        {"learning_rate": 0.05, "lambda_g1": 1.0, "lambda_g2": 0.5,
         "lambda_neighborhood_g1": 0.6, "lambda_ct_islands": 0.3, "num_epochs": 30},
        {"lr_peak": 0.2, "lr_end": 0.05, "lambda_g1": 1.0, "lambda_getis_ord": 0.7,
         "lambda_l1": 1e-3, "lambda_l2": 1e-3, "num_epochs": 30},
    ]
    split = {}
    if genes == "split":
        configs[3] = dict(configs[3], lambda_getis_ord=0.0)
        split = dict(train_genes_idx=list(range(9)), val_genes_idx=[1, 5, 8, 11])
    (jpair, tpair) = pairs
    np.random.seed(21)
    want = jt._run_population(configs, population_batch_size=3,
                              **population_kwargs(jpair, tg, **split))
    np.random.seed(21)
    got = tt._run_population(configs, population_batch_size=3, device="cpu",
                             **population_kwargs(tpair, tgt, **split))
    assert np.isfinite(want.to_numpy()).all()
    assert list(got.columns) == list(want.columns) == sorted(tt.METRIC_KEYS)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=METRIC_ATOL)


def test_train_multiple_mapper_matches_jax(pairs):
    (jpair, tpair) = pairs

    def data(pair, mod):
        kw = population_kwargs(pair, mod)
        return (kw["S"], kw["G"], None, kw["d"], "cpu", 100, kw["voxel_weights"],
                kw["ct_encode"], kw["neighborhood_filter"], kw["spatial_weights"],
                kw["train_genes_idx"], kw["val_genes_idx"])

    config = {"learning_rate": 0.1, "lambda_g1": 1.0, "lambda_d": 0.5, "num_epochs": 20}
    np.random.seed(4)
    want = jt.train_multiple_Mapper(config, data(jpair, tg))
    np.random.seed(4)
    got = tt.train_multiple_Mapper(config, data(tpair, tgt))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k


def rung_margins(pair, configs, metric, eta):
    """At each halving rung of JAX's schedule (constant learning rates, so
    a rung's metrics are a fresh run to its target), the gap between the
    last survivor and the first eliminated trial by ``metric``, over the
    trials alive at that rung."""
    kw = population_kwargs(pair, tg)
    rungs = jt._halving_rungs(len(configs), int(configs[0]["num_epochs"]), eta)
    alive, margins = np.arange(len(configs)), []
    for (target, _), (_, keep) in zip(rungs, rungs[1:]):
        np.random.seed(8)
        df = jt._run_population([dict(configs[i], num_epochs=target) for i in alive],
                                population_batch_size=len(alive), **kw)
        vals = np.sort(df[metric].to_numpy())[::-1]
        margins.append(vals[keep - 1] - vals[keep])
        alive = alive[np.sort(np.argsort(-df[metric].to_numpy(), kind="stable")[:keep])]
    return margins


SEARCHES = ["sobol", "adaptive", "halving", "adaptive+halving"]


@pytest.mark.parametrize("search", SEARCHES)
def test_tuner_matches_jax(pairs, search):
    (jpair, tpair) = pairs
    metric = (["gene_expr_correctness"] if "halving" in search
              else ["gene_expr_correctness", "cell_map_consistency"])
    # seed 5 for halving: its rung's margin is 7.0e-3 (JAX, CPU); seed 3's
    # is 1.8e-4, too close for identical survivors to be owed
    kw = dict(metric=metric, tuner_num_samples=8, cluster_label="subclass_label",
              random_state=5 if search == "halving" else 3, population_batch_size=4,
              search=search)
    np.random.seed(8)
    want = tg.mapping_hyperparameter_tuning(*jpair, config=space(jt), **kw)
    np.random.seed(8)
    got = tgt.mapping_hyperparameter_tuning(*tpair, config=space(tt), device="cpu", **kw)
    want, got = want.get_results().get_dataframe(), got.get_results().get_dataframe()

    assert list(got.columns) == list(want.columns)
    config_cols = [c for c in want.columns if c.startswith("config/")]
    pd.testing.assert_frame_equal(got[config_cols], want[config_cols], check_exact=True)
    np.testing.assert_allclose(got[tt.METRIC_KEYS].to_numpy(),
                               want[tt.METRIC_KEYS].to_numpy(), rtol=0, atol=METRIC_ATOL)
    assert np.isfinite(got[tt.METRIC_KEYS].to_numpy()).all()
    if search == "halving":
        configs = [{k.split("/", 1)[1]: v for k, v in row.items()}
                   for row in want[config_cols].to_dict("records")]
        margins = rung_margins(jpair, configs, metric[0], eta=3)
        assert min(margins) > 100 * METRIC_ATOL, margins
    if "halving" in search:
        np.testing.assert_array_equal(got["trained_epochs"].to_numpy(),
                                      want["trained_epochs"].to_numpy())
        assert set(got["trained_epochs"]) == {10, 30}
    best_t = tt.TunerResult(got).get_results().get_best_result(metric=metric)
    best_j = jt.TunerResult(want).get_results().get_best_result(metric=metric)
    assert best_t.config == best_j.config


def test_halving_restarted_rungs_match_carried(pairs, monkeypatch):
    """With the budget forced below the carried state, rungs restart from
    the inits in chunks: the same survivors, and (constant learning rates)
    the same metrics."""
    (_, tpair) = pairs
    kw = dict(metric=["gene_expr_correctness"], config=space(tt, graph=False),
              tuner_num_samples=6, cluster_label="subclass_label", random_state=3,
              population_batch_size=4, search="halving", device="cpu")
    np.random.seed(11)
    carried = tgt.mapping_hyperparameter_tuning(*tpair, **kw).get_results().get_dataframe()
    import tangram_tpu_torch.utils as tutils

    monkeypatch.setattr(tutils, "device_memory_budget", lambda *a, **k: 1.0)
    np.random.seed(11)
    restart = tgt.mapping_hyperparameter_tuning(*tpair, **kw).get_results().get_dataframe()
    np.testing.assert_array_equal(carried["trained_epochs"], restart["trained_epochs"])
    np.testing.assert_allclose(carried[tt.METRIC_KEYS].to_numpy(),
                               restart[tt.METRIC_KEYS].to_numpy(), rtol=0, atol=1e-6)


def test_input_errors_match_jax(pairs):
    (jpair, tpair) = pairs
    base = dict(metric=["cell_map_consistency"], config={"lambda_g1": 1.0},
                cluster_label="subclass_label", tuner_num_samples=1)
    cases = [
        (dict(metric=["not_a_metric"]), '"metric"'),
        (dict(config={"bogus": 1.0}), '"config"'),
        (dict(cluster_label=None), "cluster_label"),
        (dict(search="grid"), "search must be"),
        (dict(search="halving", halving_eta=1), "halving_eta"),
        (dict(density_prior="bogus"), "density_prior"),
        (dict(cv_train_genes=["nope"]), "training genes"),
        (dict(cv_val_genes=["nope"]), "validation genes"),
        (dict(search="halving", config={"num_epochs": "choice"}), "FIXED num_epochs"),
    ]
    for extra, match in cases:
        for api, mod, pair, dev in ((tg, jt, jpair, {}), (tgt, tt, tpair, {"device": "cpu"})):
            kw = {**base, **extra}
            if kw["config"] == {"num_epochs": "choice"}:
                kw["config"] = {"num_epochs": mod.choice([4, 6])}
            with pytest.raises(ValueError, match=match):
                api.mapping_hyperparameter_tuning(*pair, **dev, **kw)
    bare = tuner_adatas(tgt, seed=1)[0], tuner_adatas(tgt, seed=1)[1]
    del bare[0].uns["training_genes"]
    with pytest.raises(ValueError, match="pp_adatas"):
        tgt.mapping_hyperparameter_tuning(*bare, device="cpu", **base)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_resume_sobol(pairs, tmp_path):
    """Every batch is journaled; a sweep cut after its first batch resumes
    by skipping the recorded trials and equals the unbroken sweep."""
    (_, tpair) = pairs
    kw = dict(metric=["gene_expr_correctness"], config=space(tt, graph=False, num_epochs=10),
              tuner_num_samples=5, cluster_label="subclass_label", random_state=4,
              population_batch_size=2, device="cpu")
    np.random.seed(99)
    base = tgt.mapping_hyperparameter_tuning(*tpair, **kw).get_results().get_dataframe()
    path = str(tmp_path / "sweep.jsonl")
    np.random.seed(99)
    full = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    pd.testing.assert_frame_equal(base, full)

    lines = open(path).read().splitlines()
    assert len(lines) == 6
    with open(path, "w") as f:  # meta + the first batch of 2
        f.write("\n".join(lines[:3]) + "\n")
    np.random.seed(99)
    resumed = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    pd.testing.assert_frame_equal(base, resumed, rtol=1e-5, atol=1e-6)

    np.random.seed(0)  # a completed journal needs no ambient stream
    again = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    pd.testing.assert_frame_equal(resumed, again)
    with pytest.raises(ValueError, match="different sweep"):
        tgt.mapping_hyperparameter_tuning(*tpair, resume_path=path,
                                          **{**kw, "random_state": 5})


def test_resume_adaptive(pairs, tmp_path):
    """The journaled rounds are fed back to the TPE model: the resumed
    sweep asks the same remaining configs and equals the unbroken one."""
    (_, tpair) = pairs
    kw = dict(metric=["gene_expr_correctness"],
              config={"learning_rate": tt.loguniform(0.05, 0.3), "num_epochs": 10},
              tuner_num_samples=6, cluster_label="subclass_label", random_state=4,
              population_batch_size=2, search="adaptive", device="cpu")
    path = str(tmp_path / "sweep.jsonl")
    np.random.seed(99)
    full = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:3]) + "\n")
    np.random.seed(99)
    resumed = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    assert len(resumed) == 6
    pd.testing.assert_frame_equal(full.iloc[:2], resumed.iloc[:2])
    pd.testing.assert_frame_equal(full, resumed, rtol=1e-5, atol=1e-6)


def test_resume_halving_completed(pairs, tmp_path):
    (_, tpair) = pairs
    kw = dict(metric=["gene_expr_correctness"],
              config={"learning_rate": tt.loguniform(0.05, 0.3), "num_epochs": 16},
              tuner_num_samples=4, cluster_label="subclass_label", random_state=4,
              population_batch_size=2, search="halving", device="cpu")
    path = str(tmp_path / "sweep.jsonl")
    np.random.seed(7)
    full = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    np.random.seed(123)
    again = tgt.mapping_hyperparameter_tuning(
        *tpair, resume_path=path, **kw).get_results().get_dataframe()
    pd.testing.assert_frame_equal(full, again)
    assert sorted(set(full["trained_epochs"])) == [5, 16]


def test_mesh_raises_naming_a11(pairs):
    """A mesh that is no DeviceMesh is refused as the mapper refuses it
    (``tests/test_torch_population_mesh.py`` runs the meshes)."""
    (_, tpair) = pairs
    with pytest.raises(TypeError, match="DeviceMesh"):
        tgt.mapping_hyperparameter_tuning(
            *tpair, ["gene_expr_correctness"], {"lambda_g1": 1.0},
            cluster_label="subclass_label", tuner_num_samples=1, device="cpu",
            mesh=object())


def test_default_device_is_the_card(pairs, monkeypatch):
    """device=None means CUDA; without it the tuner raises instead of
    running on the CPU."""
    (_, tpair) = pairs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgt.mapping_hyperparameter_tuning(
            *tpair, ["gene_expr_correctness"], {"lambda_g1": 1.0},
            cluster_label="subclass_label", tuner_num_samples=1)


def test_tf32_setting_is_restored(pairs):
    (_, tpair) = pairs
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tgt.mapping_hyperparameter_tuning(
            *tpair, ["gene_expr_correctness"], {"lambda_g1": 1.0, "num_epochs": 2},
            cluster_label="subclass_label", tuner_num_samples=1, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_import_reads_no_jax():
    """The module's source names neither jax nor the JAX package (the
    module-walking import test checks the import itself)."""
    for mod in (tt, tgt.search):
        src = open(os.path.abspath(mod.__file__)).read()
        assert "import jax" not in src and "tangram_tpu." not in src.replace(
            "tangram_tpu_torch.", "")
