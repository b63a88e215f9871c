"""The PyTorch port's graph terms against the JAX package's.

The five graph terms (spatial neighborhood similarity, cell-type islands,
Getis-Ord, Moran and Geary preservation) live in the loss epilogue, a
function of the (spots × k) projection; the fused step differentiates that
epilogue alone and hands (dY, dq, dh) to the streamed kernels. So the
local indicators, each term and all five together, with their reported
values and the epilogue's cotangents, are held against the JAX package's
(``jax.vjp``) on the same seeded inputs, on a dense and on a k-NN spot
graph (``fit_mapping`` with them: ``tests/test_torch_graph_fit.py``;
``map_cells_to_space``: ``tests/test_torch_graph_mapping.py``).

The spot graphs are the JAX package's own, built from random spot
coordinates as ``map_cells_to_space`` builds them (``spatial_weights`` or
``neighbor_graph`` in the variant each term takes), and reach the port
through ``convert.mapper_data_from_jax``.

Tolerances: the indicators at rtol 1e-5 and atol 1e-6 of their largest
value (f32, sums in another order; Moran's z ⊙ (Wz) cancels); the
epilogue's terms and cotangents at rtol 1e-4, atol 1e-6 (the JAX package
holds its own fused epilogue to its XLA one at 2e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tangram_tpu import spatial as jsw
from tangram_tpu.ops import losses as jl
from tangram_tpu.ops.core import _mapper_core_xla
from tangram_tpu_torch import AnnData
from tangram_tpu_torch.convert import mapper_data_from_jax
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-4, 1e-6
GRAPH_LAMBDAS = dict(lambda_neighborhood_g1=0.5, lambda_ct_islands=0.3,
                     lambda_getis_ord=0.3, lambda_moran=0.3, lambda_geary=0.3)
TERMS = {
    "neighborhood": dict(lambda_neighborhood_g1=0.5),
    "ct_islands": dict(lambda_ct_islands=0.3),
    "getis_ord": dict(lambda_getis_ord=0.3),
    "moran": dict(lambda_moran=0.3),
    "geary": dict(lambda_geary=0.3),
    "all five": dict(GRAPH_LAMBDAS, lambda_g2=0.5, lambda_r=0.01),
}
REPORTED = ["main_loss", "vg_reg", "kl_reg", "entropy_reg", "l1_reg", "l2_reg",
            "gv_neighborhood_sim", "ct_island_penalty", "getis_ord_sim", "moran_sim",
            "geary_sim", "total_loss"]


def spot_graphs(s, kind, seed=2):
    """The three graph slots from random coordinates, dense f32 arrays or
    the JAX package's ``NeighborGraph``, in the variants that
    ``map_cells_to_space`` builds, except the islands' filter: standardized
    here, where the reference's binary one (a spot's type mass against its
    neighbors' sum) leaves ``max(·, 0)`` off on every entry of these
    problems, and the island term without a gradient to compare."""
    ad = AnnData(X=np.ones((s, 1), np.float32))
    ad.obsm["spatial"] = np.random.default_rng(seed).random((s, 2))
    jsw.spatial_neighbors(ad)
    if kind == "knn":
        build = jsw.neighbor_graph
    else:
        def build(ad, standardized, self_inclusion):
            return jnp.asarray(jsw.spatial_weights(ad, standardized, self_inclusion),
                               dtype=jnp.float32)
    return dict(voxel_weights=build(ad, True, True),
                neighborhood_filter=build(ad, True, False),
                spatial_weights=build(ad, False, True))


def make_problem(seed, kind, c=40, s=72, g=9, n_types=4, masked=False, zero_gene=False):
    """(M, JAX MapperData with the graphs, the cell types and the reference
    indicators of G)."""
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    if zero_gene:
        G[:, 2] = 0.0
    d = rng.random(s).astype(np.float32)
    ct = np.eye(n_types, dtype=np.float32)[rng.integers(0, n_types, c)]
    mask = None
    if masked:
        mask = np.ones(g, np.float32)
        mask[[1, 4]] = 0.0
    graphs = spot_graphs(s, kind)
    refs = jl.spatial_local_indicators(jnp.asarray(G), graphs["spatial_weights"],
                                       jl.LossWeights(**GRAPH_LAMBDAS))
    data = jl.MapperData(
        S=jnp.asarray(S), G=jnp.asarray(G), d=jnp.asarray(d / d.sum()),
        gene_mask=None if mask is None else jnp.asarray(mask),
        ct_encode=jnp.asarray(ct), getis_ord_ref=refs[0], moran_ref=refs[1],
        geary_ref=refs[2], **graphs)
    M = rng.normal(0, 1, (c, s)).astype(np.float32)
    return M, data


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("zero_gene", [False, True])
@pytest.mark.parametrize("kind", ["dense", "knn"])
def test_spatial_local_indicators_match_jax(kind, zero_gene):
    _, jdata = make_problem(1, kind, zero_gene=zero_gene)
    data = mapper_data_from_jax(jdata)
    lw_j, lw_t = jl.LossWeights(**GRAPH_LAMBDAS), tl.LossWeights(**GRAPH_LAMBDAS)
    for slot in ("voxel_weights", "neighborhood_filter", "spatial_weights"):
        want = jl.spatial_local_indicators(jdata.G, getattr(jdata, slot), lw_j)
        got = tl.spatial_local_indicators(data.G, getattr(data, slot), lw_t)
        for name, a, b in zip(("getis_ord", "moran", "geary"), got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max(), err_msg=f"{slot} {name}")
            if zero_gene:
                assert not bool(a[..., 2].any()), name  # 0, not NaN
    off = tl.spatial_local_indicators(data.G, data.spatial_weights, tl.LossWeights())
    assert off == (None, None, None)


def jax_epilogue_vjp(M, jdata, lam):
    lw = jl.LossWeights(lambda_g1=1.0, lambda_d=1.0, **lam)
    A, w = jl.unconstrained_inputs(jnp.asarray(M), jdata, lw)
    Y, q, h = _mapper_core_xla(jnp.asarray(M), A, w)
    (total, terms), vjp = jax.vjp(
        lambda Y, q, h: jl.unconstrained_epilogue(Y, q, h, None, None, jdata, lw),
        Y, q, h)
    cts = vjp((jnp.float32(1.0), {k: jnp.zeros_like(v) for k, v in terms.items()}))
    return (Y, q, h), terms, cts


def torch_epilogue_grad(Y, q, h, data, lam):
    lw = tl.LossWeights(lambda_g1=1.0, lambda_d=1.0, **lam)
    Yt, qt, ht = (torch.from_numpy(np.array(x)).requires_grad_() for x in (Y, q, h))
    total, terms = tl.unconstrained_epilogue(Yt, qt, ht, None, None, data, lw)
    cts = torch.autograd.grad(total, (Yt, qt, ht), allow_unused=True)
    return terms, cts


@pytest.mark.parametrize("kind", ["dense", "knn"])
@pytest.mark.parametrize("term", list(TERMS))
def test_epilogue_graph_terms_and_cotangents_match_jax_vjp(term, kind):
    lam = TERMS[term]
    M, jdata = make_problem(2, kind, masked=True)
    (Y, q, h), terms_j, cts_j = jax_epilogue_vjp(M, jdata, lam)
    if "lambda_ct_islands" in lam:
        assert Y.shape[1] == 9 + 4  # the one-hot cell types ride along in A
        assert float(terms_j["ct_island_penalty"]) > 0
        assert np.asarray(cts_j[0])[:, 9:].any()
    terms_t, cts_t = torch_epilogue_grad(Y, q, h, mapper_data_from_jax(jdata), lam)
    assert set(terms_t) == set(terms_j) == set(REPORTED)
    for key in REPORTED:
        a, b = terms_t[key].detach().numpy(), np.asarray(terms_j[key])
        assert np.isnan(a) == np.isnan(b), key
        if not np.isnan(b):
            close(a, b)
    for name, got, want in zip(("dY", "dq", "dh"), cts_t, cts_j):
        want = np.asarray(want)
        if got is None:  # unused: JAX's cotangent is zero
            assert not want.any(), name
        else:
            close(got.numpy(), want)


def test_all_graph_terms_are_on_for_positive_lambdas_only():
    """A negative lambda turns a graph term off (``> 0`` gates, as in JAX):
    the same total as without it, and NaN reported."""
    M, jdata = make_problem(3, "knn")
    data = mapper_data_from_jax(jdata)
    (Y, q, h), _, _ = jax_epilogue_vjp(M, jdata, {})
    off, _ = torch_epilogue_grad(Y, q, h, data, {})
    neg = {k: -v for k, v in GRAPH_LAMBDAS.items()}
    lw = tl.LossWeights(lambda_g1=1.0, lambda_d=1.0, **neg)
    A, _ = tl.unconstrained_inputs(torch.from_numpy(M), data, lw)
    assert A.shape[1] == 9  # no cell-type columns
    got, _ = torch_epilogue_grad(Y, q, h, data, neg)
    assert float(got["total_loss"].detach()) == float(off["total_loss"].detach())
    for key in tm.GRAPH_TERM_KEYS:
        assert np.isnan(float(got[key]))
