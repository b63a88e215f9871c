"""The PyTorch port's loss epilogue against the JAX package's.

The fused step differentiates ``unconstrained_epilogue`` alone and hands
its cotangents (dY, dq, dh) to the streamed backward kernels, so the terms
and all three cotangents are held against ``jax.vjp`` of the JAX epilogue
on the same seeded inputs, for the λ sets of ``tests/test_fused_step.py``
that the port computes, plus L1/L2 sets (the epilogue takes Σ|M| and ΣM²
as values). The materialized ``compute_loss`` is held against the JAX XLA
path as well, its gradient including the L1/L2 terms.

Tolerance: rtol = 1e-5, atol = 1e-7 (the cotangents are O(1e-3)); both
sides are f32 with reductions in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tangram_tpu.ops import losses as jl
from tangram_tpu.ops.core import _mapper_core_xla
from tangram_tpu_torch.convert import mapper_data_from_jax
from tangram_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-7
LAMBDAS = [
    dict(lambda_g1=1.0),
    dict(lambda_g1=1.0, lambda_d=1.0),
    dict(lambda_g1=1.0, lambda_g2=0.7, lambda_d=0.5, lambda_r=0.05),
    dict(lambda_g1=1.0, lambda_d=1.0, lambda_l1=0.01),
    dict(lambda_g1=1.0, lambda_g2=0.7, lambda_r=0.05, lambda_l1=0.01,
         lambda_l2=0.02),
]
TERM_KEYS = ["main_loss", "vg_reg", "kl_reg", "entropy_reg", "l1_reg", "l2_reg",
             "total_loss"]


def make_problem(seed, c=40, s=72, g=9, with_d=True, masked=False):
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = None
    if with_d:
        d = rng.random(s).astype(np.float32)
        d /= d.sum()
    mask = None
    if masked:
        mask = np.ones(g, np.float32)
        mask[[1, 4]] = 0.0
    data = jl.MapperData(
        S=jnp.asarray(S), G=jnp.asarray(G),
        d=None if d is None else jnp.asarray(d),
        gene_mask=None if mask is None else jnp.asarray(mask),
    )
    M = rng.normal(0, 1, (c, s)).astype(np.float32)
    return M, data


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lam", LAMBDAS)
def test_epilogue_terms_and_cotangents_match_jax_vjp(lam, masked):
    M, jdata = make_problem(1, with_d="lambda_d" in lam, masked=masked)
    jlw = jl.LossWeights(**lam)
    A, w = jl.unconstrained_inputs(jnp.asarray(M), jdata, jlw)
    Y, q, h = _mapper_core_xla(jnp.asarray(M), A, w)

    l1 = np.float32(np.abs(M).sum()) if jlw.lambda_l1 else None
    l2 = np.float32((M * M).sum()) if jlw.lambda_l2 else None
    total_j, vjp, terms_j = jax.vjp(
        lambda Y, q, h: jl.unconstrained_epilogue(Y, q, h, l1, l2, jdata, jlw),
        Y, q, h, has_aux=True,
    )
    dY_j, dq_j, dh_j = vjp(jnp.ones_like(total_j))

    data = mapper_data_from_jax(jdata)
    Yt, qt, ht = (torch.from_numpy(np.array(x)).requires_grad_() for x in (Y, q, h))
    l1t, l2t = (None if v is None else torch.tensor(v) for v in (l1, l2))
    total, terms = tl.unconstrained_epilogue(Yt, qt, ht, l1t, l2t, data,
                                             tl.LossWeights(**lam))
    dY, dq, dh = torch.autograd.grad(total, (Yt, qt, ht), allow_unused=True)

    close(total.detach(), total_j)
    for key in TERM_KEYS:
        got, want = float(terms[key].detach()), float(terms_j[key])
        if np.isnan(want):
            assert np.isnan(got), key
        else:
            close(got, want)
    close(dY, dY_j)
    if dq is None:  # q is unused without a density prior
        assert not np.any(np.asarray(dq_j))
    else:
        close(dq, dq_j)
    close(dh, dh_j)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_compute_loss_matches_jax_xla(lam):
    M, jdata = make_problem(2, with_d="lambda_d" in lam)
    jlw = jl.LossWeights(**lam)
    (total_j, terms_j), g_j = jax.value_and_grad(
        lambda M: jl.compute_loss(M, jdata, jlw, impl="xla"), has_aux=True
    )(jnp.asarray(M))
    Mt = torch.from_numpy(M.copy()).requires_grad_()
    total, terms = tl.compute_loss(Mt, mapper_data_from_jax(jdata), tl.LossWeights(**lam))
    (g,) = torch.autograd.grad(total, (Mt,))
    close(total.detach(), total_j)
    for key in TERM_KEYS:
        want = float(terms_j[key])
        got = float(terms[key].detach())
        assert np.isnan(got) if np.isnan(want) else got == pytest.approx(want, rel=RTOL)
    close(g, g_j)


def test_cosine_similarity_gradient_is_finite_on_zero_columns():
    """The eps clamp inside the sqrt keeps the gradient finite (not NaN) on
    an all-zero column, where ``d‖x‖/dx = x/‖x‖`` would be 0/0."""
    x_np = np.zeros((5, 3), np.float32)
    x_np[:, 0] = np.arange(1.0, 6.0)
    x = torch.from_numpy(x_np.copy()).requires_grad_()
    sim = tl.cosine_similarity(x, torch.ones((5, 3)), axis=0)
    (g,) = torch.autograd.grad(sim.sum(), (x,))
    assert torch.isfinite(g).all()
    want, g_j = jax.value_and_grad(
        lambda x: jnp.sum(jl.cosine_similarity(x, jnp.ones((5, 3)), axis=0))
    )(jnp.asarray(x_np))
    close(sim.detach().sum(), want)
    close(g, g_j)


def test_kl_div_sum_zero_targets_contribute_nothing():
    target = torch.tensor([0.0, 0.25, 0.75])
    log_pred = torch.log(torch.tensor([0.0, 0.5, 0.5]))  # -inf where target is 0
    got = tl.kl_div_sum(log_pred, target)
    want = jl.kl_div_sum(jnp.asarray(log_pred.numpy()), jnp.asarray(target.numpy()))
    assert torch.isfinite(got)
    close(got, want)


def test_l1_gradient_of_a_zero_logit_is_zero():
    """sign(0) = 0 in the L1 gradient, as ``jnp.sign`` gives in the JAX
    fused kernels: the port's autograd of |M| (torch's, like the torch
    reference) and its fused path's explicit sign agree. JAX's autodiff of
    ``jnp.abs`` gives +1 at 0, so its XLA path differs there by exactly λ₁
    and agrees everywhere else."""
    M_np = np.array([[0.0, 1.5, -2.0], [0.5, 0.0, -0.25]], np.float32)
    jdata = jl.MapperData(S=jnp.ones((2, 2)), G=jnp.asarray([[1.0, 2.0], [2.0, 1.0],
                                                             [1.0, 1.0]]))
    lam = dict(lambda_l1=0.5, lambda_l2=0.25)
    g_j = jax.grad(lambda M: jl.compute_loss(M, jdata, jl.LossWeights(**lam),
                                             impl="xla")[0])(jnp.asarray(M_np))
    Mt = torch.from_numpy(M_np.copy()).requires_grad_()
    total, _ = tl.compute_loss(Mt, mapper_data_from_jax(jdata), tl.LossWeights(**lam))
    (g,) = torch.autograd.grad(total, (Mt,))
    at_zero = M_np == 0
    close(g[~at_zero], np.asarray(g_j)[~at_zero])
    close(g[at_zero], np.asarray(g_j)[at_zero] - 0.5)
    from tangram_tpu_torch.ops.fused_step import _grad_plain

    zero = torch.zeros_like(Mt)
    norm_part = _grad_plain(Mt.detach(), zero, zero, zero[:, :1], 0.5, 0.25)
    np.testing.assert_array_equal(norm_part.numpy(),
                                  0.5 * np.sign(M_np) + 0.5 * M_np)


CONSTRAINED_LAMBDAS = [
    # MapperConstrained's defaults, with the density prior
    dict(lambda_g1=1.0, lambda_g2=1.0, lambda_d=1.0),
    # no prior (q unused), the entropy term on, other count/filter weights
    dict(lambda_g1=1.0, lambda_r=0.05, lambda_count=0.5, lambda_f_reg=2.0),
]
CONSTRAINED_KEYS = ["main_loss", "vg_reg", "kl_reg", "entropy_reg", "count_reg",
                    "lambda_f_reg", "total_loss"]


def constrained_problem(seed, lam, masked=False):
    """M, the filter logits F and the JAX data with a target count."""
    M, jdata = make_problem(seed, with_d="lambda_d" in lam, masked=masked)
    F = np.random.default_rng(seed + 100).normal(0, 1, M.shape[0]).astype(np.float32)
    return M, F, jdata._replace(target_count=jnp.float32(15.0))


def assert_terms_close(terms, terms_j, keys):
    for key in keys:
        got, want = float(terms[key].detach()), float(terms_j[key])
        if np.isnan(want):
            assert np.isnan(got), key
        else:
            close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lam", CONSTRAINED_LAMBDAS)
def test_constrained_epilogue_terms_and_cotangents_match_jax_vjp(lam, masked):
    """Values, the reported terms (the entropy's sign quirk and the count
    and filter terms included) and the cotangents of (Y, q, Σh, F), with the
    density term on the filtered marginal log(q / Σσ(F)); rtol 1e-5."""
    M, F, jdata = constrained_problem(3, lam, masked)
    jlw = jl.LossWeights(**lam)
    w = jax.nn.sigmoid(jnp.asarray(F))
    S = jdata.S if jdata.gene_mask is None else jdata.S * jdata.gene_mask[None, :]
    Y, q, h = _mapper_core_xla(jnp.asarray(M), S * w[:, None], w)
    total_j, vjp, terms_j = jax.vjp(
        lambda Y, q, hs, F: jl.constrained_epilogue(Y, q, hs, F, jdata, jlw),
        Y, q, jnp.sum(h), jnp.asarray(F), has_aux=True,
    )
    cts_j = vjp(jnp.ones_like(total_j))

    leaves = [torch.from_numpy(np.array(x)).requires_grad_()
              for x in (Y, q, jnp.sum(h), F)]
    total, terms = tl.constrained_epilogue(*leaves, mapper_data_from_jax(jdata),
                                           tl.LossWeights(**lam))
    cts = torch.autograd.grad(total, leaves, allow_unused=True)
    close(total.detach(), total_j)
    assert_terms_close(terms, terms_j, CONSTRAINED_KEYS)
    for got, want in zip(cts, cts_j):
        if got is None:  # q is unused without a density prior
            assert not np.any(np.asarray(want))
        else:
            close(got, want)


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("lam", CONSTRAINED_LAMBDAS)
def test_compute_constrained_loss_matches_jax_xla(lam, impl):
    """Loss, terms and the gradients in M and F, through the materialized
    core or MapperCore (the kernels' twins on the CPU); rtol 1e-5."""
    M, F, jdata = constrained_problem(4, lam)
    jlw = jl.LossWeights(**lam)
    (total_j, terms_j), grads_j = jax.value_and_grad(
        lambda p: jl.compute_constrained_loss(p, jdata, jlw, impl="xla"), has_aux=True
    )((jnp.asarray(M), jnp.asarray(F)))
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (M, F)]
    total, terms = tl.compute_constrained_loss(
        leaves, mapper_data_from_jax(jdata), tl.LossWeights(**lam), impl=impl)
    grads = torch.autograd.grad(total, leaves)
    close(total.detach(), total_j)
    assert_terms_close(terms, terms_j, CONSTRAINED_KEYS)
    for got, want in zip(grads, grads_j):
        close(got, want)


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("masked", [False, True])
def test_val_metrics_match_jax_xla(masked, impl):
    """The four validation metrics, rtol 1e-5."""
    M, jdata = make_problem(6, masked=masked)
    want = jl.val_metrics(jnp.asarray(M), jdata.S, jdata.G, jdata.gene_mask,
                          impl="xla")
    data = mapper_data_from_jax(jdata)
    got = tl.val_metrics(torch.from_numpy(M), data.S, data.G, data.gene_mask,
                         impl=impl)
    assert list(got) == list(tl.VAL_METRIC_KEYS) == list(want)
    for key in got:
        close(got[key], want[key])


@pytest.mark.parametrize("fn", ["compute_loss", "compute_constrained_loss",
                                "val_metrics", "mapper_core"])
def test_loss_functions_default_to_auto_like_jax(fn):
    """The loss-level functions default to ``impl="auto"``, as the JAX
    package's do: on CPU tensors that is the materialized core, bit for
    bit, and it equals the JAX package's default call (XLA on the CPU) to
    rtol 1e-5. A bad impl raises."""
    import inspect

    from tangram_tpu.ops import core as jcore
    from tangram_tpu_torch.ops import core as tcore

    lam = dict(lambda_g1=1.0, lambda_d=1.0, lambda_g2=0.5)
    M, F, jdata = constrained_problem(7, lam)
    data = mapper_data_from_jax(jdata)
    Mt, Ft = torch.from_numpy(M), torch.from_numpy(F)
    w = torch.full((M.shape[0],), 0.5)
    calls = {
        "compute_loss": (lambda impl: tl.compute_loss(Mt, data, tl.LossWeights(**lam),
                                                      **impl),
                         lambda: jl.compute_loss(jnp.asarray(M), jdata,
                                                 jl.LossWeights(**lam))),
        "compute_constrained_loss": (
            lambda impl: tl.compute_constrained_loss((Mt, Ft), data,
                                                     tl.LossWeights(**lam), **impl),
            lambda: jl.compute_constrained_loss((jnp.asarray(M), jnp.asarray(F)), jdata,
                                                jl.LossWeights(**lam))),
        "val_metrics": (lambda impl: tl.val_metrics(Mt, data.S, data.G, **impl),
                        lambda: jl.val_metrics(jnp.asarray(M), jdata.S, jdata.G)),
        "mapper_core": (lambda impl: tcore.mapper_core(Mt, data.S, w, **impl),
                        lambda: jcore.mapper_core(jnp.asarray(M), jdata.S,
                                                  jnp.asarray(w.numpy()))),
    }
    port, jax_default = calls[fn]
    fn_obj = tcore.mapper_core if fn == "mapper_core" else getattr(tl, fn)
    assert inspect.signature(fn_obj).parameters["impl"].default == "auto"

    def flat(out):
        if isinstance(out, tuple) and isinstance(out[-1], dict):  # (total, terms)
            out = (out[0], *out[1].values())
        elif isinstance(out, dict):
            out = tuple(out.values())
        return [np.asarray(o, dtype=np.float64) for o in out]

    got = flat(port({}))
    for a, b in zip(got, flat(port(dict(impl="reference")))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, flat(jax_default())):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="impl must be one of"):
        port(dict(impl="pallas"))
