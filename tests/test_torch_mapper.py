"""The PyTorch port's training engine against the JAX package's.

``fit_mapping`` of the port (its fused loop, which runs the kernels' plain
twins on the CPU) is held against JAX ``fit_mapping(..., impl="pallas",
fused=True)`` over 25 epochs from the same logits, with the tolerances of
``tests/test_fused_step.py:45-54``: loss rtol 3e-4 / atol 3e-5 (Adam's
normalized steps amplify f32 rounding over 25 epochs), M atol 3e-3, and
the first recorded loss (no accumulation yet) to rel 1e-5. The port's
fused loop is held against its own reference loop with the same
tolerances, and one fused step, fed identical state through
``convert.state_from_jax``, against the JAX step at rtol/atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tangram_tpu.models import mapper as jm
from tangram_tpu.ops import fused_step as jfs
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu_torch.convert import mapper_data_from_jax, state_from_jax
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import fused_step as tfs
from tangram_tpu_torch.ops.losses import LossWeights

LAMBDAS = [
    dict(lambda_g1=1.0),
    dict(lambda_g1=1.0, lambda_d=1.0),
    dict(lambda_g1=1.0, lambda_g2=0.7, lambda_d=0.5, lambda_r=0.05),
]
EPOCHS = 25


def make_problem(rng, c=40, s=72, g=9, with_d=True):
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = None
    if with_d:
        d = rng.random(s).astype(np.float32)
        d /= d.sum()
    data = JMapperData(S=jnp.asarray(S), G=jnp.asarray(G),
                       d=None if d is None else jnp.asarray(d))
    M0 = jm.init_logits(c, s, 3, "numpy")
    return np.asarray(M0), data


def assert_trajectories_close(M_a, h_a, M_b, h_b):
    np.testing.assert_allclose(np.asarray(h_a["total_loss"]),
                               np.asarray(h_b["total_loss"]), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(np.asarray(M_a), np.asarray(M_b), atol=3e-3)
    assert float(h_a["total_loss"][0]) == pytest.approx(
        float(h_b["total_loss"][0]), rel=1e-5)


def test_init_logits_match_jax_stream():
    for seed in (3, 42):
        want = np.asarray(jm.init_logits(17, 23, seed, "numpy"))
        got = tm.init_logits(17, 23, seed)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_fused_fit_matches_jax_pallas(rng, lam):
    M0, jdata = make_problem(rng, with_d="lambda_d" in lam)
    p_j, h_j = jm.fit_mapping(jnp.asarray(M0), jdata, JLossWeights(**lam), EPOCHS,
                              0.1, impl="pallas", fused=True)
    M = torch.from_numpy(M0.copy())
    M_t, h_t = tm.fit_mapping(M, mapper_data_from_jax(jdata), LossWeights(**lam),
                              EPOCHS, 0.1, impl="fused")
    assert M_t is M  # trained in place
    h_t = {k: v.numpy() for k, v in h_t.items()}
    assert_trajectories_close(M_t, h_t, p_j, h_j)
    for key in ("main_loss", "kl_reg"):
        if not np.isnan(np.asarray(h_j[key])).all():
            np.testing.assert_allclose(h_t[key], np.asarray(h_j[key]),
                                       rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_fused_loop_matches_reference_loop(rng, lam):
    M0, jdata = make_problem(rng, with_d="lambda_d" in lam)
    data, lw = mapper_data_from_jax(jdata), LossWeights(**lam)
    M_f, h_f = tm.fit_mapping(torch.from_numpy(M0.copy()), data, lw, EPOCHS,
                              impl="fused")
    M_r, h_r = tm.fit_mapping(torch.from_numpy(M0.copy()), data, lw, EPOCHS,
                              impl="reference")
    assert_trajectories_close(M_f, h_f, M_r, h_r)


def test_one_fused_step_matches_jax_from_converted_state(rng):
    """Three JAX steps, then one more step in each package from the JAX
    state carried across by ``state_from_jax``."""
    lam = dict(lambda_g1=1.0, lambda_g2=0.7, lambda_d=0.5, lambda_r=0.05)
    M0, jdata = make_problem(rng)
    jlw = JLossWeights(**lam)
    M = jnp.asarray(M0)
    count, mu, nu = jfs.init_fused_opt_state(M)
    stats = jfs.initial_stats(M, jlw)
    for _ in range(3):
        M, count, mu, nu, stats, _ = jfs.fused_unconstrained_step(
            M, count, mu, nu, stats, jdata, jlw, 0.1)
    state = state_from_jax(M, count, mu, nu, stats)
    assert state[1] == 3
    want = jfs.fused_unconstrained_step(M, count, mu, nu, stats, jdata, jlw, 0.1)
    got = tfs.fused_unconstrained_step(*state, mapper_data_from_jax(jdata),
                                       LossWeights(**lam), 0.1)
    assert got[1] == 4
    for g, w in [(got[0], want[0]), (got[2], want[2]), (got[3], want[3])]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for key in ("total_loss", "main_loss", "vg_reg", "kl_reg", "entropy_reg"):
        assert float(got[5][key]) == pytest.approx(float(want[5][key]), rel=1e-5)


def test_chunked_training_equals_one_run(rng):
    """Carrying (count, mu, nu) across chunks gives the one-run trajectory."""
    M0, jdata = make_problem(rng)
    data, lw = mapper_data_from_jax(jdata), LossWeights(lambda_d=1.0)
    M_one, h_one = tm.fit_mapping(torch.from_numpy(M0.copy()), data, lw, 12,
                                  impl="fused")
    M = torch.from_numpy(M0.copy())
    M, state, h_a = tm.fit_mapping(M, data, lw, 5, impl="fused",
                                   return_opt_state=True)
    M, h_b = tm.fit_mapping(M, data, lw, 7, impl="fused", opt_state=state)
    torch.testing.assert_close(M, M_one, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([h_a["total_loss"], h_b["total_loss"]]),
                               h_one["total_loss"], rtol=0, atol=0)


def test_mapper_train_matches_jax_mapper(rng):
    """The class surface: same seed, same history keys, same mapping."""
    S = (rng.poisson(2.0, (30, 6)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (20, 6)) + 0.1).astype(np.float32)
    d = np.full(20, 1 / 20, np.float32)
    kw = dict(d=d, lambda_d=1.0, lambda_g2=0.5, random_state=5)
    out_j, hist_j = jm.Mapper(S, G, impl="pallas", **kw).train(40, print_each=None)
    out_t, hist_t = tm.Mapper(S, G, device="cpu", impl="fused", **kw).train(
        40, print_each=None)
    assert set(hist_t) == set(hist_j)
    np.testing.assert_allclose(out_t, out_j, rtol=3e-3, atol=1e-6)
    np.testing.assert_allclose(hist_t["total_loss"], hist_j["total_loss"],
                               rtol=3e-4, atol=3e-5)


def test_mapper_rejects_unported_options(rng):
    S = np.ones((4, 3), np.float32)
    G = np.ones((5, 3), np.float32)
    mapper = tm.Mapper(S, G, device="cpu")
    with pytest.raises(NotImplementedError, match="A3"):
        mapper.train(2, val_each=1)
    with pytest.raises(NotImplementedError, match="A6"):
        mapper.train(2, early_stop_tol=1e-3)
    with pytest.raises(NotImplementedError, match="A6"):
        mapper.train(2, learning_rate=np.full(2, 0.1))
    with pytest.raises(NotImplementedError, match="B5"):
        tm.Mapper(S, G, device="cpu", lambda_l1=0.1)


def test_default_device_is_cuda():
    S = np.ones((4, 3), np.float32)
    if torch.cuda.is_available():
        assert tm.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.Mapper(S, S, device=None)
