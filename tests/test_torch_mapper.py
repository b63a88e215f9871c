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

Adafactor (``optimizer="adafactor"``) is held to the loss tolerances of
``tests/test_adafactor.py:177-191``: losses rtol/atol 5e-3 over 25 epochs,
because its update is linear in the gradient and passes f32 rounding
differences straight on where Adam's g/√v damps them. Its logits are held
the way ROADMAP queue C holds Adafactor elsewhere, because a free-running
25-step trajectory at lr 0.1 without update clipping amplifies rounding
until it depends on the order of every sum, and so on torch's intra-op
thread count (at c = 72, s = 40 the reference loop moves 8.6e-3 to 1.4e-2
in 2-norm from itself between 1 and 2-8 threads): step 1 at the one-step
tolerance (rtol = atol = 1e-5, as the one-step tests below); later steps
by forced steps, one step of each loop from the same state, at the same
tolerance; and the free-running logits in 2-norm
within ``SPREAD`` times a witness measured in the test, the larger of the
port's two loops' distance from itself on the same problem with its cells
in another order. The written-out reference update is held against optax
``make_adafactor`` on one gradient at atol 5e-5
(``tests/test_adafactor.py:195-205``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tangram_tpu.models import mapper as jm
from tangram_tpu.ops import fused_step as jfs
from tangram_tpu.ops import pallas_core as jpc
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu_torch.convert import (
    adafactor_state_from_jax,
    constrained_adafactor_state_from_jax,
    constrained_state_from_jax,
    mapper_data_from_jax,
    state_from_jax,
)
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import fused_step as tfs
from tangram_tpu_torch.ops.losses import LossWeights

LAMBDAS = [
    dict(lambda_g1=1.0),
    dict(lambda_g1=1.0, lambda_d=1.0),
    dict(lambda_g1=1.0, lambda_g2=0.7, lambda_d=0.5, lambda_r=0.05),
]
EPOCHS = 25
L1L2 = dict(lambda_g1=1.0, lambda_d=1.0, lambda_l1=1e-3, lambda_l2=2e-3)


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


def test_fused_adam_with_l1_l2_matches_jax_pallas(rng):
    """Adam + L1/L2: 5-tuple stats, the norm terms in the epilogue and the
    norm gradient in the update kernel, with the Adam tolerances."""
    M0, jdata = make_problem(rng)
    p_j, h_j = jm.fit_mapping(jnp.asarray(M0), jdata, JLossWeights(**L1L2), EPOCHS,
                              0.1, impl="pallas", fused=True)
    M_t, h_t = tm.fit_mapping(torch.from_numpy(M0.copy()), mapper_data_from_jax(jdata),
                              LossWeights(**L1L2), EPOCHS, 0.1, impl="fused")
    h_t = {k: v.numpy() for k, v in h_t.items()}
    assert_trajectories_close(M_t, h_t, p_j, h_j)
    for key in ("l1_reg", "l2_reg"):
        np.testing.assert_allclose(h_t[key], np.asarray(h_j[key]), rtol=3e-4)


#: free-running Adafactor logits are held in 2-norm within this many times
#: ``adafactor_witness`` (the bound GRAPH_SPREAD of chip_smoke.py puts on
#: the graph stacks, whose terms amplify rounding alike)
SPREAD = 4.0


def _state_copy(state):
    return None if state is None else tuple(
        x.clone() if isinstance(x, torch.Tensor) else x for x in state)


def adafactor_witness(p0, data, lw, epochs, opt_state=None, **kw):
    """How far a free-running Adafactor trajectory moves from itself when
    only the order of its sums changes: the larger over the port's fused
    (``impl="fused"``) and reference loops of |M − M'|₂ after ``epochs``
    steps, M' trained from the same start on the same problem with its
    cells in another (seeded) order and put back in order. ``p0`` is M or
    (M, F) as numpy arrays, ``opt_state`` the port's Adafactor carry (count,
    vr (cells,), vc (spots,)[, F's v (cells,)]) or None; ``kw`` goes to
    ``fit_mapping``."""
    constrained = isinstance(p0, tuple)
    c = (p0[0] if constrained else p0).shape[0]
    perm = np.random.default_rng(1).permutation(c)
    cells = torch.from_numpy(perm)
    data_p = data._replace(
        S=data.S[cells],
        d_source=None if data.d_source is None else data.d_source[cells])
    p_perm = tuple(x[perm] for x in p0) if constrained else p0[perm]
    state_p = None
    if opt_state is not None:
        # the statistics over cells follow their cells
        state_p = tuple(x[cells] if i in (1, 3) else x for i, x in enumerate(opt_state))
    worst = 0.0
    for impl in ("fused", "reference"):
        out = []
        for p, d, st in ((p0, data, opt_state), (p_perm, data_p, state_p)):
            params = tm.fit_mapping(torch_tree(p), d, lw, epochs, 0.1, impl=impl,
                                    opt_state=_state_copy(st), optimizer="adafactor",
                                    **kw)[0]
            out.append((params[0] if constrained else params).numpy())
        back = np.empty_like(out[1])
        back[perm] = out[1]
        worst = max(worst, float(np.linalg.norm(back - out[0])))
    return worst


def assert_adafactor_close(M_a, h_a, M_b, h_b, witness):
    """The losses at rtol/atol 5e-3; the logits in 2-norm within ``SPREAD``
    times ``witness`` (:func:`adafactor_witness` of the same run)."""
    for key in ("main_loss", "total_loss"):
        np.testing.assert_allclose(np.asarray(h_a[key]), np.asarray(h_b[key]),
                                   rtol=5e-3, atol=5e-3)
    dist = float(np.linalg.norm(np.asarray(M_a, np.float64) - np.asarray(M_b, np.float64)))
    assert 0 < witness and dist <= SPREAD * witness, (dist, witness)


def adafactor_steps(M, state, data, lw, steps, impl):
    """``steps`` single steps of the port's Adafactor loop ``impl``, each
    call carrying the state: the trajectory as (M, state) after each step
    (on the CPU a one-step call recomputes the row stats exactly as the
    loop carries them, so this is the free-running loop)."""
    out = []
    for _ in range(steps):
        M, state, _ = tm.fit_mapping(M.clone(), data, lw, 1, 0.1, impl=impl,
                                     opt_state=_state_copy(state),
                                     return_opt_state=True, optimizer="adafactor")
        out.append((M, state))
    return out


@pytest.mark.parametrize("shape", [(40, 72), (72, 40)])
@pytest.mark.parametrize("lam", [dict(lambda_g1=1.0, lambda_d=1.0), L1L2])
def test_fused_adafactor_matches_jax_pallas(rng, lam, shape):
    """Both orientations of the factored statistics (s ≥ c and c > s): step
    1 of the port's fused and reference loops and of JAX's at rtol = atol =
    1e-5; at every step of the fused loop's trajectory one reference step
    from its state, and from JAX's state after the 25 epochs one step of
    each package, at the same; the free-running logits within ``SPREAD``
    times the witness."""
    c, s = shape
    M0, jdata = make_problem(rng, c=c, s=s)
    jlw = JLossWeights(**lam)
    p_j, st_j, h_j = jm.fit_mapping(jnp.asarray(M0), jdata, jlw, EPOCHS, 0.1,
                                    impl="pallas", fused=True, optimizer="adafactor",
                                    return_opt_state=True)
    data, lw = mapper_data_from_jax(jdata), LossWeights(**lam)
    M_t, h_t = tm.fit_mapping(torch.from_numpy(M0.copy()), data, lw, EPOCHS, 0.1,
                              impl="fused", optimizer="adafactor")
    h_t = {k: v.numpy() for k, v in h_t.items()}
    M_r, h_r = tm.fit_mapping(torch.from_numpy(M0.copy()), data, lw, EPOCHS, 0.1,
                              impl="reference", optimizer="adafactor")

    # step 1
    M1_j = jm.fit_mapping(jnp.asarray(M0), jdata, jlw, 1, 0.1, impl="pallas",
                          fused=True, optimizer="adafactor")[0]
    fused = adafactor_steps(torch.from_numpy(M0), None, data, lw, EPOCHS, "fused")
    M1_r = adafactor_steps(torch.from_numpy(M0), None, data, lw, 1, "reference")[0][0]
    np.testing.assert_allclose(fused[0][0].numpy(), np.asarray(M1_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(M1_r.numpy(), fused[0][0].numpy(), rtol=1e-5, atol=1e-5)
    # forced steps: from each state of the fused trajectory, one step of the
    # reference loop against the fused loop's own next step
    assert torch.equal(fused[-1][0], M_t)
    for (M_prev, state), (M_next, _) in zip(fused, fused[1:]):
        forced = adafactor_steps(M_prev, state, data, lw, 1, "reference")[0][0]
        np.testing.assert_allclose(forced.numpy(), M_next.numpy(), rtol=1e-5, atol=1e-5)
    # ... and from JAX's state after the 25 epochs, one step of each package
    fs_ = st_j[0]
    state = adafactor_state_from_jax(fs_.count, fs_.v_row, fs_.v_col, c, s)
    M26_j = jm.fit_mapping(p_j, jdata, jlw, 1, 0.1, impl="pallas", fused=True,
                           optimizer="adafactor", opt_state=st_j)[0]
    M26_t = adafactor_steps(torch.from_numpy(np.asarray(p_j)), state, data, lw, 1,
                            "fused")[0][0]
    np.testing.assert_allclose(M26_t.numpy(), np.asarray(M26_j), rtol=1e-5, atol=1e-5)

    # the free-running 25 epochs
    witness = adafactor_witness(M0, data, lw, EPOCHS)
    assert_adafactor_close(M_t, h_t, p_j, h_j, witness)
    assert_adafactor_close(M_r, h_r, M_t, h_t, witness)


@pytest.mark.parametrize("c,s", [(13, 21), (21, 13)])
def test_adafactor_update_matches_optax(c, s):
    """The reference loop's written-out update against optax
    ``make_adafactor`` on the same gradients, two steps (the second decays
    carried statistics)."""
    import optax

    rng = np.random.default_rng(c)
    M0 = rng.normal(0, 1, (c, s)).astype(np.float32)
    opt = jm.make_adafactor(0.1)
    state = opt.init(jnp.asarray(M0))
    M_j, M_t = jnp.asarray(M0), torch.from_numpy(M0.copy())
    opt_t = tm.make_adafactor(0.1)
    state_t = opt_t.init(M_t)
    for count in range(2):
        g = rng.normal(0, 1e-2, (c, s)).astype(np.float32)
        updates, state = opt.update(jnp.asarray(g), state, M_j)
        M_j = optax.apply_updates(M_j, updates)
        state_t = opt_t.update(torch.from_numpy(g), state_t, M_t)
        np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=5e-5)
    _, vr, vc = state_t
    _, vr_j, vc_j = adafactor_state_from_jax(state[0].count, state[0].v_row,
                                             state[0].v_col, c, s)
    np.testing.assert_allclose(vr.numpy(), vr_j.numpy(), rtol=1e-5)
    np.testing.assert_allclose(vc.numpy(), vc_j.numpy(), rtol=1e-5)


@pytest.mark.parametrize("shape", [(40, 72), (72, 40)])
def test_one_adafactor_step_matches_jax_from_converted_state(rng, shape):
    """Three JAX Adafactor steps with L1/L2, then one more step in each
    package from the optax ``FactoredState`` carried across by
    ``adafactor_state_from_jax`` (and the 5-tuple stats by
    ``state_from_jax``)."""
    c, s = shape
    M0, jdata = make_problem(rng, c=c, s=s)
    jlw = JLossWeights(**L1L2)
    M3, st, _ = jm.fit_mapping(jnp.asarray(M0), jdata, jlw, 3, 0.1, impl="pallas",
                               fused=True, optimizer="adafactor",
                               return_opt_state=True)
    fstate = st[0]
    count, vr, vc = adafactor_state_from_jax(fstate.count, fstate.v_row,
                                             fstate.v_col, c, s)
    assert count == 3 and tuple(vr.shape) == (c,) and tuple(vc.shape) == (s,)
    stats_j = jfs.initial_stats(M3, jlw)
    M, _, _, _, stats = state_from_jax(M3, count, M3, M3, stats_j)
    assert len(stats) == 5
    want = jfs.fused_unconstrained_step_adafactor(
        M3, jnp.asarray(count), jnp.asarray(vr.numpy()), jnp.asarray(vc.numpy()),
        stats_j, jdata, jlw, 0.1)
    got = tfs.fused_unconstrained_step_adafactor(
        M, count, vr, vc, stats, mapper_data_from_jax(jdata), LossWeights(**L1L2), 0.1)
    assert got[1] == 4
    for g, w in [(got[0], want[0]), (got[2], want[2]), (got[3], want[3])]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for key in ("total_loss", "main_loss", "kl_reg", "l1_reg", "l2_reg"):
        assert float(got[5][key]) == pytest.approx(float(want[5][key]), rel=1e-5)


def test_chunked_adafactor_training_equals_one_run(rng):
    """Carrying (count, vr, vc) across chunks gives the one-run trajectory,
    bit for bit."""
    M0, jdata = make_problem(rng)
    data, lw = mapper_data_from_jax(jdata), LossWeights(**L1L2)
    kw = dict(impl="fused", optimizer="adafactor")
    M_one, h_one = tm.fit_mapping(torch.from_numpy(M0.copy()), data, lw, 12, **kw)
    M = torch.from_numpy(M0.copy())
    M, state, h_a = tm.fit_mapping(M, data, lw, 5, return_opt_state=True, **kw)
    assert state[0] == 5
    M, h_b = tm.fit_mapping(M, data, lw, 7, opt_state=state, **kw)
    torch.testing.assert_close(M, M_one, rtol=0, atol=0)
    for key in ("total_loss", "l1_reg", "l2_reg"):
        torch.testing.assert_close(torch.cat([h_a[key], h_b[key]]), h_one[key],
                                   rtol=0, atol=0)


def test_mapper_prints_the_l1_l2_terms_like_jax(rng, capsys):
    """The score line of each chunk names the L1/L2 terms as the JAX
    package's does; training_history keeps the JAX keys."""
    S = (rng.poisson(2.0, (30, 6)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (20, 6)) + 0.1).astype(np.float32)
    kw = dict(lambda_l1=1e-3, lambda_l2=1e-3, random_state=5)
    _, hist_j = jm.Mapper(S, G, impl="pallas", optimizer="adafactor", **kw).train(
        20, print_each=10)
    lines_j = capsys.readouterr().out.splitlines()
    _, hist_t = tm.Mapper(S, G, device="cpu", impl="fused", optimizer="adafactor",
                          **kw).train(20, print_each=10)
    lines_t = capsys.readouterr().out.splitlines()
    assert set(hist_t) == set(hist_j)
    assert len(lines_t) == len(lines_j) == 2
    for got, want in zip(lines_t, lines_j):
        assert [f.split(":")[0] for f in got.split(", ")] == \
            ["Gene-voxel score", "L1 reg", "L2 reg"]
        assert [f.split(":")[0] for f in got.split(", ")] == \
            [f.split(":")[0] for f in want.split(", ")]


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


@pytest.mark.parametrize("init_method", ["auto", "expression"])
def test_mapper_warm_start_logits_equal_jax(rng, init_method):
    """``adata_map`` starts M at log(clip(adata_map.X, 1e-12)), over any
    init_method, bit for bit as ``tangram_tpu.Mapper`` does (zeros in the
    map exercise the clip)."""
    S = (rng.poisson(2.0, (12, 5)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (9, 5)) + 0.1).astype(np.float32)
    P0 = rng.dirichlet(np.ones(9), size=12).astype(np.float32)
    P0[rng.random(P0.shape) < 0.2] = 0.0

    class Map:
        X = P0

    want = jm.Mapper(S, G, adata_map=Map(), init_method=init_method, random_state=3)
    got = tm.Mapper(S, G, device="cpu", adata_map=Map(), init_method=init_method,
                    random_state=3)
    np.testing.assert_array_equal(got.M.numpy(), np.asarray(want.M))
    assert got.M.dtype == torch.float32


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_mapper_resumed_from_a_converged_map_starts_at_its_loss(rng, impl):
    """A run warm-started from a converged mapping starts at the converged
    loss and, at learning rate 0, returns that mapping
    (``tests/test_mapper_parity.py::test_warm_start_from_adata_map``)."""
    S = (rng.poisson(2.0, (30, 6)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (20, 6)) + 0.1).astype(np.float32)
    out1, hist1 = tm.Mapper(S, G, device="cpu", random_state=3, impl=impl).train(
        30, learning_rate=0.1, print_each=None)

    class Map:
        X = out1

    out2, hist2 = tm.Mapper(S, G, device="cpu", adata_map=Map(), impl=impl).train(
        1, learning_rate=0.0, print_each=None)
    assert hist2["total_loss"][0] == pytest.approx(hist1["total_loss"][-1], rel=1e-3)
    np.testing.assert_allclose(out2, out1, atol=1e-5)


def test_mapper_rejects_unported_options(rng):
    S = np.ones((4, 3), np.float32)
    G = np.ones((5, 3), np.float32)
    mapper = tm.Mapper(S, G, device="cpu")
    _, hist = mapper.train(4, val_each=2, print_each=None)  # ported: queue A3
    assert all(len(hist[k]) == 2 and np.isfinite(hist[k]).all() for k in tm.VAL_KEYS)
    # ported since (schedules and early stop): what is left is their
    # argument errors, as in the JAX package
    _, hist = mapper.train(2, early_stop_tol=1e-3, print_each=None)
    assert len(hist["main_loss"]) == 2
    with pytest.raises(ValueError, match="early_stop_window must be positive"):
        mapper.train(2, early_stop_tol=1e-3, early_stop_window=0)
    with pytest.raises(ValueError, match="learning_rate vector has shape"):
        mapper.train(2, learning_rate=np.full(3, 0.1))
    with pytest.raises(ValueError, match="learning_rate vector has shape"):
        tm.Mapper(S, G, device="cpu", optimizer="adafactor").train(
            2, learning_rate=np.full(3, 0.1))
    with pytest.raises(ValueError, match="unknown init method"):
        tm.Mapper(S, G, device="cpu", init_method="bogus")
    with pytest.raises(ValueError, match="optimizer"):
        tm.Mapper(S, G, device="cpu", optimizer="sgd")
    # the mesh is ported (tests/test_torch_parallel.py); it must be a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.Mapper(S, G, device="cpu", mesh=object())


def test_default_device_is_cuda():
    S = np.ones((4, 3), np.float32)
    if torch.cuda.is_available():
        assert tm.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.Mapper(S, S, device=None)


# ---------------------------------------------------------------------------
# constrained mode, the unfused loop and validation
# ---------------------------------------------------------------------------

CONSTRAINED = dict(lambda_g1=1.0, lambda_g2=1.0, lambda_d=1.0)  # the class defaults


def constrained_problem(rng, c=40, s=72, g=9):
    """(M0, F0) from the constrained init stream, and JAX data with the
    density prior and a target count."""
    _, jdata = make_problem(rng, c=c, s=s, g=g)
    M0, F0 = jm.init_constrained_logits(c, s, 9, "numpy")
    return np.asarray(M0), np.asarray(F0), jdata._replace(target_count=jnp.float32(25.0))


def test_init_constrained_logits_match_jax_stream():
    """The discarded first draw, then M, then F: identical arrays."""
    for seed in (7, 123):
        want = jm.init_constrained_logits(17, 23, seed, "numpy")
        got = tm.init_constrained_logits(17, 23, seed)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for api in (jm, tm):
        with pytest.raises(ValueError, match="unknown init method"):
            api.init_constrained_logits(3, 4, 1, method="bogus")


def test_one_fused_constrained_step_matches_jax_from_converted_state(rng):
    """Three JAX fused constrained steps (entropy term on), then one more in
    each package from the state carried across by
    ``constrained_state_from_jax``; rtol = atol = 1e-5."""
    M0, F0, jdata = constrained_problem(rng)
    jlw = JLossWeights(**CONSTRAINED, lambda_r=0.05)
    M, F = jnp.asarray(M0), jnp.asarray(F0)
    count = jnp.zeros((), jnp.int32)
    mu, nu = jnp.zeros_like(M), jnp.zeros_like(M)
    muF, nuF = jnp.zeros_like(F), jnp.zeros_like(F)
    stats = tuple(jpc._rowstats(M))
    for _ in range(3):
        (M, F), count, (mu, muF), (nu, nuF), stats, _ = jfs.fused_constrained_step(
            M, F, count, mu, nu, muF, nuF, stats, jdata, jlw, 0.1)
    (Mt, Ft), count_t, (mut, muFt), (nut, nuFt), stats_t = constrained_state_from_jax(
        (M, F), count, (mu, muF), (nu, nuF), stats)
    assert count_t == 3
    want = jfs.fused_constrained_step(M, F, count, mu, nu, muF, nuF, stats, jdata,
                                      jlw, 0.1)
    got = tfs.fused_constrained_step(Mt, Ft, count_t, mut, nut, muFt, nuFt, stats_t,
                                     mapper_data_from_jax(jdata),
                                     LossWeights(**CONSTRAINED, lambda_r=0.05), 0.1)
    assert got[1] == 4 and got[0][0] is Mt and got[0][1] is Ft  # in place
    for g, w in zip(got[0] + got[2] + got[3] + got[4], want[0] + want[2] + want[3]
                    + want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for key in tm.CONSTRAINED_HISTORY_KEYS:
        assert float(got[5][key]) == pytest.approx(float(want[5][key]), rel=1e-5)


FIT_CONFIGS = {
    # constrained, fused Adam step (project, rbar, dm_adam + F's Adam)
    "constrained adam": dict(constrained=True, optimizer="adam"),
    # constrained + Adafactor: autograd through the core (no fused step)
    "constrained adafactor": dict(constrained=True, optimizer="adafactor"),
    # cells mode, Adam, fused=False: autograd through the core
    "unfused adam": dict(fused=False, optimizer="adam"),
}


@pytest.mark.parametrize("config", list(FIT_CONFIGS))
def test_fit_matches_jax_pallas(rng, config):
    """fit_mapping against the JAX package's on its Pallas kernels (their
    interpret mode here): the port's ``impl="fused"`` runs the fused
    constrained step or MapperCore on the kernels' twins. Adam held to the
    Adam tolerances of ``assert_trajectories_close``, Adafactor to those of
    ``assert_adafactor_close``; the filter logits F to the same atol."""
    kw = FIT_CONFIGS[config]
    constrained = kw.get("constrained", False)
    M0, F0, jdata = constrained_problem(rng)
    lam = CONSTRAINED if constrained else dict(lambda_g1=1.0, lambda_g2=0.7,
                                               lambda_d=0.5, lambda_r=0.05)
    p0 = (M0, F0) if constrained else M0
    p_j, h_j = jm.fit_mapping(jax_tree(p0), jdata, JLossWeights(**lam), EPOCHS, 0.1,
                              impl="pallas", **kw)
    p_t, h_t = tm.fit_mapping(torch_tree(p0), mapper_data_from_jax(jdata),
                              LossWeights(**lam), EPOCHS, 0.1, impl="fused", **kw)
    h_t = {k: v.numpy() for k, v in h_t.items()}
    assert set(h_t) >= {"total_loss", "main_loss"}
    if constrained:
        assert set(h_t) == set(tm.CONSTRAINED_HISTORY_KEYS)
        (p_t, F_t), (p_j, F_j) = p_t, p_j
        np.testing.assert_allclose(F_t.numpy(), np.asarray(F_j),
                                   atol=5e-3 if "adafactor" in config else 3e-3)
        np.testing.assert_allclose(h_t["count_reg"], np.asarray(h_j["count_reg"]),
                                   rtol=3e-4)
    if "adafactor" in config:
        witness = adafactor_witness(p0, mapper_data_from_jax(jdata), LossWeights(**lam),
                                    EPOCHS, constrained=constrained)
        assert_adafactor_close(p_t, h_t, p_j, h_j, witness)
    else:
        assert_trajectories_close(p_t, h_t, p_j, h_j)


def jax_tree(p):
    return tuple(map(jnp.asarray, p)) if isinstance(p, tuple) else jnp.asarray(p)


def torch_tree(p):
    return (tuple(torch.from_numpy(x.copy()) for x in p) if isinstance(p, tuple)
            else torch.from_numpy(p.copy()))


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_constrained_loop_matches_reference_loop(rng, optimizer):
    """The port's constrained loops on the twins against its materialized
    reference loop, at the tolerances of its package's optimizer tests."""
    M0, F0, jdata = constrained_problem(rng)
    data, lw = mapper_data_from_jax(jdata), LossWeights(**CONSTRAINED)
    runs = [tm.fit_mapping(torch_tree((M0, F0)), data, lw, EPOCHS, impl=impl,
                           optimizer=optimizer, constrained=True)
            for impl in ("fused", "reference")]
    (M_f, F_f), h_f = runs[0]
    (M_r, F_r), h_r = runs[1]
    if optimizer == "adafactor":
        witness = adafactor_witness((M0, F0), data, lw, EPOCHS, constrained=True)
        assert_adafactor_close(M_f, h_f, M_r, h_r, witness)
    else:
        assert_trajectories_close(M_f, h_f, M_r, h_r)
    np.testing.assert_allclose(F_f.numpy(), F_r.numpy(), atol=5e-3)


def test_constrained_adafactor_state_carries_across_from_jax(rng):
    """Five JAX steps of constrained Adafactor, the optax state carried
    across by ``constrained_adafactor_state_from_jax``, then three more in
    each package; Adafactor tolerances."""
    M0, F0, jdata = constrained_problem(rng)
    jlw = JLossWeights(**CONSTRAINED)
    kw = dict(impl="pallas", constrained=True, optimizer="adafactor")
    p5, st, _ = jm.fit_mapping(jax_tree((M0, F0)), jdata, jlw, 5, 0.1,
                               return_opt_state=True, **kw)
    fs_ = st[0]
    c, s = M0.shape
    state = constrained_adafactor_state_from_jax(fs_.count, fs_.v_row, fs_.v_col,
                                                 fs_.v, c, s)
    assert state[0] == 5 and tuple(state[3].shape) == (c,)
    witness = adafactor_witness(tuple(np.asarray(x) for x in p5),
                                mapper_data_from_jax(jdata), LossWeights(**CONSTRAINED),
                                3, opt_state=state, constrained=True)
    p_j, h_j = jm.fit_mapping(p5, jdata, jlw, 3, 0.1, opt_state=st, **kw)
    (M_t, F_t), h_t = tm.fit_mapping(torch_tree(tuple(np.asarray(x) for x in p5)),
                                     mapper_data_from_jax(jdata),
                                     LossWeights(**CONSTRAINED), 3, 0.1,
                                     impl="fused", opt_state=state, constrained=True,
                                     optimizer="adafactor")
    assert_adafactor_close(M_t, {k: v.numpy() for k, v in h_t.items()}, p_j[0], h_j,
                           witness)
    np.testing.assert_allclose(F_t.numpy(), np.asarray(p_j[1]), atol=5e-3)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_mapper_constrained_train_matches_jax(rng, optimizer):
    """The class surface: the same seed, history keys, mapping and filter,
    with the score lines of the JAX class; Adam or Adafactor tolerances."""
    S = (rng.poisson(2.0, (30, 6)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (20, 6)) + 0.1).astype(np.float32)
    d = np.full(20, 1 / 20, np.float32)
    kw = dict(target_count=12, random_state=5, optimizer=optimizer)
    out_j, F_j, hist_j = jm.MapperConstrained(S, G, d, impl="pallas", **kw).train(
        40, print_each=None)
    out_t, F_t, hist_t = tm.MapperConstrained(S, G, d, device="cpu", impl="fused",
                                              **kw).train(40, print_each=None)
    assert set(hist_t) == set(hist_j) == set(tm.CONSTRAINED_HISTORY_KEYS)
    tol = 5e-3 if optimizer == "adafactor" else 3e-4
    np.testing.assert_allclose(out_t, out_j, rtol=10 * tol, atol=1e-6)
    np.testing.assert_allclose(F_t, F_j, atol=tol)
    for key in ("total_loss", "count_reg", "lambda_f_reg"):
        np.testing.assert_allclose(hist_t[key], hist_j[key], rtol=tol, atol=tol / 10)


def test_mapper_constrained_rejects_unported_and_warm_starts(rng):
    S = np.ones((4, 3), np.float32)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.MapperConstrained(S, S, None, device="cpu", mesh=object())
    # the expression init (ported since): JAX's logits, and F's numpy draw
    want = jm.MapperConstrained(S, S, None, init_method="expression", random_state=3)
    got = tm.MapperConstrained(S, S, None, device="cpu", init_method="expression",
                               random_state=3)
    np.testing.assert_allclose(got.M.numpy(), np.asarray(want.M), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.F.numpy(), np.asarray(want.F))
    P0 = rng.dirichlet(np.ones(5), size=4).astype(np.float32)

    class Map:
        X = P0

    for cls, kw in ((jm.MapperConstrained, {}), (tm.MapperConstrained,
                                                  dict(device="cpu"))):
        mapper = cls(S, np.ones((5, 3), np.float32), None, adata_map=Map(),
                     random_state=3, **kw)
        np.testing.assert_allclose(np.asarray(mapper.M), np.log(P0), rtol=1e-6)
        F = np.asarray(mapper.F)
        assert F.shape == (4,)
    np.testing.assert_array_equal(F, np.asarray(jm.MapperConstrained(
        S, np.ones((5, 3), np.float32), None, adata_map=Map(), random_state=3).F))


@pytest.mark.parametrize("impl", ["fused", "reference"])
def test_mapper_train_with_val_each_matches_jax(rng, impl):
    """``val_each=3`` on held-out genes (the reference quirk off), in chunks
    of 10 epochs: the validation lists, every third epoch of the absolute
    count, match the JAX class's; Adam tolerances."""
    S = (rng.poisson(2.0, (30, 8)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (20, 8)) + 0.1).astype(np.float32)
    kw = dict(train_genes_idx=[0, 1, 2, 3, 4], val_genes_idx=[5, 6, 7],
              emulate_reference_val_quirk=False, lambda_g2=0.5, random_state=5)
    _, hist_j = jm.Mapper(S, G, impl="pallas", **kw).train(25, print_each=10,
                                                           val_each=3)
    _, hist_t = tm.Mapper(S, G, device="cpu", impl=impl, **kw).train(
        25, print_each=10, val_each=3)
    assert set(hist_t) == set(hist_j)
    for key in tm.VAL_KEYS:
        assert len(hist_t[key]) == len(hist_j[key]) == 9
        np.testing.assert_allclose(hist_t[key], hist_j[key], rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(hist_t["total_loss"], hist_j["total_loss"],
                               rtol=3e-4, atol=3e-5)
