"""The port's TPE sampler and Pareto ordering (``tangram_tpu_torch.search``)
against the JAX package's, on the host.

Both are numpy: with the same inputs, ``nondominated_rank`` and
``pareto_order`` must return the same arrays, and a ``TPESampler`` with the
same seed and the same ``tell`` history must ``ask`` the same rows bit for
bit, through its Sobol start-up and its Parzen rounds.
"""

import numpy as np
import pytest

from tangram_tpu import search as jsearch
from tangram_tpu_torch import search as tsearch


def objectives(seed, n, m, ties=False, nan_rows=0):
    rng = np.random.default_rng(seed)
    Y = rng.random((n, m))
    if ties:  # a coarse grid: many equal coordinates and equal rows
        Y = np.round(Y * 3) / 3
    if nan_rows:
        Y[rng.choice(n, nan_rows, replace=False), rng.integers(0, m)] = np.nan
    return Y


@pytest.mark.parametrize("seed,n,m,ties", [
    (0, 40, 2, False), (1, 25, 3, False), (2, 60, 2, True), (3, 30, 4, True),
    (4, 12, 1, False), (5, 20, 1, True),
])
def test_nondominated_rank_matches_jax(seed, n, m, ties):
    Y = objectives(seed, n, m, ties)
    np.testing.assert_array_equal(tsearch.nondominated_rank(Y),
                                  jsearch.nondominated_rank(Y))


@pytest.mark.parametrize("seed,n,m,ties,nan_rows", [
    (0, 40, 2, False, 0), (1, 25, 3, True, 0), (2, 30, 2, False, 4),
    (3, 18, 1, False, 3), (4, 16, 3, True, 5), (5, 4, 2, False, 4),
])
def test_pareto_order_matches_jax(seed, n, m, ties, nan_rows):
    Y = objectives(seed, n, m, ties, nan_rows)
    got = tsearch.pareto_order(Y)
    np.testing.assert_array_equal(got, jsearch.pareto_order(Y))
    assert sorted(got.tolist()) == list(range(n))
    # a diverged row never outranks a finite one
    finite = np.isfinite(Y).all(axis=1)
    assert finite[got[:finite.sum()]].all()


@pytest.mark.parametrize("n_dims,seed,n_objectives", [(1, 0, 1), (3, 7, 2), (5, 11, 3)])
def test_tpe_ask_tell_rounds_match_jax_bit_for_bit(n_dims, seed, n_objectives):
    """Startup (Sobol) rounds, then Parzen rounds: the same rows each
    round, the tells computed from those rows by a seeded objective with
    a NaN observation among them."""
    target = np.linspace(0.2, 0.8, n_dims)
    samplers = [mod.TPESampler(n_dims, seed=seed, n_startup=6) for mod in (jsearch, tsearch)]
    for rnd in range(6):
        asked = [s.ask(4) for s in samplers]
        np.testing.assert_array_equal(asked[1], asked[0])
        X = asked[0]
        dist = ((X - target) ** 2).sum(axis=1)
        Y = np.stack([-dist * (k + 1) + 0.1 * k * X[:, 0] for k in range(n_objectives)], axis=1)
        if rnd == 2:
            Y[1] = np.nan
        for s in samplers:
            s.tell(X, Y if n_objectives > 1 else Y[:, 0])
    assert samplers[1].n_observed == samplers[0].n_observed == 24


def test_tpe_validates_like_jax():
    s = tsearch.TPESampler(2, seed=0)
    with pytest.raises(ValueError, match="matching first"):
        s.tell(np.zeros((3, 2)), np.zeros(2))
    with pytest.raises(ValueError, match="columns"):
        s.tell(np.zeros((3, 5)), np.zeros(3))
    with pytest.raises(ValueError, match="n_dims"):
        tsearch.TPESampler(0)


# ---------------------------------------------------------------------------
# tests/test_adaptive_search.py's sampler behaviour, on the port
# ---------------------------------------------------------------------------


def test_tpe_concentrates_near_good_observations():
    """After a cluster of good points is told, suggestions land near it far
    more often than uniform sampling would (~0.2 within 0.25)."""
    rng = np.random.default_rng(0)
    s = tsearch.TPESampler(2, seed=0, n_startup=4)
    target = np.array([0.8, 0.2])
    X = rng.random((40, 2))
    s.tell(X, -((X - target) ** 2).sum(axis=1))
    dist = np.linalg.norm(s.ask(32) - target, axis=1)
    assert (dist < 0.25).mean() > 0.5


_TARGET = np.array([0.23, 0.71])
_EPS = 0.02


def _trials_to_hit_tpe(seed, batch=4, cap=400):
    s = tsearch.TPESampler(2, seed=seed, n_startup=16)
    n = 0
    while n < cap:
        X = s.ask(batch)
        s.tell(X, -((X - _TARGET) ** 2).sum(axis=1))
        n += batch
        if (np.linalg.norm(X - _TARGET, axis=1) <= _EPS).any():
            return n
    return cap


def _trials_to_hit_sobol(seed, cap=4096):
    from scipy.stats import qmc

    X = qmc.Sobol(d=2, scramble=True, seed=seed).random(cap)
    hits = np.nonzero(np.linalg.norm(X - _TARGET, axis=1) <= _EPS)[0]
    return int(hits[0]) + 1 if len(hits) else cap


def test_adaptive_beats_sobol_by_4x_on_narrow_optimum():
    """The acceptance criterion of the adaptive search: within ε of a narrow
    optimum in at most a quarter of the trials plain Sobol needs."""
    seeds = range(6)
    tpe = np.array([_trials_to_hit_tpe(s) for s in seeds])
    sobol = np.array([_trials_to_hit_sobol(s) for s in seeds])
    assert tpe.mean() <= sobol.mean() / 4.0, (tpe.tolist(), sobol.tolist())
    assert (tpe <= 200).all(), tpe.tolist()


def test_tpe_multiobjective_steers_to_shared_peak():
    target = np.array([0.3, 0.6])
    s = tsearch.TPESampler(2, seed=1, n_startup=16)
    for _ in range(20):
        X = s.ask(4)
        s.tell(X, np.stack([-np.abs(X - target).sum(axis=1),
                            -((X - target) ** 2).sum(axis=1)], axis=1))
    assert np.median(np.linalg.norm(s.ask(16) - target, axis=1)) < 0.15
