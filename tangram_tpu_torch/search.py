"""Adaptive hyperparameter search: a Tree-structured Parzen Estimator.

Counterpart of ``tangram_tpu/search.py``, which is numpy on the host and is
copied here so that the port imports nothing of the JAX package; with the
same seed and the same ``tell`` history, ``ask`` returns the same rows bit
for bit.

The reference's tuner is Ray Tune + ``OptunaSearch`` with multi-objective
TPE (``mapping_parameter_tuning.py:259-271``): an *adaptive* sampler that
concentrates trials near configurations whose reported metrics were good.
This module supplies that capability without Ray or Optuna, as a plain
ask/tell object over the unit hypercube — the tuner maps unit rows through
its search-space domains exactly as it does for Sobol, so the two search
modes share every downstream code path (the batched population on the
device).

TPE in one paragraph: keep all observed (x, y); split them into a "good"
set D_l (top γ fraction by objective — for multiple objectives, by
nondomination rank, as in MOTPE) and a "bad" set D_g; model each set's x
distribution with a per-dimension Parzen window (mixture of truncated
normals centered on the observed coordinates); sample candidates from the
good model l(x) and keep the candidate maximizing the density ratio
l(x)/g(x), which is monotone in expected improvement. Reference: Bergstra
et al., "Algorithms for Hyper-Parameter Optimization", NeurIPS 2011;
Ozaki et al., "Multiobjective TPE", GECCO 2020.

Everything is numpy on host — the objective evaluations it steers are the
expensive part and run on device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TPESampler", "nondominated_rank", "pareto_order"]


def nondominated_rank(Y: np.ndarray) -> np.ndarray:
    """Pareto front index of each row of ``Y`` (objectives, maximized):
    rank 0 = nondominated, rank 1 = nondominated after removing rank 0, ...

    O(n² · m) pairwise comparisons — n is a trial count (hundreds), not a
    data size.
    """
    Y = np.asarray(Y, dtype=np.float64)
    n = Y.shape[0]
    # dominates[i, j]: i is at least as good everywhere and better somewhere
    ge = (Y[:, None, :] >= Y[None, :, :]).all(-1)
    gt = (Y[:, None, :] > Y[None, :, :]).any(-1)
    dominates = ge & gt
    rank = np.full(n, -1, dtype=np.int64)
    remaining = np.ones(n, dtype=bool)
    level = 0
    while remaining.any():
        # dominated-by counts within the remaining set
        dominated = (dominates & remaining[:, None]).any(axis=0) & remaining
        front = remaining & ~dominated
        if not front.any():  # numerical ties: close out the rest
            front = remaining
        rank[front] = level
        remaining &= ~front
        level += 1
    return rank


def pareto_order(Y: np.ndarray) -> np.ndarray:
    """Row indices of ``Y`` (objectives, maximized), best first.

    Single objective: stable descending sort. Multiple objectives:
    nondomination rank, ties broken by a normalized objective-sum crowding
    proxy (the MOTPE split rule). Rows with any non-finite objective sort
    last, in their original order — a diverged trial never outranks a
    finite one. Shared by ``TPESampler._split`` and the halving scheduler's
    survivor selection so the two orderings cannot drift apart.
    """
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    finite = np.isfinite(Y).all(axis=1)
    idx_finite = np.flatnonzero(finite)
    idx_bad = np.flatnonzero(~finite)
    Yf = Y[finite]
    if Yf.shape[0] == 0:
        return idx_bad
    if Yf.shape[1] == 1:
        order_f = np.argsort(-Yf[:, 0], kind="stable")
    else:
        rank = nondominated_rank(Yf)
        # within equal ranks, prefer points better on the (normalized)
        # objective sum — a cheap crowding proxy that keeps the ordering
        # deterministic
        lo, hi = Yf.min(axis=0), Yf.max(axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        crowd = ((Yf - lo) / span).sum(axis=1)
        order_f = np.lexsort((-crowd, rank))
    return np.concatenate([idx_finite[order_f], idx_bad])


class TPESampler:
    """Ask/tell TPE over the unit hypercube, single- or multi-objective.

    Args:
        n_dims: dimensionality of the unit hypercube.
        seed: RNG seed (deterministic ask sequence given the same tells).
        n_startup: observations before the Parzen model kicks in; until
            then ``ask`` returns scrambled-Sobol points (better coverage
            than i.i.d. uniform at equal counts).
        gamma: fraction of observations forming the "good" set.
        max_good: cap on the good-set size — as observations accumulate the
            good set stays the top-``max_good`` points, so the model
            concentrates instead of tracking a fixed fraction of an
            ever-larger history (Optuna caps at 25 the same way).
        n_ei_candidates: candidates drawn from l(x) per suggestion; the
            argmax of l/g is returned (Optuna's default is 24).
    """

    def __init__(
        self,
        n_dims: int,
        seed: int | None = 0,
        n_startup: int = 16,
        gamma: float = 0.25,
        max_good: int = 25,
        n_ei_candidates: int = 24,
    ):
        if n_dims < 1:
            raise ValueError("n_dims must be >= 1")
        self.n_dims = n_dims
        self.n_startup = int(n_startup)
        self.gamma = float(gamma)
        self.max_good = int(max_good)
        self.n_ei_candidates = int(n_ei_candidates)
        self._rng = np.random.default_rng(seed)
        from scipy.stats import qmc

        self._sobol = qmc.Sobol(d=n_dims, scramble=True, seed=seed)
        self._X = np.empty((0, n_dims), dtype=np.float64)
        self._Y = None  # (n, m) objectives, maximized

    # -- observations --------------------------------------------------

    def tell(self, X, Y):
        """Record evaluated points. ``X``: (n, n_dims) unit rows; ``Y``:
        (n,) or (n, m) objective values (maximized; NaN rows are kept but
        never enter the good set)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        if X.shape[0] != Y.shape[0]:
            raise ValueError("X and Y must have matching first dimensions")
        if X.shape[1] != self.n_dims:
            raise ValueError(f"X must have {self.n_dims} columns")
        self._X = np.concatenate([self._X, X], axis=0)
        self._Y = Y if self._Y is None else np.concatenate([self._Y, Y], axis=0)

    @property
    def n_observed(self) -> int:
        return self._X.shape[0]

    # -- suggestions ---------------------------------------------------

    def ask(self, n: int = 1) -> np.ndarray:
        """Suggest ``n`` unit-hypercube rows."""
        out = np.empty((n, self.n_dims), dtype=np.float64)
        for i in range(n):
            out[i] = self._ask_one()
        return out

    def _sobol_point(self) -> np.ndarray:
        import warnings

        with warnings.catch_warnings():
            # one-at-a-time draws are the ask/tell contract; scipy's
            # power-of-2 balance advice doesn't apply to a startup stream
            warnings.filterwarnings(
                "ignore", message=".*balance properties of Sobol.*"
            )
            return np.clip(self._sobol.random(1)[0], 0.0, 1.0)

    def _ask_one(self) -> np.ndarray:
        if self.n_observed < self.n_startup:
            return self._sobol_point()
        good, bad = self._split()
        if len(good) == 0 or len(bad) == 0:
            return self._sobol_point()
        cands = self._sample_parzen(good, self.n_ei_candidates)
        score = self._log_parzen(cands, good) - self._log_parzen(cands, bad)
        return cands[int(np.argmax(score))]

    # -- internals -----------------------------------------------------

    def _split(self):
        """(good, bad) observation coordinates. Single objective: top-γ by
        value. Multi-objective: top-γ by (nondomination rank, then crowding
        by objective sum) — the MOTPE split. Non-finite observations enter
        neither set (``pareto_order`` sorts them last; they are sliced
        off)."""
        n = int(np.isfinite(self._Y).all(axis=1).sum())
        if n == 0:
            return self._X[:0], self._X[:0]
        order = pareto_order(self._Y)[:n]  # finite rows, best first
        n_good = max(1, min(int(np.ceil(self.gamma * n)), self.max_good))
        return self._X[order[:n_good]], self._X[order[n_good:]]

    def _bandwidth(self, pts: np.ndarray) -> np.ndarray:
        """Per-dimension Parzen bandwidth: Scott's-rule spread of the set,
        clipped so kernels neither collapse (greedy exploitation of one
        point) nor flatten to uniform."""
        n = max(pts.shape[0], 2)
        sd = pts.std(axis=0)
        bw = 1.06 * np.maximum(sd, 1e-3) * n ** (-1.0 / 5.0)
        return np.clip(bw, 1.0 / (1 + n), 0.5)

    def _sample_parzen(self, pts: np.ndarray, n: int) -> np.ndarray:
        """Draw ``n`` candidates from the Parzen mixture over ``pts``
        (truncated to the unit box by clipping)."""
        bw = self._bandwidth(pts)
        centers = pts[self._rng.integers(0, pts.shape[0], size=n)]
        draws = centers + self._rng.normal(size=(n, self.n_dims)) * bw
        return np.clip(draws, 0.0, 1.0)

    def _log_parzen(self, cands: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """log density of each candidate under the Parzen mixture over
        ``pts`` (independent per dimension, summed in log space)."""
        bw = self._bandwidth(pts)  # (d,)
        # (cands, pts, d) standardized distances
        z = (cands[:, None, :] - pts[None, :, :]) / bw
        log_norm = -0.5 * np.log(2 * np.pi) - np.log(bw)  # (d,)
        comp = -0.5 * z * z + log_norm  # per-dim log kernel
        # per-dim mixture: logsumexp over points, then sum dims
        m = comp.max(axis=1, keepdims=True)
        per_dim = m[:, 0, :] + np.log(
            np.exp(comp - m).sum(axis=1) / pts.shape[0]
        )
        return per_dim.sum(axis=1)
