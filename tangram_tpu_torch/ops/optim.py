"""The optimizers of the loops that hold a materialized gradient.

Counterpart of the JAX package's ``make_adam``, ``make_adafactor`` and
``make_optimizer`` (``tangram_tpu/models/mapper.py``), which return optax
transformations. Here each returns a small object in PyTorch's idiom:

* ``init(params)`` → the carry the port's loops and checkpoints hold:
  Adam ``(count, mu, nu)``, Adafactor ``(count, vr (c,), vc (s,))``; for
  the constrained pair ``params = (M, F)`` Adam's moments are (M, F) pairs
  and Adafactor's carry ends with F's unfactored ``v``. Each moment takes
  its parameter's type, as optax's ``init`` makes them.
* ``update(grads, state, params)`` → applies the step to ``params`` in
  place (and to the moments it updates in place) and returns the new
  carry.

Both are optax's update written out, in the parameter's own type: f32, or
below f32 op by op as optax 0.2.6 runs on such a parameter (the Python
constants rounded to that type first). The autograd loop, the generic mesh
loop, the batched CV and the fused constrained steps' F take their update
from here; the fused kernels do the same update inside ``dm_adam`` and
``dm_adafactor``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_adam", "make_adafactor", "make_optimizer", "adam_scalars",
           "adafactor_decay"]

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAFACTOR_EPS = 1e-30  # optax's epsilon on grad² before the row/col means
ADAFACTOR_DECAY = 0.8  # optax's power-schedule exponent: 1 − (t+1)^−0.8


def adam_scalars(step: int, learning_rate: float):
    """(lr, bc1, bc2) for Adam step ``step`` (1-based), each rounded to f32
    the way the JAX step computes them: t in f32, bc = 1 − β**t in f32."""
    t = np.float32(step)
    one = np.float32(1.0)
    bc1 = one - np.float32(BETA1) ** t
    bc2 = one - np.float32(BETA2) ** t
    return float(np.float32(learning_rate)), float(bc1), float(bc2)


def adafactor_decay(count: int):
    """(decay, 1 − decay) of the second-moment statistics at the step whose
    *pre-increment* count is ``count``: decay = 1 − (count + 1)^−0.8, in
    f32 on the host, as optax's ``_decay_rate_pow`` and the JAX step."""
    t = np.float32(count) + np.float32(1.0)
    decay = np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY)
    return float(decay), float(np.float32(1.0) - decay)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as optax meets it beside an array: rounded to the
    array's type (JAX's weak typing), here a 0-d tensor of ``like``'s type
    so that the product rounds once, as a product of two values of that
    type does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _mean_in(x, dim=None):
    """``jnp.mean`` of a low-precision array: summed and divided in f32,
    stored in the array's type (the identity of ``x.mean`` for f32)."""
    m = x.float().mean() if dim is None else x.float().mean(dim=dim)
    return m.to(x.dtype)


def _leaves(tree):
    """The parameters (or their gradients) as a tuple: M alone, or the
    constrained pair."""
    return tuple(tree) if isinstance(tree, (tuple, list)) else (tree,)


def _zeros(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=p.dtype, device=p.device)


def _adam_f32(x, g, mu, nu, lr: float, bc1: float, bc2: float):
    """torch's and optax's Adam on an f32 parameter, in place on ``x``,
    ``mu`` and ``nu``; ``(lr, bc1, bc2)`` from :func:`adam_scalars`."""
    mu.copy_(BETA1 * mu + (1.0 - BETA1) * g)
    nu.copy_(BETA2 * nu + (1.0 - BETA2) * (g * g))
    x.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))


def _adam_low_precision(p, g, mu, nu, count: int, learning_rate: float):
    """optax ``adam`` on a parameter stored below f32, in place on ``p``,
    ``mu`` and ``nu`` (moments in ``p``'s type): every update op in that
    type, rounded to nearest, with the Python constants b1, 1 − b1, b2,
    1 − b2, eps and lr rounded to it (0.9 is 0.8984375 in bf16 and 0.999 is
    1.0), and the bias corrections 1 − b^t formed in f32 and then rounded.
    ``count`` is the incremented step."""
    mu.copy_(_const(1.0 - BETA1, g) * g + _const(BETA1, mu) * mu)
    nu.copy_(_const(1.0 - BETA2, g) * (g * g) + _const(BETA2, nu) * nu)
    _, bc1, bc2 = adam_scalars(count, learning_rate)
    u = (mu / _const(bc1, mu)) / (torch.sqrt(nu / _const(bc2, nu)) + _const(ADAM_EPS, nu))
    p.add_(_const(-float(np.float32(learning_rate)), u) * u)


class DeviceMeans:
    """The means of the factored Adafactor update over one device's M: its
    row and column means of g², and the normalizing mean of a statistic.
    Each is summed and divided in f32 and stored in the statistic's type.
    A mesh loop passes its own, which sums over the shards and leaves the
    padding out (``parallel.mesh``)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def grad_sqr(self, grad_sqr):
        """(row means (c,), column means (s,)) of g² + ε."""
        return _mean_in(grad_sqr, 1), _mean_in(grad_sqr, 0)

    def factors(self, vr, vc):
        """The statistics the factors are formed from."""
        return vr, vc

    def mean(self, v, cells: bool):
        """The mean of ``v``, a statistic over the cells or the spots."""
        return _mean_in(v)


def _factored_update(M, g, count: int, vr, vc, learning_rate: float, means):
    """optax ``adafactor``'s factored branch on a 2-D M, in place, with no
    momentum, no clipping and no parameter scale; returns the new ``vr``
    (c,) and ``vc`` (s,). optax's orientation: the statistic on the smaller
    axis is divided by its mean, and the update multiplies the factor of
    that axis first. The decayed statistics are formed in f32 (optax's
    decay is an f32 array) and stored in M's type."""
    dt = M.dtype
    decay, one_minus = adafactor_decay(count)
    row, col = means.grad_sqr(g * g + _const(ADAFACTOR_EPS, g))
    vr = (decay * vr.float() + one_minus * row.float()).to(dt)
    vc = (decay * vc.float() + one_minus * col.float()).to(dt)
    vr_f, vc_f = means.factors(vr, vc)
    c, s = means.shape
    if s >= c:
        u = g * ((vr_f / means.mean(vr_f, cells=True)) ** -0.5)[:, None] * (vc_f ** -0.5)[None, :]
    else:
        u = g * ((vc_f / means.mean(vc_f, cells=False)) ** -0.5)[None, :] * (vr_f ** -0.5)[:, None]
    M.sub_(_const(float(np.float32(learning_rate)), u) * u)
    return vr, vc


def _unfactored_update(x, g, count: int, v, learning_rate: float):
    """optax ``adafactor``'s unfactored branch, for a parameter with fewer
    than two dimensions (the constrained mapper's filter logits F):
    v = d·v + (1 − d)(g² + ε), x −= lr·g·v^−0.5, in place on ``x``;
    returns the new ``v``."""
    decay, one_minus = adafactor_decay(count)
    v = decay * v + one_minus * (g * g + ADAFACTOR_EPS)
    x.sub_(float(np.float32(learning_rate)) * (g * v ** -0.5))
    return v


class Adam:
    """:func:`make_adam`'s optimizer: torch's ``Adam`` defaults (betas 0.9
    and 0.999, eps 1e-8 added after the square root), as optax ``adam``
    with ``eps_root=0``."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params):
        """``(0, mu, nu)``: zeros of each parameter's shape and type, a
        pair each for the constrained ``(M, F)``."""
        leaves = _leaves(params)
        mus = tuple(_zeros(p) for p in leaves)
        nus = tuple(_zeros(p) for p in leaves)
        if isinstance(params, (tuple, list)):
            return 0, mus, nus
        return 0, mus[0], nus[0]

    @torch.no_grad()
    def update(self, grads, state, params):
        """One Adam step on every parameter, in place on it and its moments;
        returns ``(count + 1, mu, nu)``. A parameter below f32 updates in
        its own type (see :func:`_adam_low_precision`)."""
        count, mu, nu = state
        scalars = adam_scalars(count + 1, self.learning_rate)
        for p, g, m, n in zip(_leaves(params), _leaves(grads), _leaves(mu), _leaves(nu)):
            if p.dtype == torch.float32:
                _adam_f32(p, g, m, n, *scalars)
            else:
                _adam_low_precision(p, g, m, n, count + 1, self.learning_rate)
        return count + 1, mu, nu


class Adafactor:
    """:func:`make_adafactor`'s optimizer: factored second moments for M
    (``min_dim_size_to_factor=2``), the unfactored statistic for the
    constrained F; no momentum, no update clipping, no parameter scale."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params):
        """``(0, vr (c,), vc (s,))`` in M's type, with F's zeros last for
        the constrained ``(M, F)``."""
        M, *rest = _leaves(params)
        c, s = M.shape
        return (0, _zeros(M, (c,)), _zeros(M, (s,))) + tuple(_zeros(p) for p in rest)

    @torch.no_grad()
    def update(self, grads, state, params, means=None):
        """One step, in place on M (and F); returns ``(count + 1, vr, vc[,
        vF])``. ``means`` gives the factored update its means
        (:class:`DeviceMeans` of M's shape by default)."""
        (M, *rest), (g, *g_rest) = _leaves(params), _leaves(grads)
        count = state[0]
        means = DeviceMeans(M.shape) if means is None else means
        vr, vc = _factored_update(M, g, count, state[1], state[2], self.learning_rate,
                                  means)
        vF = tuple(_unfactored_update(x, gx, count, v, self.learning_rate)
                   for x, gx, v in zip(rest, g_rest, state[3:]))
        return (count + 1, vr, vc) + vF


def make_adam(learning_rate: float) -> Adam:
    """Adam matching ``torch.optim.Adam`` defaults exactly
    (betas=(0.9, 0.999), eps=1e-8 added after the sqrt; ``eps_root=0``)."""
    return Adam(learning_rate)


def make_adafactor(learning_rate: float) -> Adafactor:
    """Adafactor (Shazeer & Stern 2018) as used by ``optimizer='adafactor'``:
    factored second moments only — no momentum, no update clipping, explicit
    learning rate (no relative step sizes or parameter-scale multiply), and
    ``min_dim_size_to_factor=2`` so M is factored at every problem size.
    Its state is c + s floats for a (c, s) M, against Adam's 2·c·s."""
    return Adafactor(learning_rate)


def make_optimizer(name: str, learning_rate: float):
    """Resolve ``optimizer=`` ("adam", the reference's choice and the
    default, or "adafactor") to its optimizer."""
    if name == "adam":
        return make_adam(learning_rate)
    if name == "adafactor":
        return make_adafactor(learning_rate)
    raise ValueError(
        f'optimizer must be "adam" or "adafactor", got {name!r}'
    )
