"""The fused training step: backward softmax-VJP + Adam in one streamed pass.

Counterpart of ``tangram_tpu/ops/fused_step.py`` on the main path (Adam,
f32 storage, no L1/L2 terms, round-to-nearest). Per step:

1. project kernel  → Y = PᵀA, q = wP from the carried row stats
2. epilogue        → loss terms and (dY, dq, dh) by ``torch.autograd.grad``
                     over the small (spots × genes) epilogue alone
3. rbar kernel     → r_c = Σ_s P ⊙ dP
4. dm_adam kernel  → g = P(dP − r), the exact Adam update of M, mu and nu
                     in place, and the next step's row stats

M, mu and nu are updated **in place** by ``_dm_adam``: the counterpart of
the JAX kernel's ``input_output_aliases`` and of buffer donation. Callers
that need the old values keep a copy.

Adam is torch/optax Adam (b1 = 0.9, b2 = 0.999, eps = 1e-8 after the sqrt,
bias correction with the incremented count); its scalars are computed as
the JAX step computes them, in f32 on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cuda_core import (
    LAUNCHES,
    _project,
    _rowstats,
    _rowstats_plain,
    check,
    kernels_for,
    stream_of,
    vec4_ok,
)
from .losses import (
    LossWeights,
    MapperData,
    check_supported,
    unconstrained_epilogue,
    unconstrained_inputs,
)

__all__ = [
    "fused_unconstrained_step",
    "init_fused_opt_state",
    "initial_stats",
    "adam_scalars",
]

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_scalars(step: int, learning_rate: float):
    """(lr, bc1, bc2) for Adam step ``step`` (1-based), each rounded to f32
    the way the JAX step computes them: t in f32, bc = 1 − β**t in f32."""
    t = np.float32(step)
    one = np.float32(1.0)
    bc1 = one - np.float32(BETA1) ** t
    bc2 = one - np.float32(BETA2) ** t
    return float(np.float32(learning_rate)), float(bc1), float(bc2)


def dp_splits(c: int, s: int, sm_count: int) -> int:
    """How many blocks share the spot tiles of one 64-cell group in the
    rbar and dm_adam kernels: 1 when the cell groups alone give about two
    blocks per SM (cells mode), up to one 128-spot tile per block when there
    are few cells (clusters mode has tens)."""
    tiles = math.ceil(s / 128)
    want = math.ceil(2 * sm_count / math.ceil(c / 64))
    per = math.ceil(tiles / max(1, min(want, tiles)))
    return math.ceil(tiles / per)


def _sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _ext_transposed(X, v):
    """[X | v]ᵀ, contiguous: the (k+1, n) operand layout of the dP kernels."""
    return torch.cat([X, v[:, None]], dim=1).T.contiguous()


def _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh):
    """Materialized P and dP = A dYᵀ + w ⊗ dq [+ dh ⊙ (log P + 1)]."""
    P = torch.exp(M - m) * (1.0 / l)
    dP = A @ dY.T + w[:, None] * dq[None, :]
    if with_dh:
        dP = dP + dh[:, None] * ((M - m - torch.log(l)) + 1.0)
    return P, dP


def _check_dp_args(M, A, w, m, l, dY, dq, dh):
    c, s = M.shape
    k = A.shape[1]
    for name, t, shape in (("M", M, (c, s)), ("A", A, (c, k)), ("w", w, (c,)),
                           ("m", m, (c, 1)), ("l", l, (c, 1)),
                           ("dY", dY, (s, k)), ("dq", dq, (s,)),
                           ("dh", dh, (c,))):
        check(name, t, shape)
    return c, s, k


# ---------------------------------------------------------------------------
# rbar
# ---------------------------------------------------------------------------


def _rbar_plain(M, A, w, m, l, dY, dq, dh, with_dh=True):
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    return (P * dP).sum(dim=1, keepdim=True)


def _rbar(M, A, w, m, l, dY, dq, dh, with_dh: bool = True):
    """r_c = Σ_s P ⊙ dP (c, 1): the row reduction of the softmax VJP.
    ``with_dh=False`` drops the entropy cotangent path (λ_r = 0)."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    lib = kernels_for(M, A, w, m, l, dY, dq, dh)
    if lib is None:
        return _rbar_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    AT = _ext_transposed(A, w)
    dYT = _ext_transposed(dY, dq)
    nsplit = dp_splits(c, s, _sm_count(M))
    r_part = torch.empty((nsplit, c), dtype=torch.float32, device=M.device)
    r = torch.empty((c, 1), dtype=torch.float32, device=M.device)
    if c:
        with torch.cuda.device(M.device):
            lib.call("tg_rbar", M.data_ptr(), AT.data_ptr(), dYT.data_ptr(),
                     dh.data_ptr(), m.data_ptr(), l.data_ptr(), r_part.data_ptr(),
                     r.data_ptr(), c, s, k + 1, int(with_dh), vec4_ok(s, M),
                     nsplit, stream_of(M))
        LAUNCHES["rbar"] += 1
    return r


# ---------------------------------------------------------------------------
# backward + Adam + next row stats
# ---------------------------------------------------------------------------


def _dm_adam_plain(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh=True):
    lr, bc1, bc2 = scalars
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    g = P * (dP - r)
    mu_new = BETA1 * mu + (1.0 - BETA1) * g
    nu_new = BETA2 * nu + (1.0 - BETA2) * (g * g)
    inv_bc1 = float(np.float32(1.0) / np.float32(bc1))
    inv_bc2 = float(np.float32(1.0) / np.float32(bc2))
    m_hat = mu_new * inv_bc1
    v_hat = nu_new * inv_bc2
    M.copy_(M - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
    mu.copy_(mu_new)
    nu.copy_(nu_new)
    return (M, mu, nu) + _rowstats_plain(M)


def _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh: bool = True):
    """Backward + Adam + next-step row stats in one streamed pass.

    ``scalars`` is ``(lr, bc1, bc2)`` from :func:`adam_scalars`. Updates M,
    mu and nu **in place** and returns ``(M, mu, nu, m', l', u')``, the
    primed values being the (c, 1) softmax stats of the new M.
    """
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    check("mu", mu, (c, s))
    check("nu", nu, (c, s))
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r, mu, nu)
    if lib is None:
        return _dm_adam_plain(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars,
                              with_dh)
    lr, bc1, bc2 = scalars
    AT = _ext_transposed(A, w)
    dYT = _ext_transposed(dY, dq)
    nsplit = dp_splits(c, s, _sm_count(M))
    parts = torch.empty((3, nsplit, c), dtype=torch.float32, device=M.device)
    m2, l2, u2 = (torch.empty((c, 1), dtype=torch.float32, device=M.device)
                  for _ in range(3))
    if c:
        with torch.cuda.device(M.device):
            lib.call("tg_dm_adam", M.data_ptr(), AT.data_ptr(), dYT.data_ptr(),
                     dh.data_ptr(), m.data_ptr(), l.data_ptr(), r.data_ptr(),
                     mu.data_ptr(), nu.data_ptr(), parts[0].data_ptr(),
                     parts[1].data_ptr(), parts[2].data_ptr(), m2.data_ptr(),
                     l2.data_ptr(), u2.data_ptr(), c, s, k + 1, int(with_dh), lr,
                     bc1, bc2, vec4_ok(s, M, mu, nu), nsplit, stream_of(M))
        LAUNCHES["dm_adam"] += 1
    return M, mu, nu, m2, l2, u2


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def init_fused_opt_state(M):
    """(count, mu, nu) — the fused path's Adam carry; count is a host int."""
    return 0, torch.zeros_like(M), torch.zeros_like(M)


def initial_stats(M, lw: LossWeights):
    """Softmax row stats of M — the step's carried statistics; later steps
    get them from the Adam kernel for free."""
    check_supported(lw)
    return tuple(_rowstats(M))


def _unconstrained_cotangents(M, stats, data: MapperData, lw: LossWeights):
    """Projection forward, epilogue + its gradient, and the rbar pass.
    Returns what the update kernel needs plus the per-term loss report."""
    A, w = unconstrained_inputs(M, data, lw)
    m, l, u = stats
    Y, q = _project(M, A, w, m, l)
    # h = Σ_s P log P = u/l − m − log l
    h = (u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])

    with torch.enable_grad():
        Yv, qv, hv = (x.detach().requires_grad_() for x in (Y, q, h))
        total, terms = unconstrained_epilogue(Yv, qv, hv, data, lw)
        dY, dq, dh = torch.autograd.grad(total, (Yv, qv, hv), allow_unused=True)
    # q is unused without a density prior; dh is zero when λ_r = 0.
    # Autograd may hand back expanded (stride-0) gradients: the kernels take
    # contiguous operands.
    dq = torch.zeros_like(q) if dq is None else dq.contiguous()
    dh = torch.zeros_like(h) if dh is None else dh.contiguous()
    dY = dY.contiguous()
    terms = {key: v.detach() for key, v in terms.items()}

    with_dh = lw.lambda_r != 0
    r = _rbar(M, A, w, m, l, dY, dq, dh, with_dh=with_dh)
    return A, w, m, l, dY, dq, dh, r, terms, with_dh


@torch.no_grad()
def fused_unconstrained_step(M, count: int, mu, nu, stats, data: MapperData,
                             lw: LossWeights, learning_rate: float):
    """One fused Adam step.

    ``stats`` are the carried row stats of M (from :func:`initial_stats` or
    the previous step), so a step makes three streamed passes over M:
    projection, rbar, and backward + Adam (which also emits the next
    stats). M, mu and nu are updated in place.

    Returns ``(M, count + 1, mu, nu, stats_new, terms)``; ``terms`` are
    0-d tensors on M's device, measured at M before the update.
    """
    A, w, m, l, dY, dq, dh, r, terms, with_dh = _unconstrained_cotangents(
        M, stats, data, lw
    )
    count_new = count + 1
    out = _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu,
                   adam_scalars(count_new, learning_rate), with_dh=with_dh)
    M, mu, nu = out[:3]
    return M, count_new, mu, nu, tuple(out[3:]), terms
