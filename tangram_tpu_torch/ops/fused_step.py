"""The fused training steps: backward softmax-VJP + optimizer in streamed passes.

Counterpart of ``tangram_tpu/ops/fused_step.py`` for the unconstrained
modes with f32 storage and round-to-nearest. The Adam step, per step:

1. project kernel  → Y = PᵀA, q = wP from the carried row stats
2. epilogue        → loss terms and (dY, dq, dh) by ``torch.autograd.grad``
                     over the small (spots × genes) epilogue alone
3. rbar kernel     → r_c = Σ_s P ⊙ dP
4. dm_adam kernel  → g = P(dP − r) [+ L1/L2 gradient], the exact Adam
                     update of M, mu and nu in place, and the next step's
                     row stats [and L1/L2 norms]

The Adafactor step replaces 4 by two passes: the gsq kernel (Σ g² per cell
and per spot), the factored second-moment bookkeeping on those (c,) and
(s,) vectors, and the dm_adafactor kernel (M −= lr·g·rowf⊗colf in place,
plus the next row stats). Its carry is (count, vr (c,), vc (s,)) instead of
Adam's two (c, s) moment matrices.

The constrained Adam step runs the same pipeline as the Adam step with
A = S ⊙ σ(F) and w = σ(F), differentiates the constrained epilogue, and
recovers the filter F's gradient from the rbar pass (no extra pass over M);
F takes its own exact Adam step, an O(cells) vector op.

With λ_l1 or λ_l2 ≠ 0 the carried stats are (m, l, u, s1, s2): s1 = Σ|M|
and s2 = ΣM² per cell feed the epilogue's L1/L2 terms, and the update
kernels add λ₁·sign(M) + 2λ₂·M to the gradient. Entries at or below
``PAD_GUARD`` take no norm and no norm gradient, as in the JAX package.

M (and mu, nu) are updated **in place** by the update kernels: the
counterpart of the JAX kernels' ``input_output_aliases`` and of buffer
donation. Callers that need the old values keep a copy.

Adam is torch/optax Adam (b1 = 0.9, b2 = 0.999, eps = 1e-8 after the sqrt,
bias correction with the incremented count); Adafactor is optax
``adafactor`` as ``tangram_tpu.models.mapper.make_adafactor`` configures
it. Their scalars are computed as the JAX steps compute them, in f32 on the
host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cuda_core import (
    LAUNCHES,
    _check_dp_args,
    _dp_kernel_args,
    _dp_plain,
    _project,
    _rbar,
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
    constrained_epilogue,
    constrained_inputs,
    unconstrained_epilogue,
    unconstrained_inputs,
)

__all__ = [
    "fused_constrained_step",
    "fused_unconstrained_step",
    "fused_unconstrained_step_adafactor",
    "init_fused_opt_state",
    "init_fused_adafactor_state",
    "initial_stats",
    "adam_scalars",
    "adafactor_decay",
    "factored_rms_vectors",
]

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAFACTOR_EPS = 1e-30  # optax's epsilon on grad² before the row/col means
ADAFACTOR_DECAY = 0.8  # optax's power-schedule exponent: 1 − (t+1)^−0.8

# Entries at or below this are padding sentinels (the JAX package's sharded
# path plants NEG_BIG logits in spot-pad columns). The port plants none,
# but the same inputs must give the same answer.
PAD_GUARD = -1e20


def adam_scalars(step: int, learning_rate: float):
    """(lr, bc1, bc2) for Adam step ``step`` (1-based), each rounded to f32
    the way the JAX step computes them: t in f32, bc = 1 − β**t in f32."""
    t = np.float32(step)
    one = np.float32(1.0)
    bc1 = one - np.float32(BETA1) ** t
    bc2 = one - np.float32(BETA2) ** t
    return float(np.float32(learning_rate)), float(bc1), float(bc2)


def _norm_scalars(lam_l1: float, lam_l2: float):
    """(λ₁, 2λ₂) as the kernels take them: f32 of the host values, as JAX
    folds the Python constants ``lam_l1`` and ``2.0 * lam_l2`` into f32."""
    return float(np.float32(lam_l1)), float(np.float32(2.0 * lam_l2))


def _grad_plain(M, P, dP, r, lam_l1, lam_l2):
    """The loss gradient: softmax VJP g = P ⊙ (dP − r) plus the L1/L2 norm
    gradients on the raw logits (the counterpart of ``_grad_tile``)."""
    g = P * (dP - r)
    if lam_l1 != 0 or lam_l2 != 0:
        # sentinel pad entries take no norm gradient
        M_norm = torch.where(M > PAD_GUARD, M, torch.zeros_like(M))
        if lam_l1 != 0:
            g = g + lam_l1 * torch.sign(M_norm)
        if lam_l2 != 0:
            g = g + (2.0 * lam_l2) * M_norm
    return g


def _stat_outputs(M, n: int):
    c = M.shape[0]
    return [torch.empty((c, 1), dtype=torch.float32, device=M.device)
            for _ in range(n)]


def _next_stat_buffers(M, nsplit: int, with_norms: bool):
    """The update kernels' next-stats outputs: (st_part scratch, the (c, 1)
    outputs, their five pointers with NULL for the norms when off)."""
    n = 5 if with_norms else 3
    st_part = torch.empty((n, nsplit, M.shape[0]), dtype=torch.float32,
                          device=M.device)
    out = _stat_outputs(M, n)
    return st_part, out, [t.data_ptr() for t in out] + [None] * (5 - n)


# ---------------------------------------------------------------------------
# row stats with the L1/L2 norms
# ---------------------------------------------------------------------------


def _rowstats_norms_plain(M):
    z = torch.where(M > PAD_GUARD, M, torch.zeros_like(M))
    return _rowstats_plain(M) + (z.abs().sum(dim=1, keepdim=True),
                                 (z * z).sum(dim=1, keepdim=True))


def _rowstats_norms(M):
    """Softmax row stats of M plus its L1/L2 norms per cell:
    (m, l, u, s1 = Σ|M|, s2 = ΣM²), each (c, 1) f32; the norms sum only
    entries above ``PAD_GUARD``."""
    c, s = M.shape
    check("M", M, (c, s))
    lib = kernels_for(M)
    if lib is None:
        return _rowstats_norms_plain(M)
    out = _stat_outputs(M, 5)
    if c:
        with torch.cuda.device(M.device):
            lib.call("tg_rowstats_norms", M.data_ptr(),
                     *(t.data_ptr() for t in out), c, s, stream_of(M))
        LAUNCHES["rowstats_norms"] += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# backward + Adam + next row stats
# ---------------------------------------------------------------------------


def _dm_adam_plain(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh=True,
                   lam_l1=0.0, lam_l2=0.0, with_norms=False):
    lr, bc1, bc2 = scalars
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    g = _grad_plain(M, P, dP, r, lam_l1, lam_l2)
    mu_new = BETA1 * mu + (1.0 - BETA1) * g
    nu_new = BETA2 * nu + (1.0 - BETA2) * (g * g)
    inv_bc1 = float(np.float32(1.0) / np.float32(bc1))
    inv_bc2 = float(np.float32(1.0) / np.float32(bc2))
    m_hat = mu_new * inv_bc1
    v_hat = nu_new * inv_bc2
    M.copy_(M - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
    mu.copy_(mu_new)
    nu.copy_(nu_new)
    stats = _rowstats_norms_plain(M) if with_norms else _rowstats_plain(M)
    return (M, mu, nu) + stats


def _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh: bool = True,
             lam_l1: float = 0.0, lam_l2: float = 0.0, with_norms: bool = False):
    """Backward + Adam + next-step row stats in one streamed pass.

    ``scalars`` is ``(lr, bc1, bc2)`` from :func:`adam_scalars`; the
    gradient includes λ₁·sign(M) + 2λ₂·M. Updates M, mu and nu **in place**
    and returns ``(M, mu, nu, m', l', u'[, s1', s2'])``, the primed values
    being the (c, 1) softmax stats (and with ``with_norms`` the L1/L2 norms)
    of the new M.
    """
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    check("mu", mu, (c, s))
    check("nu", nu, (c, s))
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r, mu, nu)
    if lib is None:
        return _dm_adam_plain(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars,
                              with_dh, lam_l1, lam_l2, with_norms)
    lr, bc1, bc2 = scalars
    AT, dYT, nsplit, stream = _dp_kernel_args(M, A, w, dY, dq)
    st_part, out, ptrs = _next_stat_buffers(M, nsplit, with_norms)
    if c:
        with torch.cuda.device(M.device):
            lib.call("tg_dm_adam", M.data_ptr(), AT.data_ptr(), dYT.data_ptr(),
                     dh.data_ptr(), m.data_ptr(), l.data_ptr(), r.data_ptr(),
                     mu.data_ptr(), nu.data_ptr(), st_part.data_ptr(), *ptrs,
                     c, s, k + 1, int(with_dh), int(with_norms), lr, bc1, bc2,
                     *_norm_scalars(lam_l1, lam_l2), vec4_ok(s, M, mu, nu),
                     nsplit, stream)
        LAUNCHES["dm_adam"] += 1
    return (M, mu, nu) + tuple(out)


# ---------------------------------------------------------------------------
# Adafactor: the grad² statistics, the factored bookkeeping and the update
# ---------------------------------------------------------------------------


def _gsq_plain(M, A, w, m, l, dY, dq, dh, r, lam_l1, lam_l2, with_dh=True):
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    gsq = _grad_plain(M, P, dP, r, lam_l1, lam_l2) ** 2
    return gsq.sum(dim=1), gsq.sum(dim=0)


def _gsq(M, A, w, m, l, dY, dq, dh, r, lam_l1: float, lam_l2: float,
         with_dh: bool = True):
    """Adafactor's second-moment statistics of the loss gradient g (the
    same g as the update kernels, L1/L2 terms included): returns
    (vr_sum (c,), vc_sum (s,)) = (Σ_spots g², Σ_cells g²)."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r)
    if lib is None:
        return _gsq_plain(M, A, w, m, l, dY, dq, dh, r, lam_l1, lam_l2, with_dh)
    AT, dYT, nsplit, stream = _dp_kernel_args(M, A, w, dY, dq)
    dev = M.device
    vr_part = torch.empty((nsplit, c), dtype=torch.float32, device=dev)
    vc_part = torch.empty((math.ceil(c / 64), s), dtype=torch.float32, device=dev)
    vr = torch.empty((c,), dtype=torch.float32, device=dev)
    vc = torch.empty((s,), dtype=torch.float32, device=dev)
    if not c:
        return vr, vc.zero_()
    with torch.cuda.device(dev):
        lib.call("tg_gsq", M.data_ptr(), AT.data_ptr(), dYT.data_ptr(),
                 dh.data_ptr(), m.data_ptr(), l.data_ptr(), r.data_ptr(),
                 vr_part.data_ptr(), vc_part.data_ptr(), vr.data_ptr(),
                 vc.data_ptr(), c, s, k + 1, int(with_dh),
                 *_norm_scalars(lam_l1, lam_l2), vec4_ok(s, M), nsplit, stream)
    LAUNCHES["gsq"] += 1
    return vr, vc


def adafactor_decay(count: int):
    """(decay, 1 − decay) of the second-moment statistics at the step whose
    *pre-increment* count is ``count``: decay = 1 − (count + 1)^−0.8, in
    f32 on the host, as optax's ``_decay_rate_pow`` and the JAX step."""
    t = np.float32(count) + np.float32(1.0)
    decay = np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY)
    return float(decay), float(np.float32(1.0) - decay)


def factored_rms_vectors(count: int, vr, vc, vr_sum, vc_sum, c_actual: int,
                         s_actual: int):
    """The Adafactor bookkeeping between the gsq and update kernels: decay
    the carried (c,) / (s,) factor statistics toward this step's row/col
    grad² means and form the per-row / per-col factors of optax's update
    ``u = g · row_factor ⊗ col_factor``.

    Follows optax ``scale_by_factored_rms``, including its shape-dependent
    orientation: the factor on the SMALLER axis is the one divided by its
    mean. ``** -0.5`` (not rsqrt) as optax writes it: Adafactor amplifies a
    1-ulp factor difference into visibly diverged trajectories.
    Returns ``(vr_new, vc_new, rowf, colf)``."""
    decay, one_minus = adafactor_decay(count)
    gr = vr_sum / float(s_actual) + ADAFACTOR_EPS
    gc = vc_sum / float(c_actual) + ADAFACTOR_EPS
    vr_new = decay * vr + one_minus * gr
    vc_new = decay * vc + one_minus * gc
    if s_actual >= c_actual:
        rowf = (vr_new / vr_new.mean()) ** -0.5
        colf = vc_new ** -0.5
    else:
        rowf = vr_new ** -0.5
        colf = (vc_new / vc_new.mean()) ** -0.5
    return vr_new, vc_new, rowf, colf


def _dm_adafactor_plain(M, A, w, m, l, dY, dq, dh, r, rowf, colf, lr, lam_l1,
                        lam_l2, with_norms=False, with_dh=True):
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    g = _grad_plain(M, P, dP, r, lam_l1, lam_l2)
    M.copy_(M - lr * (g * rowf[:, None] * colf[None, :]))
    stats = _rowstats_norms_plain(M) if with_norms else _rowstats_plain(M)
    return (M,) + stats


def _dm_adafactor(M, A, w, m, l, dY, dq, dh, r, rowf, colf, lr: float,
                  lam_l1: float, lam_l2: float, with_norms: bool,
                  with_dh: bool = True):
    """Adafactor update + next-step row stats in one streamed pass:
    M −= lr · g · rowf[c] · colf[s] **in place**, with no moment matrices.
    Returns ``(M, m', l', u'[, s1', s2'])`` of the new M."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    check("rowf", rowf, (c,))
    check("colf", colf, (s,))
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r, rowf, colf)
    if lib is None:
        return _dm_adafactor_plain(M, A, w, m, l, dY, dq, dh, r, rowf, colf, lr,
                                   lam_l1, lam_l2, with_norms, with_dh)
    AT, dYT, nsplit, stream = _dp_kernel_args(M, A, w, dY, dq)
    st_part, out, ptrs = _next_stat_buffers(M, nsplit, with_norms)
    if c:
        with torch.cuda.device(M.device):
            lib.call("tg_dm_adafactor", M.data_ptr(), AT.data_ptr(),
                     dYT.data_ptr(), dh.data_ptr(), m.data_ptr(), l.data_ptr(),
                     r.data_ptr(), rowf.data_ptr(), colf.data_ptr(),
                     st_part.data_ptr(), *ptrs, c, s, k + 1, int(with_dh),
                     int(with_norms), float(np.float32(lr)),
                     *_norm_scalars(lam_l1, lam_l2), vec4_ok(s, M, colf), nsplit,
                     stream)
        LAUNCHES["dm_adafactor"] += 1
    return (M,) + tuple(out)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def init_fused_opt_state(M):
    """(count, mu, nu) — the fused path's Adam carry; count is a host int."""
    return 0, torch.zeros_like(M), torch.zeros_like(M)


def init_fused_adafactor_state(M):
    """(count, vr (c,), vc (s,)) — the fused Adafactor carry: f32 factor
    vectors on M's device in place of Adam's two (c, s) moment matrices."""
    c, s = M.shape
    return (0, torch.zeros((c,), dtype=torch.float32, device=M.device),
            torch.zeros((s,), dtype=torch.float32, device=M.device))


def _needs_norms(lw: LossWeights) -> bool:
    return lw.lambda_l1 != 0 or lw.lambda_l2 != 0


def initial_stats(M, lw: LossWeights):
    """Softmax row stats of M (+ its L1/L2 norms when λ_l1 or λ_l2 ≠ 0) —
    the step's carried statistics; later steps get them from the update
    kernels for free."""
    check_supported(lw)
    if _needs_norms(lw):
        return tuple(_rowstats_norms(M))
    return tuple(_rowstats(M))


def _unconstrained_cotangents(M, stats, data: MapperData, lw: LossWeights):
    """Projection forward, epilogue + its gradient, and the rbar pass.
    Returns what the update kernels need plus the per-term loss report."""
    A, w = unconstrained_inputs(M, data, lw)
    need_norms = _needs_norms(lw)
    if need_norms:
        m, l, u, s1, s2 = stats
        l1_sum, l2_sum = s1.sum(), s2.sum()
    else:
        m, l, u = stats
        l1_sum = l2_sum = None
    Y, q = _project(M, A, w, m, l)
    # h = Σ_s P log P = u/l − m − log l
    h = (u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])

    with torch.enable_grad():
        Yv, qv, hv = (x.detach().requires_grad_() for x in (Y, q, h))
        total, terms = unconstrained_epilogue(Yv, qv, hv, l1_sum, l2_sum, data, lw)
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
    return A, w, m, l, dY, dq, dh, r, terms, with_dh, need_norms


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
    A, w, m, l, dY, dq, dh, r, terms, with_dh, need_norms = (
        _unconstrained_cotangents(M, stats, data, lw))
    count_new = count + 1
    out = _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu,
                   adam_scalars(count_new, learning_rate), with_dh=with_dh,
                   lam_l1=lw.lambda_l1, lam_l2=lw.lambda_l2, with_norms=need_norms)
    M, mu, nu = out[:3]
    return M, count_new, mu, nu, tuple(out[3:]), terms


@torch.no_grad()
def fused_unconstrained_step_adafactor(M, count: int, vr, vc, stats,
                                       data: MapperData, lw: LossWeights,
                                       learning_rate: float):
    """One fused Adafactor step: the contract of
    :func:`fused_unconstrained_step` with the (c,) / (s,) factor vectors in
    place of the (c, s) Adam moments. Four streamed passes over M:
    projection, rbar, grad² statistics, and the update (which also emits
    the next stats); M is updated in place.

    Returns ``(M, count + 1, vr_new, vc_new, stats_new, terms)``.
    """
    A, w, m, l, dY, dq, dh, r, terms, with_dh, need_norms = (
        _unconstrained_cotangents(M, stats, data, lw))
    c, s = M.shape
    vr_sum, vc_sum = _gsq(M, A, w, m, l, dY, dq, dh, r, lw.lambda_l1,
                          lw.lambda_l2, with_dh=with_dh)
    vr_new, vc_new, rowf, colf = factored_rms_vectors(count, vr, vc, vr_sum,
                                                      vc_sum, c, s)
    out = _dm_adafactor(M, A, w, m, l, dY, dq, dh, r, rowf, colf, learning_rate,
                        lw.lambda_l1, lw.lambda_l2, with_norms=need_norms,
                        with_dh=with_dh)
    return out[0], count + 1, vr_new, vc_new, tuple(out[1:]), terms


def _adam_vector(x, g, mu, nu, lr: float, bc1: float, bc2: float):
    """Exact torch/optax Adam, written out as the JAX package's
    ``_adam_vector``, **in place** on ``x``, ``mu`` and ``nu`` (returned);
    ``(lr, bc1, bc2)`` from :func:`adam_scalars`."""
    mu.copy_(BETA1 * mu + (1.0 - BETA1) * g)
    nu.copy_(BETA2 * nu + (1.0 - BETA2) * (g * g))
    x.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
    return x, mu, nu


@torch.no_grad()
def fused_constrained_step(M, F, count: int, mu, nu, muF, nuF, stats,
                           data: MapperData, lw: LossWeights, learning_rate: float):
    """One fused Adam step of the constrained mapper (M and the filter
    logits F): reference ``MapperConstrained._loss_fn``
    (``mapping_optimizer.py:495-587``), Adam over ``[M, F]`` (``:607``).

    M takes the three streamed passes of :func:`fused_unconstrained_step`
    with A = S ⊙ σ(F) and w = σ(F). Both of F's paths through the core scale
    linearly in w, so its gradient comes from the rbar reduction already
    formed for the softmax VJP, r_c = w_c·(dL/dw_c)|_{A,q} + dh_c·(h_c + 1):

        dL/dF = dF_direct + (1 − w)·(r − dh·(h + 1))

    with dF_direct (the count, filter and density-denominator terms) from
    the epilogue's gradient. M, mu, nu, F, muF and nuF are updated in place.

    Returns ``((M, F), count + 1, (mu, muF), (nu, nuF), stats_new, terms)``.
    """
    A, w = constrained_inputs(F, data)
    m, l, u = stats
    Y, q = _project(M, A, w, m, l)
    h = (u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])

    with torch.enable_grad():
        Yv, qv, hsv, Fv = (x.detach().requires_grad_() for x in (Y, q, h.sum(), F))
        total, terms = constrained_epilogue(Yv, qv, hsv, Fv, data, lw)
        dY, dq, dhs, dF_direct = torch.autograd.grad(
            total, (Yv, qv, hsv, Fv), allow_unused=True)
    # q is unused without a density prior; the kernels take contiguous
    # operands, and dh is the scalar cotangent of Σh broadcast over cells
    dq = torch.zeros_like(q) if dq is None else dq.contiguous()
    dY = dY.contiguous()
    dh = dhs.expand(M.shape[0]).contiguous()
    terms = {key: v.detach() for key, v in terms.items()}

    with_dh = lw.lambda_r != 0  # λ_r = 0 ⇒ dh ≡ 0
    r = _rbar(M, A, w, m, l, dY, dq, dh, with_dh=with_dh)
    gF = dF_direct + (1.0 - w) * (r[:, 0] - dh * (h + 1.0))

    count_new = count + 1
    scalars = adam_scalars(count_new, learning_rate)
    M, mu, nu, m2, l2, u2 = _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars,
                                     with_dh=with_dh)
    F, muF, nuF = _adam_vector(F, gF, muF, nuF, *scalars)
    return (M, F), count_new, (mu, muF), (nu, nuF), (m2, l2, u2), terms
