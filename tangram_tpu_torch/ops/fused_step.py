"""The fused training steps: backward softmax-VJP + optimizer in streamed passes.

Counterpart of ``tangram_tpu/ops/fused_step.py``. The Adam step, per step:

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
Adam's two (c, s) moment matrices. rbar, gsq and the update all run on the
tensor-core dP tile, from the step's operands built once.

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

Low precision, as the JAX steps: M may be stored in bf16, and Adam's mu
and nu too (Adafactor's factor vectors and the constrained filter's
moments stay f32); ``compute_dtype`` rounds A and dY before the kernels
(w, dq, dh, the stats and the update stay f32). The updates compute in f32
and store to nearest even, or with ``rounding="stochastic"`` by
:func:`_sr_cast`, keyed by the step count, the cell and the array, and
emit the next stats from the stored values.

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
    F32_BF16,
    DpOperands,
    _check_dp_args,
    _check_operands,
    _dp_plain,
    _sm_count,
    dp_operand,
    dp_operands,
    dp_splits,
    _project,
    _rbar,
    _rowstats,
    _rowstats_plain,
    check,
    is_bf16,
    kernels_for,
    launch,
    rowstats_load_bytes,
    stage_granule,
    stream_of,
    tf32_product_plain,
    vec2_ok,
)
from .losses import (
    LossWeights,
    MapperData,
    constrained_epilogue,
    constrained_inputs,
    unconstrained_epilogue,
    unconstrained_inputs,
)
from .optim import (
    ADAFACTOR_EPS,
    ADAM_EPS,
    BETA1,
    BETA2,
    adafactor_decay,
    adam_scalars,
    make_adam,
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
    "gsq_tf32_plain",
    "unconstrained_a_operand",
]

# Entries at or below this are padding sentinels (the JAX package's sharded
# path plants NEG_BIG logits in spot-pad columns). The port plants none,
# but the same inputs must give the same answer.
PAD_GUARD = -1e20

ROUNDINGS = ("nearest", "stochastic")


# ---------------------------------------------------------------------------
# stochastic rounding: the JAX package's counter hash, keyed per cell row
# ---------------------------------------------------------------------------
#
# uint32 arithmetic on int64 tensors: values stay below 2**32 and every
# product is formed in 16-bit halves, so nothing overflows int64.

_U32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """x · m mod 2**32 for an int64 tensor ``x`` of uint32 values."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _U32


def _wang_hash(x):
    """The JAX package's 32-bit Wang hash (``fused_step._wang_hash``) of an
    int64 tensor of uint32 values."""
    x = (x ^ 61) ^ (x >> 16)
    x = _mul32(x, 9)
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27D4EB2D)
    return x ^ (x >> 15)


def _sr_bits(n: int, seed):
    """(rows, n) random bits: row i as ``_tile_random_bits((1, n),
    seed_i)`` draws them for a one-row tile, wang(j ^ wang(seed_i ·
    0x9E3779B9)); ``seed`` is a (rows, 1) int64 tensor of uint32 values."""
    key = _wang_hash(_mul32(seed, 0x9E3779B9))
    return _wang_hash(torch.arange(n, device=seed.device) ^ key)


def _sr_cast(val, dtype, seed):
    """Stochastic f32 → bf16 cast of each row of ``val`` (rows, n), row i
    bit for bit as the JAX package's ``_sr_cast(val[i][None, :], bf16,
    seed_i)``: add 16 random bits below the bf16 mantissa and truncate
    (unbiased: E[stored] = value). ``seed`` is an int or a (rows, 1) int64
    tensor of uint32 values. For an f32 ``dtype``, the identity. Works in
    row chunks, so its int64 temporaries stay near 2**22 entries."""
    if dtype == torch.float32:
        return val
    if dtype != torch.bfloat16:
        raise TypeError(f"stochastic rounding stores float32 or bfloat16, not {dtype}")
    rows, n = val.shape
    seed = torch.as_tensor(seed, dtype=torch.int64, device=val.device)
    seed = seed.reshape(-1, 1).expand(rows, 1)
    out = torch.empty((rows, n), dtype=dtype, device=val.device)
    step = max(1, (1 << 22) // max(n, 1))
    for r0 in range(0, rows, step):
        v = val[r0:r0 + step].float().contiguous()
        bits = _sr_bits(n, seed[r0:r0 + step])
        u = ((v.view(torch.int32).to(torch.int64) & _U32) + (bits & 0xFFFF)) & 0xFFFF0000
        u = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
        out[r0:r0 + step] = u.view(torch.float32).to(dtype)  # exact: low bits are 0
    return out


def _stored(val, dtype, rounding: str, step: int, salt: int):
    """What an update kernel stores for the f32 values ``val`` (c, s) in an
    array of ``dtype``: ``val`` itself in f32; in bf16 the nearest even (as
    ``astype``), or stochastically :func:`_sr_cast` of cell row c with seed
    wang(step ^ c·0x85EBCA6B) ^ salt — JAX's per-(step, tile, array) seed
    with one cell row as the tile. ``salt`` is 1, 2, 3 for M, mu, nu."""
    if dtype == torch.float32:
        return val
    if rounding == "stochastic":
        cells = torch.arange(val.shape[0], device=val.device)[:, None]
        base = _wang_hash((step & _U32) ^ _mul32(cells, 0x85EBCA6B))
        return _sr_cast(val, dtype, base ^ salt)
    return val.to(dtype)


def _check_rounding(rounding: str) -> bool:
    """True for stochastic rounding; raises for anything but the two."""
    if rounding not in ROUNDINGS:
        raise ValueError(f'rounding must be "nearest" or "stochastic", got {rounding!r}')
    return rounding == "stochastic"


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
    M = M.float()
    z = torch.where(M > PAD_GUARD, M, torch.zeros_like(M))
    return _rowstats_plain(M) + (z.abs().sum(dim=1, keepdim=True),
                                 (z * z).sum(dim=1, keepdim=True))


def _rowstats_norms(M):
    """Softmax row stats of M (f32 or bf16) plus its L1/L2 norms per cell:
    (m, l, u, s1 = Σ|M|, s2 = ΣM²), each (c, 1) f32; the norms sum only
    entries above ``PAD_GUARD``."""
    c, s = M.shape
    check("M", M, (c, s), F32_BF16)
    lib = kernels_for(M)
    if lib is None:
        return _rowstats_norms_plain(M)
    out = _stat_outputs(M, 5)
    if c:
        with torch.cuda.device(M.device), launch("rowstats_norms", M):
            lib.call("tg_rowstats_norms", M.data_ptr(),
                     *(t.data_ptr() for t in out), c, s, is_bf16(M),
                     rowstats_load_bytes(M), stream_of(M))
    return tuple(out)


# ---------------------------------------------------------------------------
# backward + Adam + next row stats
# ---------------------------------------------------------------------------


def _dm_adam_plain(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh=True,
                   lam_l1=0.0, lam_l2=0.0, with_norms=False, rounding="nearest",
                   step=0):
    lr, bc1, bc2 = scalars
    Mf = M.float()
    P, dP = _dp_plain(Mf, A, w, m, l, dY, dq, dh, with_dh)
    g = _grad_plain(Mf, P, dP, r, lam_l1, lam_l2)
    mu_new = BETA1 * mu.float() + (1.0 - BETA1) * g
    nu_new = BETA2 * nu.float() + (1.0 - BETA2) * (g * g)
    inv_bc1 = float(np.float32(1.0) / np.float32(bc1))
    inv_bc2 = float(np.float32(1.0) / np.float32(bc2))
    m_hat = mu_new * inv_bc1
    v_hat = nu_new * inv_bc2
    M_new = Mf - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    M.copy_(_stored(M_new, M.dtype, rounding, step, 1))
    mu.copy_(_stored(mu_new, mu.dtype, rounding, step, 2))
    nu.copy_(_stored(nu_new, nu.dtype, rounding, step, 3))
    stats = _rowstats_norms_plain(M) if with_norms else _rowstats_plain(M)
    return (M, mu, nu) + stats


def _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh: bool = True,
             lam_l1: float = 0.0, lam_l2: float = 0.0, with_norms: bool = False,
             rounding: str = "nearest", step: int = 0,
             operands: DpOperands | None = None):
    """Backward + Adam + next-step row stats in one streamed pass.

    ``scalars`` is ``(lr, bc1, bc2)`` from :func:`adam_scalars`; the
    gradient includes λ₁·sign(M) + 2λ₂·M. M, A and dY are f32 or bf16, mu
    and nu f32 or bf16. Updates M, mu and nu **in place**, each stored in
    its own type to nearest even or, with ``rounding="stochastic"``, by
    :func:`_stored` keyed by ``step`` (the incremented count), and returns
    ``(M, mu, nu, m', l', u'[, s1', s2'])``, the primed values being the
    (c, 1) softmax stats (and with ``with_norms`` the L1/L2 norms) of the
    stored M. ``operands`` are ``dp_operands(A, dY)`` when the caller has
    built them for the step already (see :func:`_rbar`).
    """
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    check("mu", mu, (c, s), F32_BF16)
    check("nu", nu, (c, s), F32_BF16)
    sr = _check_rounding(rounding)
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r, mu, nu)
    if operands is not None:
        _check_operands(operands, A, dY)
    if lib is None:
        return _dm_adam_plain(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars,
                              with_dh, lam_l1, lam_l2, with_norms, rounding, step)
    if mu.dtype != nu.dtype:
        raise TypeError(f"mu and nu must share a type, got {mu.dtype} and {nu.dtype}")
    lr, bc1, bc2 = scalars
    ops = dp_operands(A, dY) if operands is None else operands
    Kp = ops.A_op.shape[1]
    nsplit = dp_splits(c, s, _sm_count(M))
    st_part, out, ptrs = _next_stat_buffers(M, nsplit, with_norms)
    if c:
        with torch.cuda.device(M.device), launch("dm_adam", M, mu, nu):
            lib.call("tg_dm_adam", M.data_ptr(), ops.A_op.data_ptr(),
                     ops.dY_op.data_ptr(), w.data_ptr(), dq.data_ptr(),
                     dh.data_ptr(), m.data_ptr(), l.data_ptr(), r.data_ptr(),
                     mu.data_ptr(), nu.data_ptr(), st_part.data_ptr(), *ptrs,
                     c, s, Kp, int(with_dh), int(with_norms), lr, bc1, bc2,
                     *_norm_scalars(lam_l1, lam_l2), vec2_ok(s, M, mu, nu),
                     nsplit, is_bf16(M), is_bf16(mu), int(sr), step & 0x7FFFFFFF,
                     int(ops.split), stage_granule(s, M),
                     min(stage_granule(s, mu), stage_granule(s, nu)), stream_of(M))
    return (M, mu, nu) + tuple(out)


# ---------------------------------------------------------------------------
# Adafactor: the grad² statistics, the factored bookkeeping and the update
# ---------------------------------------------------------------------------


def _gsq_plain(M, A, w, m, l, dY, dq, dh, r, lam_l1, lam_l2, with_dh=True):
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    gsq = _grad_plain(M.float(), P, dP, r, lam_l1, lam_l2) ** 2
    return gsq.sum(dim=1), gsq.sum(dim=0)


def gsq_tf32_plain(M, A, w, m, l, dY, dq, dh, r, lam_l1, lam_l2, with_dh=True,
                   terms: int = 3):
    """(vr, vc) as the tensor-core gsq kernel forms them from f32 A and dY:
    A dYᵀ from their TF32 parts (:func:`tf32_product_plain`), then w ⊗ dq
    [and the entropy term] in f32; ``terms=1`` is the single TF32 pass,
    which loses f32 accuracy."""
    Mf = M.float()
    P = torch.exp(Mf - m) * (1.0 / l)
    dP = tf32_product_plain(A.float(), dY.float(), terms) + w[:, None] * dq[None, :]
    if with_dh:
        dP = dP + dh[:, None] * ((Mf - m - torch.log(l)) + 1.0)
    gsq = _grad_plain(Mf, P, dP, r, lam_l1, lam_l2) ** 2
    return gsq.sum(dim=1), gsq.sum(dim=0)


def _gsq(M, A, w, m, l, dY, dq, dh, r, lam_l1: float, lam_l2: float,
         with_dh: bool = True, operands: DpOperands | None = None):
    """Adafactor's second-moment statistics of the loss gradient g (the
    same g as the update kernels, L1/L2 terms included): returns
    (vr_sum (c,), vc_sum (s,)) = (Σ_spots g², Σ_cells g²). M, A and dY are
    f32 or bf16; M is only read. ``operands`` are ``dp_operands(A, dY)``
    when the caller has built them for the step already (see
    :func:`_rbar`)."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r)
    if operands is not None:
        _check_operands(operands, A, dY)
    if lib is None:
        return _gsq_plain(M, A, w, m, l, dY, dq, dh, r, lam_l1, lam_l2, with_dh)
    ops = dp_operands(A, dY) if operands is None else operands
    dev = M.device
    nsplit = dp_splits(c, s, _sm_count(M))
    vr_part = torch.empty((nsplit, c), dtype=torch.float32, device=dev)
    # a row of column sums per 32-cell half of each 64-cell block
    vc_part = torch.empty((2 * math.ceil(c / 64), s), dtype=torch.float32, device=dev)
    vr = torch.empty((c,), dtype=torch.float32, device=dev)
    vc = torch.empty((s,), dtype=torch.float32, device=dev)
    if not c:
        return vr, vc.zero_()
    with torch.cuda.device(dev), launch("gsq", M):
        lib.call("tg_gsq_tc", M.data_ptr(), ops.A_op.data_ptr(), ops.dY_op.data_ptr(),
                 w.data_ptr(), dq.data_ptr(), dh.data_ptr(), m.data_ptr(), l.data_ptr(),
                 r.data_ptr(), vr_part.data_ptr(), vc_part.data_ptr(), vr.data_ptr(),
                 vc.data_ptr(), c, s, ops.A_op.shape[1], int(with_dh),
                 *_norm_scalars(lam_l1, lam_l2), vec2_ok(s, vc_part), nsplit, is_bf16(M),
                 int(ops.split), stage_granule(s, M), stream_of(M))
    return vr, vc


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
                        lam_l2, with_norms=False, with_dh=True, rounding="nearest",
                        step=0):
    Mf = M.float()
    P, dP = _dp_plain(Mf, A, w, m, l, dY, dq, dh, with_dh)
    g = _grad_plain(Mf, P, dP, r, lam_l1, lam_l2)
    M_new = Mf - lr * (g * rowf[:, None] * colf[None, :])
    M.copy_(_stored(M_new, M.dtype, rounding, step, 1))
    stats = _rowstats_norms_plain(M) if with_norms else _rowstats_plain(M)
    return (M,) + stats


def _dm_adafactor(M, A, w, m, l, dY, dq, dh, r, rowf, colf, lr: float,
                  lam_l1: float, lam_l2: float, with_norms: bool,
                  with_dh: bool = True, rounding: str = "nearest", step: int = 0,
                  operands: DpOperands | None = None):
    """Adafactor update + next-step row stats in one streamed pass:
    M −= lr · g · rowf[c] · colf[s] **in place**, with no moment matrices,
    M stored in its type (f32 or bf16) as :func:`_dm_adam` stores it.
    Returns ``(M, m', l', u'[, s1', s2'])`` of the stored M. ``operands``
    are ``dp_operands(A, dY)`` when the caller has built them for the step
    already (see :func:`_rbar`)."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh)
    check("r", r, (c, 1))
    check("rowf", rowf, (c,))
    check("colf", colf, (s,))
    sr = _check_rounding(rounding)
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r, rowf, colf)
    if operands is not None:
        _check_operands(operands, A, dY)
    if lib is None:
        return _dm_adafactor_plain(M, A, w, m, l, dY, dq, dh, r, rowf, colf, lr,
                                   lam_l1, lam_l2, with_norms, with_dh, rounding, step)
    ops = dp_operands(A, dY) if operands is None else operands
    nsplit = dp_splits(c, s, _sm_count(M))
    st_part, out, ptrs = _next_stat_buffers(M, nsplit, with_norms)
    if c:
        with torch.cuda.device(M.device), launch("dm_adafactor", M):
            lib.call("tg_dm_adafactor_tc", M.data_ptr(), ops.A_op.data_ptr(),
                     ops.dY_op.data_ptr(), w.data_ptr(), dq.data_ptr(), dh.data_ptr(),
                     m.data_ptr(), l.data_ptr(), r.data_ptr(), rowf.data_ptr(),
                     colf.data_ptr(), st_part.data_ptr(), *ptrs, c, s,
                     ops.A_op.shape[1], int(with_dh), int(with_norms),
                     float(np.float32(lr)), *_norm_scalars(lam_l1, lam_l2),
                     vec2_ok(s, M), nsplit, is_bf16(M), int(sr), step & 0x7FFFFFFF,
                     int(ops.split), stage_granule(s, M), stream_of(M))
    return (M,) + tuple(out)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def init_fused_opt_state(M, moment_dtype=torch.float32):
    """(count, mu, nu) — the fused path's Adam carry; count is a host int,
    mu and nu zeros of ``moment_dtype`` (f32 or bf16: half the state; the
    update still computes in f32)."""
    return (0, torch.zeros(M.shape, dtype=moment_dtype, device=M.device),
            torch.zeros(M.shape, dtype=moment_dtype, device=M.device))


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
    if _needs_norms(lw):
        return tuple(_rowstats_norms(M))
    return tuple(_rowstats(M))


def unconstrained_a_operand(M, data: MapperData, lw: LossWeights,
                            compute_dtype=torch.float32):
    """The A operand of the unconstrained steps' dP tiles, ``dp_operand`` of
    A in ``compute_dtype``. A (the gene-masked S, with the one-hot cell
    types when the island term is on) does not depend on M's values, so a
    training loop builds it once and hands it to every step."""
    A, _ = unconstrained_inputs(M, data, lw)
    return dp_operand(A.to(compute_dtype))


def _unconstrained_cotangents(M, stats, data: MapperData, lw: LossWeights,
                              compute_dtype, A_op=None):
    """Projection forward, epilogue + its gradient, and the rbar pass, with
    A and dY rounded to ``compute_dtype`` before the kernels. Builds the dP
    tiles' operands once for the step (A's from ``A_op`` when given).
    Returns what the update kernels need plus the per-term loss report."""
    A, w = unconstrained_inputs(M, data, lw)
    A = A.to(compute_dtype)
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

    # the epilogue's backward on this thread: on a CUDA device the autograd
    # engine's own thread may free its last buffers after this one resumes,
    # which moves the device's peak memory from run to run
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        Yv, qv, hv = (x.detach().requires_grad_() for x in (Y, q, h))
        total, terms = unconstrained_epilogue(Yv, qv, hv, l1_sum, l2_sum, data, lw)
        dY, dq, dh = torch.autograd.grad(total, (Yv, qv, hv), allow_unused=True)
    # q is unused without a density prior; dh is zero when λ_r = 0.
    # Autograd may hand back expanded (stride-0) gradients: the kernels take
    # contiguous operands.
    dq = torch.zeros_like(q) if dq is None else dq.contiguous()
    dh = torch.zeros_like(h) if dh is None else dh.contiguous()
    dY = dY.contiguous().to(compute_dtype)
    terms = {key: v.detach() for key, v in terms.items()}

    with_dh = lw.lambda_r != 0
    ops = dp_operands(A, dY, A_op)
    r = _rbar(M, A, w, m, l, dY, dq, dh, with_dh=with_dh, operands=ops)
    return A, w, m, l, dY, dq, dh, r, terms, with_dh, need_norms, ops


@torch.no_grad()
def fused_unconstrained_step(M, count: int, mu, nu, stats, data: MapperData,
                             lw: LossWeights, learning_rate: float,
                             compute_dtype=torch.float32, rounding: str = "nearest",
                             A_op=None):
    """One fused Adam step.

    ``stats`` are the carried row stats of M (from :func:`initial_stats` or
    the previous step), so a step makes three streamed passes over M:
    projection, rbar, and backward + Adam (which also emits the next
    stats). M, mu and nu are updated in place, in their own types (f32 or
    bf16), rounded to nearest or stochastically (``rounding``); A and dY go
    to the kernels in ``compute_dtype``. ``A_op`` is
    :func:`unconstrained_a_operand` when the loop has built it already.

    Returns ``(M, count + 1, mu, nu, stats_new, terms)``; ``terms`` are
    0-d tensors on M's device, measured at M before the update.
    """
    A, w, m, l, dY, dq, dh, r, terms, with_dh, need_norms, ops = (
        _unconstrained_cotangents(M, stats, data, lw, compute_dtype, A_op))
    count_new = count + 1
    out = _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu,
                   adam_scalars(count_new, learning_rate), with_dh=with_dh,
                   lam_l1=lw.lambda_l1, lam_l2=lw.lambda_l2, with_norms=need_norms,
                   rounding=rounding, step=count_new, operands=ops)
    M, mu, nu = out[:3]
    return M, count_new, mu, nu, tuple(out[3:]), terms


@torch.no_grad()
def fused_unconstrained_step_adafactor(M, count: int, vr, vc, stats,
                                       data: MapperData, lw: LossWeights,
                                       learning_rate: float,
                                       compute_dtype=torch.float32,
                                       rounding: str = "nearest", A_op=None):
    """One fused Adafactor step: the contract of
    :func:`fused_unconstrained_step` with the (c,) / (s,) f32 factor
    vectors in place of the (c, s) Adam moments. Four streamed passes over
    M: projection, rbar, grad² statistics, and the update (which also emits
    the next stats); M is updated in place, in its own type. rbar, gsq and
    the update take the step's dP operands, built once.

    Returns ``(M, count + 1, vr_new, vc_new, stats_new, terms)``.
    """
    A, w, m, l, dY, dq, dh, r, terms, with_dh, need_norms, ops = (
        _unconstrained_cotangents(M, stats, data, lw, compute_dtype, A_op))
    c, s = M.shape
    vr_sum, vc_sum = _gsq(M, A, w, m, l, dY, dq, dh, r, lw.lambda_l1,
                          lw.lambda_l2, with_dh=with_dh, operands=ops)
    vr_new, vc_new, rowf, colf = factored_rms_vectors(count, vr, vc, vr_sum,
                                                      vc_sum, c, s)
    out = _dm_adafactor(M, A, w, m, l, dY, dq, dh, r, rowf, colf, learning_rate,
                        lw.lambda_l1, lw.lambda_l2, with_norms=need_norms,
                        with_dh=with_dh, rounding=rounding, step=count + 1,
                        operands=ops)
    return out[0], count + 1, vr_new, vc_new, tuple(out[1:]), terms


@torch.no_grad()
def fused_constrained_step(M, F, count: int, mu, nu, muF, nuF, stats,
                           data: MapperData, lw: LossWeights, learning_rate: float,
                           compute_dtype=torch.float32, rounding: str = "nearest"):
    """One fused Adam step of the constrained mapper (M and the filter
    logits F): reference ``MapperConstrained._loss_fn``
    (``mapping_optimizer.py:495-587``), Adam over ``[M, F]`` (``:607``).

    M takes the three streamed passes of :func:`fused_unconstrained_step`
    with A = S ⊙ σ(F) and w = σ(F). Both of F's paths through the core scale
    linearly in w, so its gradient comes from the rbar reduction already
    formed for the softmax VJP, r_c = w_c·(dL/dw_c)|_{A,q} + dh_c·(h_c + 1):

        dL/dF = dF_direct + (1 − w)·(r − dh·(h + 1))

    with dF_direct (the count, filter and density-denominator terms) from
    the epilogue's gradient. M, mu, nu, F, muF and nuF are updated in place;
    ``compute_dtype`` and ``rounding`` apply to M's passes as in
    :func:`fused_unconstrained_step`, while F and its moments stay f32.

    Returns ``((M, F), count + 1, (mu, muF), (nu, nuF), stats_new, terms)``.
    """
    A, w = constrained_inputs(F, data)
    A = A.to(compute_dtype)
    m, l, u = stats
    Y, q = _project(M, A, w, m, l)
    h = (u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])

    # on this thread, as in _unconstrained_cotangents
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        Yv, qv, hsv, Fv = (x.detach().requires_grad_() for x in (Y, q, h.sum(), F))
        total, terms = constrained_epilogue(Yv, qv, hsv, Fv, data, lw)
        dY, dq, dhs, dF_direct = torch.autograd.grad(
            total, (Yv, qv, hsv, Fv), allow_unused=True)
    # q is unused without a density prior; the kernels take contiguous
    # operands, and dh is the scalar cotangent of Σh broadcast over cells
    dq = torch.zeros_like(q) if dq is None else dq.contiguous()
    dY = dY.contiguous().to(compute_dtype)
    dh = dhs.expand(M.shape[0]).contiguous()
    terms = {key: v.detach() for key, v in terms.items()}

    with_dh = lw.lambda_r != 0  # λ_r = 0 ⇒ dh ≡ 0
    # A = S ⊙ σ(F) moves with F, so both operands are built every step, once
    ops = dp_operands(A, dY)
    r = _rbar(M, A, w, m, l, dY, dq, dh, with_dh=with_dh, operands=ops)
    gF = dF_direct + (1.0 - w) * (r[:, 0] - dh * (h + 1.0))

    count_new = count + 1
    scalars = adam_scalars(count_new, learning_rate)
    M, mu, nu, m2, l2, u2 = _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars,
                                     with_dh=with_dh, rounding=rounding,
                                     step=count_new, operands=ops)
    make_adam(learning_rate).update(gF, (count, muF, nuF), F)
    return (M, F), count_new, (mu, muF), (nu, nuF), (m2, l2, u2), terms
