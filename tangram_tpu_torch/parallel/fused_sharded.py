"""Multi-GPU training through the kernels, run shard by shard.

Counterpart of ``tangram_tpu/parallel/fused_sharded.py``. Each rank runs the
port's fused Adam step on its block of M (the rowstats, project, rbar,
dm_adam and rowstats_norms kernels of ``ops/cuda_core.py`` and
``ops/fused_step.py``, their plain twins on CPU tensors) and a handful of
small collectives per step carry what the block cannot see:

* **("cell",)**: every rank holds full rows of M, so the softmax is local;
  Y = PᵀA and q = wP are summed over the cell shards, the entropy h and
  the L1/L2 norms (from the carried row stats) are one scalar sum each.
* **("slice", "cell")**: the same, with every sum over the flattened
  product of the two axes.
* **("cell", "spot")** and **("slice", "cell", "spot")**: M is
  block-sharded over both axes. The row stats are merged over the spot
  shards (a max of m, then sums of l·e^(m−m_g) and u·e^(m−m_g)); Y and q
  are summed over the cells, gathered over the spots and trimmed, so the
  whole single-device epilogue (spot graphs, cell-type islands, the
  constrained terms) runs alike on every rank; its cotangents are sliced
  back to the rank's spots; rbar's r is summed over the spot shards before
  the update, which emits per-shard stats that the next step merges again.

Cells and spots that do not divide the mesh are padded (``mesh.py``), the
padded cells masked out of every sum. The constrained step takes the two F
reductions (Σσ(F), Σσ(F) − σ(F)²) summed over the mesh outside the
epilogue's gradient and rebuilds F's direct gradient by the chain rule.

Stochastic rounding keys each stored row by the step and the row's index
in its block, as the JAX package keys it by the step and the shard-local
tile: the key does not see the global row, so the same rows of two shards
draw the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.mapper import (
    CONSTRAINED_HISTORY_KEYS,
    TERM_KEYS,
    VAL_KEYS,
    _torch_dtype,
)
from ..ops.cuda_core import _project, _rbar, _rowstats, dp_operand, dp_operands
from ..ops.fused_step import (
    _adam_vector,
    _check_rounding,
    _dm_adam,
    _needs_norms,
    adam_scalars,
    initial_stats,
)
from ..ops.losses import (
    LossWeights,
    MapperData,
    constrained_epilogue,
    unconstrained_epilogue,
    val_metrics_from_projection,
)
from ..ops.schedules import resolve_lr
from .mesh import (
    F_PAD_LOGIT,
    _Blocks,
    _data_blocks,
    _Layout,
    all_gather_rows,
    all_max_,
    all_sum_,
)

__all__ = ["fit_mapping_fused_sharded"]


def _merge_rowstats(m_l, l_l, u_l, spot):
    """Per-shard online softmax stats → the row's: the log-sum-exp merge
    the kernels use across tiles, as collectives over the spot shards."""
    if spot.group is None:
        return m_l, l_l, u_l
    m_g = all_max_(m_l.clone(), spot)
    scale = torch.exp(m_l - m_g)
    return m_g, all_sum_(l_l * scale, spot), all_sum_(u_l * scale, spot)


def _total(x, *axes):
    """Σ of ``x`` over this block, then over each axis, as a (1,) tensor."""
    x = torch.sum(x).reshape(1)
    for axis in axes:
        all_sum_(x, axis)
    return x


def _spot_block(x, lay: _Layout):
    """This rank's spots of a full (spots, ...) cotangent, padded."""
    if lay.spot.group is None:
        return x.contiguous()
    return lay._pad(x[lay.cols], 0, lay.s_local, 0.0).contiguous()


class _FusedBlocks(NamedTuple):
    """The fixed inputs of the fused steps: the data blocks, A in the
    compute type with its dP-tile operand (unconstrained: A does not move),
    and the validation blocks."""

    blk: _Blocks
    A: Optional[torch.Tensor]
    A_op: Optional[torch.Tensor]
    val_S: Optional[torch.Tensor]
    val_G: Optional[torch.Tensor]


def _step(M, F, count, mu, nu, muF, nuF, stats, fb: _FusedBlocks, lay: _Layout,
          lw: LossWeights, learning_rate: float, compute_dtype, rounding: str):
    """One fused Adam step on this rank's block: the parameters and moments
    updated in place; returns ``(count + 1, next per-shard stats, terms)``."""
    blk, cvalid = fb.blk, lay.cvalid
    constrained = F is not None
    if constrained:
        w_raw = torch.sigmoid(F)
        w = w_raw * cvalid
        A, A_op = (blk.S * w[:, None]).to(compute_dtype), None
    else:
        w, A, A_op = blk.w, fb.A, fb.A_op
    need_norms = not constrained and _needs_norms(lw)
    l1_sum = l2_sum = None
    if need_norms:
        # padded cells hold zero logits and the kernels skip sentinel pads
        l1_sum = _total(stats[3], lay.cell, lay.spot)[0]
        l2_sum = _total(stats[4], lay.cell, lay.spot)[0]
    m, l, u = _merge_rowstats(*stats[:3], lay.spot)
    Y, q = _project(M, A, w, m, l)
    Y = all_gather_rows(all_sum_(Y, lay.cell), lay.spot)[: lay.n_spots]
    q = all_gather_rows(all_sum_(q, lay.cell), lay.spot)[: lay.n_spots]
    # h = Σ_s P log P = u/l − m − log l
    h = (u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])
    h_sum = _total(h * cvalid, lay.cell)

    with torch.enable_grad():
        if constrained:
            f_sums = (_total(w_raw * cvalid, lay.cell)[0],
                      _total((w_raw - w_raw * w_raw) * cvalid, lay.cell)[0])
            inputs = tuple(x.detach().requires_grad_() for x in (Y, q, h_sum[0]) + f_sums)
            total, terms = constrained_epilogue(*inputs[:3], None, blk.data, lw,
                                                f_sums=inputs[3:])
        else:
            inputs = tuple(x.detach().requires_grad_() for x in (Y, q, h_sum))
            total, terms = unconstrained_epilogue(*inputs, l1_sum, l2_sum, blk.data, lw)
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
    dY, dq, dh = grads[:3]
    # q is unused without a density prior; dh is zero when λ_r = 0
    dY = _spot_block(dY, lay).to(compute_dtype)
    dq = (torch.zeros(lay.s_local, device=lay.device) if dq is None
          else _spot_block(dq, lay))
    dh = (torch.zeros_like(cvalid) if dh is None else dh.reshape(()) * cvalid).contiguous()
    terms = {key: v.detach() for key, v in terms.items()}

    with_dh = lw.lambda_r != 0
    ops = dp_operands(A, dY, A_op)
    r = all_sum_(_rbar(M, A, w, m, l, dY, dq, dh, with_dh=with_dh, operands=ops), lay.spot)
    count_new = count + 1
    scalars = adam_scalars(count_new, learning_rate)
    out = _dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, with_dh=with_dh,
                   lam_l1=0.0 if constrained else lw.lambda_l1,
                   lam_l2=0.0 if constrained else lw.lambda_l2, with_norms=need_norms,
                   rounding=rounding, step=count_new, operands=ops)
    if constrained:
        # F's gradient: its direct part through the two sums by the chain
        # rule, its part through A and q from the rbar pass
        ds1, ds2 = (torch.zeros((), device=lay.device) if g is None else g
                    for g in grads[3:])
        sig_grad = w_raw * (1.0 - w_raw) * cvalid
        dF_direct = ds1 * sig_grad + ds2 * (1.0 - 2.0 * w_raw) * sig_grad
        gF = (dF_direct + (1.0 - w) * (r[:, 0] - dh * (h + 1.0))) * cvalid
        _adam_vector(F, gF, muF, nuF, *scalars)
    return count_new, tuple(out[3:]), terms


def _val_metrics(M, stats, fb: _FusedBlocks, lay: _Layout, compute_dtype):
    """The validation metrics of the post-step M from the step's next
    stats: one more streamed projection, over the validation genes."""
    m, l, u = _merge_rowstats(*stats[:3], lay.spot)
    Y, _ = _project(M, fb.val_S.to(compute_dtype), fb.blk.w, m, l)
    Y = all_gather_rows(all_sum_(Y, lay.cell), lay.spot)[: lay.n_spots]
    h = ((u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])) * lay.cvalid
    h_mean = _total(h, lay.cell)[0] / lay.n_cells
    return val_metrics_from_projection(Y, fb.val_G, h_mean, lay.n_spots)


def _opt_blocks(opt_state, M, F, moment_dtype, lay: _Layout):
    """(count, mu, nu, muF, nuF) on the padded blocks: zeros for a fresh
    run, else this rank's trimmed blocks from ``opt_state`` padded with
    zeros (padded rows never accumulate)."""
    def pad(x, spots=True):
        x = lay._pad(torch.as_tensor(x), 0, lay.c_local, 0.0)
        return lay._pad(x, 1, lay.s_local, 0.0) if spots else x

    if opt_state is None:
        mu = torch.zeros(M.shape, dtype=moment_dtype, device=lay.device)
        F_moments = ((torch.zeros_like(F), torch.zeros_like(F)) if F is not None
                     else (None, None))
        return (0, mu, torch.zeros_like(mu)) + F_moments
    mu, nu = (pad(opt_state[k]).to(moment_dtype).contiguous() for k in ("mu", "nu"))
    F_moments = ((pad(opt_state["muF"], False).float(), pad(opt_state["nuF"], False).float())
                 if F is not None else (None, None))
    return (int(opt_state["count"]), mu, nu) + F_moments


def fit_mapping_fused_sharded(
    params,
    data: MapperData,
    lw: LossWeights,
    num_epochs: int,
    learning_rate,
    mesh=None,
    moment_dtype="float32",
    compute_dtype="float32",
    rounding: str = "nearest",
    opt_state=None,
    return_opt_state=False,
    val_data: MapperData = None,
    val_each=None,
    donate=False,
    step_offset: int = 0,
):
    """Train over a mesh with the fused Adam step on each rank's block.
    Every rank of the mesh calls it with the same arguments.

    ``params`` is the full M (cells/clusters modes) or ``(M, F)``
    (constrained), as tensors or arrays; M trains in its own type (f32 or
    bf16), its moments in ``moment_dtype``, A and dY enter the kernels in
    ``compute_dtype``, and the updates store by ``rounding``, as in the
    single-device fused loop. ``mesh`` is a ``DeviceMesh`` with a ``"cell"``
    (or ``"slice"``) axis and maybe a ``"spot"`` axis, a 1-D ``("cell",)``
    mesh over every rank by default; its device type says where the blocks
    live. ``learning_rate`` is a constant, a per-epoch vector or a
    callable. ``val_data`` with ``val_each`` records the validation metrics
    of the post-step logits every ``val_each`` epochs, counted from the
    absolute epoch ``step_offset`` so that chunked calls keep the cadence.
    ``opt_state`` is a dict of ``count`` and this rank's real blocks of the
    moments, as ``return_opt_state`` hands them back; the row stats are
    recomputed from M, as each single-device call does. ``donate`` has
    nothing to do: the blocks are the fit's own copies, updated in place.

    Returns ``(params, history)`` or ``(params, opt_state, history)``:
    params gathered to the host of every rank, M in its training type;
    history (each key a (num_epochs,) tensor) replicated on every rank.
    """
    from torch.distributed.device_mesh import DeviceMesh

    num_epochs = int(num_epochs)
    learning_rate = resolve_lr(learning_rate, num_epochs)
    constrained = isinstance(params, tuple)
    if constrained and _needs_norms(lw):
        raise NotImplementedError("lambda_l1/lambda_l2 are not part of the constrained loss")
    if val_data is not None and constrained:
        # the reference's _val_loss_fn exists on the unconstrained Mapper
        # only (mapping_optimizer.py:311-356)
        raise NotImplementedError(
            "validation metrics are not defined for the constrained mapper")
    _check_rounding(rounding)
    moment_dtype = _torch_dtype("moment_dtype", moment_dtype)
    compute_dtype = _torch_dtype("compute_dtype", compute_dtype)
    if mesh is None:
        import torch.distributed as dist

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mesh = DeviceMesh(kind, torch.arange(dist.get_world_size()), mesh_dim_names=("cell",))

    M_full = torch.as_tensor(params[0] if constrained else params)
    lay = _Layout(mesh, *M_full.shape)
    M = lay.block(M_full)
    F = (lay.cell_rows(torch.as_tensor(params[1], dtype=torch.float32), F_PAD_LOGIT).clone()
         if constrained else None)
    blk = _data_blocks(data, lw, lay)
    A = A_op = None
    if not constrained:
        A = (blk.S if blk.ct is None else torch.cat([blk.S, blk.ct], dim=1)).to(compute_dtype)
        A_op = dp_operand(A)
    with_val = val_data is not None and val_each is not None
    val_S = val_G = None
    if with_val:
        val_each = int(val_each)
        val_S = lay.cell_rows(torch.as_tensor(val_data.S, dtype=torch.float32))
        val_G = torch.as_tensor(val_data.G, dtype=torch.float32).to(lay.device)
    fb = _FusedBlocks(blk, A, A_op, val_S, val_G)

    count, mu, nu, muF, nuF = _opt_blocks(opt_state, M, F, moment_dtype, lay)
    stats = tuple(_rowstats(M)) if constrained else tuple(initial_stats(M, lw))
    keys = CONSTRAINED_HISTORY_KEYS if constrained else TERM_KEYS
    rows = []
    with torch.no_grad():
        for t in range(num_epochs):
            lr = learning_rate if np.ndim(learning_rate) == 0 else float(learning_rate[t])
            count, stats, terms = _step(M, F, count, mu, nu, muF, nuF, stats, fb, lay, lw,
                                        lr, compute_dtype, rounding)
            row = [terms[k] for k in keys]
            if with_val:
                if (step_offset + t) % val_each == 0:
                    vm = _val_metrics(M, stats, fb, lay, compute_dtype)
                    row += [vm[k] for k in VAL_KEYS]
                else:
                    row += [torch.full((), float("nan"), device=lay.device)] * len(VAL_KEYS)
            rows.append(torch.stack(row))
    names = keys + (VAL_KEYS if with_val else [])
    table = (torch.stack(rows) if rows
             else torch.empty((0, len(names)), device=lay.device))
    history = {k: table[:, i] for i, k in enumerate(names)}
    result = (lay.gather(M), lay.gather(F, spots=False)) if constrained else lay.gather(M)
    if not return_opt_state:
        return result, history
    state = {"count": count, "mu": lay.trim(mu), "nu": lay.trim(nu)}
    if constrained:
        state.update(muF=lay.trim(muF, False), nuF=lay.trim(nuF, False))
    return result, state, history
