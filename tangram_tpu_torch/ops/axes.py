"""The axes of a mesh as the steps see them, and the collectives over them.

A fit on a mesh (``tangram_tpu_torch.parallel``) hands the steps the axis
its cells are sharded over and the axis its spots are sharded over; a fit
on one device hands them :data:`NO_AXIS` for both. Every collective here
does nothing over an axis without a process group, so one step serves both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["Block", "NO_AXIS", "all_sum_", "all_max_", "all_gather_rows",
           "sum_replicated", "local_copy", "gather_replicated"]


class Block(NamedTuple):
    """This rank's share of one array axis: block ``index`` of ``count``
    blocks of ceil(n / count) entries, the last ones short or empty."""

    index: int = 0
    count: int = 1

    def width(self, n: int) -> int:
        return -(-n // self.count)

    def slice(self, n: int) -> slice:
        b = self.width(n)
        return slice(min(self.index * b, n), min((self.index + 1) * b, n))


class _Axis(NamedTuple):
    """One mesh axis (or the flattened product of axes): its process group
    (None where the mesh lacks the axis) and this rank's block of it."""

    group: object
    block: Block


#: the axis a mesh lacks: collectives over it do nothing
NO_AXIS = _Axis(None, Block())


# ---------------------------------------------------------------------------
# collectives: in place on values, and as autograd functions
# ---------------------------------------------------------------------------


def all_sum_(x, axis: _Axis):
    """Sum ``x`` over the axis in place (nothing where the mesh lacks it)."""
    if axis.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


def all_max_(x, axis: _Axis):
    if axis.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis.group)
    return x


def all_gather_rows(x, axis: _Axis):
    """Every rank's ``x`` of the axis stacked along dim 0 in rank order."""
    if axis.group is None:
        return x
    out = torch.empty((axis.block.count * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=axis.group)
    return out


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_sum_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _LocalCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum_(g.clone(), ctx.axis), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return all_gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        i = ctx.axis.block.index
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def sum_replicated(x, axis: _Axis):
    """Σ over the axis of each rank's ``x``, for a loss that every rank
    computes alike from the sum: the true adjoint passes the replicated
    cotangent through to each rank's part. (An all-reduce of the cotangent
    as well, as ``torch.distributed.nn.functional.all_reduce`` does,
    scales every gradient by the group's size.)"""
    return x if axis.group is None else _SumReplicated.apply(x, axis)


def local_copy(x, axis: _Axis):
    """``x``, replicated over the axis, entering a computation that each
    rank does on its own shard: its gradient is the sum over the axis of
    every shard's part."""
    return x if axis.group is None else _LocalCopy.apply(x, axis)


def gather_replicated(x, axis: _Axis):
    """Every rank's rows of the axis stacked in rank order, for a loss
    that every rank computes alike: the adjoint takes this rank's rows of
    the replicated cotangent."""
    return x if axis.group is None else _GatherReplicated.apply(x, axis)
