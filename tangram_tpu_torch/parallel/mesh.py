"""Multi-GPU training: the mapping problem sharded over a mesh of processes.

Counterpart of ``tangram_tpu/parallel/mesh.py`` on ``torch.distributed``.
Where JAX lays M out over a device mesh and lets GSPMD insert the
collectives, the port runs one process per device (SPMD, as ``torchrun
--nproc-per-node N`` starts them) and writes the collectives out:

* a mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with the
  JAX package's axis names, ``("cell",)``, ``("cell", "spot")``,
  ``("slice", "cell")`` or ``("slice", "cell", "spot")``; cells shard over
  ``"cell"`` (over the ``("slice", "cell")`` product, as one flattened
  group, where both are there), spots over ``"spot"``, and an axis the
  mesh lacks is not split;
* every rank is given the full S, G and M (host or device tensors), as a
  torchrun script would load them, and keeps its block: block ``i`` of an
  axis of n entries over k shards is entries ``[i·b, (i+1)·b)`` of
  b = ceil(n / k), the last blocks short or empty (:class:`Block`); the
  fits pad those blocks to b with rows of zero logits (and filter logits
  of −40) and spot columns of −1e30, which carry no probability, and mask
  every sum to the real extent, as the JAX package pads;
* the fits return the trained parameters gathered to the host of every
  rank (JAX's ``device_get`` of the sharded result), the optimizer state
  as this rank's blocks, and the history replicated on every rank.

:func:`fit_mapping_sharded` is the generic path: the autograd loop on the
rank's block through the materialized core (the JAX package forces its XLA
core there), with the collectives written as autograd functions whose
backward is the true adjoint of the replicated loss (see
:func:`sum_replicated`). The fused path, the kernels run shard by shard, is
:func:`~tangram_tpu_torch.parallel.fused_sharded.fit_mapping_fused_sharded`.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.mapper import (
    CONSTRAINED_HISTORY_KEYS,
    TERM_KEYS,
    VAL_KEYS,
    _adam_vector,
    _check_low_precision,
    _check_optimizer,
    adafactor_vector_update,
    adam_scalars,
    adam_update_low_precision,
)
from ..ops.fused_step import ADAFACTOR_EPS, PAD_GUARD, adafactor_decay
from ..ops.losses import (
    MapperData,
    constrained_epilogue,
    unconstrained_epilogue,
    val_metrics_from_projection,
)
from ..ops.schedules import resolve_lr

__all__ = [
    "make_mesh",
    "mapping_shardings",
    "shard_mapping",
    "fit_mapping_sharded",
    "train_step_sharded",
    "init_distributed",
]

F_PAD_LOGIT = -40.0  # sigmoid(-40) ~ 4e-18: padded filter cells stay off
M_PAD_LOGIT = -1e30  # padded spot columns get exactly zero softmax mass


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None):
    """Start this process's ``torch.distributed`` runtime (the reference
    has no multi-node support at all). Call it once per process, before
    :func:`make_mesh`.

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). ``coordinator_address`` is
    ``"host:port"`` (a TCP rendezvous) or a URL (``"tcp://..."``,
    ``"file://..."``); ``num_processes`` and ``process_id`` default to
    ``WORLD_SIZE`` and ``RANK``, else 1 and 0. ``backend`` is NCCL on the
    card by default, each process bound to GPU ``LOCAL_RANK`` (torchrun)
    or ``process_id`` modulo the GPU count; pass ``"gloo"`` to run the
    processes on the CPU.
    """
    if dist.is_initialized():
        return
    backend = "nccl" if backend is None else backend
    world = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None else int(num_processes)
    rank = int(os.environ.get("RANK", 0)) if process_id is None else int(process_id)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs CUDA; pass backend='gloo' to run "
                               "the processes on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def _factor_2d(n: int) -> tuple[int, int]:
    """Split n devices into the most-square (cell, spot) grid."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def make_mesh(n_cell_shards: Optional[int] = None, n_spot_shards: Optional[int] = None,
              devices=None):
    """A 2-D ``("cell", "spot")`` mesh over the ranks of the process group
    (``devices``: a list of ranks, all of them by default), the most square
    grid unless the shard counts are given. Its device type is ``"cuda"``
    under NCCL and ``"cpu"`` otherwise; the fits hold their blocks on that
    device (the current CUDA device, or the host). Every rank of the group
    calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "init_distributed() first")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    n = len(ranks)
    if n_cell_shards is None and n_spot_shards is None:
        n_cell_shards, n_spot_shards = _factor_2d(n)
    elif n_cell_shards is None:
        n_cell_shards = n // n_spot_shards
    elif n_spot_shards is None:
        n_spot_shards = n // n_cell_shards
    needed = n_cell_shards * n_spot_shards
    if needed > n:
        raise ValueError(f"mesh {n_cell_shards}×{n_spot_shards} needs {needed} devices, "
                         f"only {n} available")
    grid = torch.tensor(ranks[:needed]).reshape(n_cell_shards, n_spot_shards)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, grid, mesh_dim_names=("cell", "spot"))


# ---------------------------------------------------------------------------
# this rank's place on the mesh
# ---------------------------------------------------------------------------


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


def _axis(mesh, names) -> _Axis:
    names = tuple(a for a in names if a in mesh.mesh_dim_names)
    if not names:
        return _Axis(None, Block())
    sub = mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()
    return _Axis(sub.get_group(), Block(sub.get_local_rank(), sub.size()))


#: the axis a mesh lacks: collectives over it do nothing
NO_AXIS = _Axis(None, Block())


def _cell_names(mesh):
    return tuple(a for a in ("slice", "cell") if a in mesh.mesh_dim_names)


class BatchLayout:
    """A batch of whole problems (cross-validation folds, tuner trials) on
    a mesh, laid out as the JAX package lays them out: the batch's leading
    axis over the mesh axis named ``name`` (``"fold"``, ``"trial"``), else
    over the mesh's first axis; each problem's cells over the remaining
    axes, flattened into one group (:attr:`cell`), in contiguous blocks
    without padding when ``n_cells`` divides the group, replicated with
    :func:`~tangram_tpu_torch.utils.warn_tp_replication` (``what`` names the
    logits there) otherwise. ``mesh=None`` splits nothing. Every rank of
    the mesh builds it alike and calls it in the same order.

    ``rows`` are this rank's cells. A batch of n members lies on the batch
    axis only when n divides it (:meth:`part`); :meth:`gather` brings every
    rank's results back in batch order, so that every rank returns the
    same. ``lead`` (the mesh's first rank) alone writes files, and
    :meth:`barrier` holds the others until it has."""

    def __init__(self, mesh, name: str, n_cells: int, what: str):
        self.batch = self.cell = NO_AXIS
        self.every = None
        if mesh is not None:
            names = mesh.mesh_dim_names
            batch = name if name in names else names[0]
            cell_axes = tuple(a for a in names if a != batch)
            self.batch = _axis(mesh, (batch,))
            if cell_axes:
                cell = _axis(mesh, cell_axes)
                if n_cells % cell.block.count == 0:
                    self.cell = cell
                else:
                    from ..utils import warn_tp_replication

                    warn_tp_replication(cell.block.count, cell_axes, n_cells, what=what)
            self.every = _axis(mesh, names)
        self.rows = self.cell.block.slice(n_cells)
        self.lead = self.every is None or self.every.block.index == 0

    def splits(self, n: int) -> bool:
        """Whether a batch of ``n`` lies on the batch axis."""
        return self.batch.group is not None and n % self.batch.block.count == 0

    def part(self, n: int) -> slice:
        """This rank's members of a batch of ``n``: its block of the batch
        axis when the batch lies on it, all of them otherwise."""
        return self.batch.block.slice(n) if self.splits(n) else slice(0, n)

    def gather(self, x, n: int):
        """The batch's rows of ``x`` (this rank's :meth:`part` of a batch
        of ``n`` along dim 0) from every rank, in batch order."""
        return all_gather_rows(x, self.batch) if self.splits(n) else x

    def barrier(self):
        if self.every is not None:
            dist.barrier(group=self.every.group)


def mapping_shardings(mesh):
    """(M's, MapperData's) split of each axis over ``mesh`` for this rank,
    the counterpart of the JAX package's ``NamedSharding`` pair: a
    :class:`Block` for an axis that is split and ``None`` for one that is
    not. M's rows split over the cells (the ``("slice", "cell")`` product
    where both are there) and its columns over ``"spot"``; S, d_source and
    ct_encode by cells, G, d, the spot graphs and the autocorrelation
    references by spots, the gene-axis leaves not at all. An axis the mesh
    lacks splits nothing."""
    cell = _axis(mesh, _cell_names(mesh)).block
    spot = _axis(mesh, ("spot",)).block
    cell = cell if cell.count > 1 or "cell" in mesh.mesh_dim_names else None
    spot = spot if "spot" in mesh.mesh_dim_names else None
    data = MapperData(
        S=(cell, None), G=(spot, None), gene_mask=(None,), d=(spot,),
        d_source=(cell,), voxel_weights=(spot, None), neighborhood_filter=(spot, None),
        ct_encode=(cell, None), spatial_weights=(spot, None), getis_ord_ref=(spot, None),
        moran_ref=(spot, None), geary_ref=(None,), target_count=(),
    )
    return (cell, spot), data


def _take(x, blocks):
    """This rank's block of ``x`` (a tensor, an array or a NeighborGraph,
    whose arrays split by rows)."""
    if x is None:
        return None
    if hasattr(x, "_fields"):  # a NeighborGraph: its rows
        return type(x)(*(_take(v, blocks[:1]) for v in x))
    index = tuple(slice(None) if b is None else b.slice(x.shape[i])
                  for i, b in enumerate(blocks))
    return x[index]


def shard_mapping(params, data: MapperData, mesh):
    """This rank's blocks of the parameters and of every populated
    MapperData leaf (views of tensors, slices of arrays, on their own
    device). ``params`` is M (unconstrained) or ``(M, F)`` (constrained):
    M by :func:`mapping_shardings`, the per-cell filter F by cells."""
    m_split, data_split = mapping_shardings(mesh)
    if isinstance(params, tuple):
        M, F = params
        params = (_take(M, m_split), _take(F, m_split[:1]))
    else:
        params = _take(params, m_split)
    data = MapperData(*(_take(v, split) for v, split in zip(tuple(data), tuple(data_split))))
    return params, data


class _Layout:
    """The padded blocks of the (cells × spots) problem on this rank: the
    cell axis (cells pad to ``c_pad``, blocks of ``c_local``) and the spot
    axis (``s_pad``, ``s_local``), with the 1/0 masks of real cells and
    spots. ``device`` is where the blocks live: the current CUDA device of a
    ``"cuda"`` mesh, the host otherwise."""

    def __init__(self, mesh, n_cells: int, n_spots: int):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a torch.distributed DeviceMesh "
                            f"(tangram_tpu_torch.parallel.make_mesh), not "
                            f"{type(mesh).__name__}")
        names = mesh.mesh_dim_names
        if "cell" not in names and "spot" not in names:
            raise ValueError(f"a mapping mesh names its axes among ('slice', 'cell', "
                             f"'spot'); got {names}")
        self.mesh = mesh
        self.cell = _axis(mesh, _cell_names(mesh))
        # one spot shard is the 1-D layout, as the JAX package routes it
        self.spot = _axis(mesh, ("spot",))
        if self.spot.block.count == 1:
            self.spot = _Axis(None, Block())
        self.n_cells, self.n_spots = n_cells, n_spots
        self.c_local = self.cell.block.width(n_cells)
        self.s_local = self.spot.block.width(n_spots)
        self.c_pad = self.c_local * self.cell.block.count
        self.s_pad = self.s_local * self.spot.block.count
        self.rows = self.cell.block.slice(n_cells)
        self.cols = self.spot.block.slice(n_spots)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))
        f32 = dict(dtype=torch.float32, device=self.device)
        self.cvalid = torch.zeros(self.c_local, **f32)
        self.cvalid[: self.rows.stop - self.rows.start] = 1.0
        self.svalid = torch.zeros(self.s_local, **f32)
        self.svalid[: self.cols.stop - self.cols.start] = 1.0

    # blocks of full arrays, padded to the block widths
    def cell_rows(self, x, value=0.0):
        """Rows ``rows`` of ``x`` (cells first) on the device, padded."""
        return self._pad(torch.as_tensor(x)[self.rows], 0, self.c_local, value).contiguous()

    def block(self, M, dtype=None):
        """This rank's (c_local, s_local) block of M, a fresh tensor."""
        M = torch.as_tensor(M)[self.rows, self.cols]
        M = self._pad(M, 0, self.c_local, 0.0)
        return self._pad(M, 1, self.s_local, M_PAD_LOGIT).to(dtype or M.dtype).clone()

    def _pad(self, x, axis, target, value):
        x = x.to(self.device)
        if x.shape[axis] == target:
            return x
        shape = list(x.shape)
        shape[axis] = target - x.shape[axis]
        return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], axis)

    def trim(self, x, spots=True):
        """The real rows (and columns) of a padded block."""
        x = x[: self.rows.stop - self.rows.start]
        return x[:, : self.cols.stop - self.cols.start] if spots else x

    def gather(self, block, spots=True):
        """The full array of every rank's real block, on the host of every
        rank: each block broadcast from its owner in turn over the mesh, so
        the device holds one block beside its own."""
        names = tuple(a for a in ("slice", "cell", "spot") if a in self.mesh.mesh_dim_names)
        every = _axis(self.mesh, names)
        shape = (self.n_cells, self.n_spots) if spots else (self.n_cells,)
        out = torch.empty(shape, dtype=block.dtype)
        mine = self.trim(block, spots).contiguous()
        # the mesh in row-major order: (cell shards..., spot shards)
        ranks = self.mesh.mesh.reshape(self.cell.block.count, -1)
        for ci in range(self.cell.block.count):
            for sj in range(ranks.shape[1] if spots else 1):
                rows = Block(ci, self.cell.block.count).slice(self.n_cells)
                cols = Block(sj, self.spot.block.count).slice(self.n_spots)
                size = (rows.stop - rows.start, cols.stop - cols.start)[: 2 if spots else 1]
                if 0 in size:
                    continue
                src = int(ranks[ci, sj])
                buf = mine if src == dist.get_rank() else torch.empty(
                    size, dtype=block.dtype, device=self.device)
                if every.group is not None:
                    dist.broadcast(buf, src=src, group=every.group)
                region = (rows, cols) if spots else (rows,)
                out[region] = buf.cpu()
        return out


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


# ---------------------------------------------------------------------------
# the generic path: autograd through the materialized core on the block
# ---------------------------------------------------------------------------


def _sharded_core(M, A, w, lay: _Layout):
    """(Y (s_pad, k), q (s_pad,), Σ h) of the materialized core on this
    rank's block, differentiable in M, A and w: the softmax over spots with
    its max and sum taken over the spot shards, Y = PᵀA and q = wP summed
    over the cell shards and gathered over the spot shards, h = Σ P log P
    summed over both, padded cells masked."""
    M = M.float()
    m = M.detach().amax(dim=1, keepdim=True)
    all_max_(m, lay.spot)
    e = torch.exp(M - m)
    l = local_copy(sum_replicated(e.sum(dim=1, keepdim=True), lay.spot), lay.spot)
    P = e / l
    # log-softmax form: no log(P) of an underflowed P
    h = sum_replicated(torch.sum(P * (M - m - torch.log(l)), dim=1), lay.spot)
    h_sum = sum_replicated(torch.sum(h * lay.cvalid), lay.cell)
    Y = gather_replicated(sum_replicated(P.T @ A, lay.cell), lay.spot)
    q = gather_replicated(sum_replicated(w @ P, lay.cell), lay.spot)
    return Y, q, h_sum


def _replicated_data(data: MapperData, device, with_ct: bool) -> MapperData:
    """The data every rank's epilogue reads whole, on ``device``: S and
    ct_encode as (1, width) stubs (the epilogue reads their widths; the
    blocks carry the values), d_source dropped (w carries it)."""
    def move(x):
        if x is None:
            return None
        return x.to(device) if hasattr(x, "to") else torch.as_tensor(x).to(device)

    S = torch.as_tensor(data.S)
    ct = None if not with_ct else torch.zeros((1, data.ct_encode.shape[1]))
    return MapperData(*(move(v) for v in data._replace(
        S=torch.zeros((1, S.shape[1]), dtype=S.dtype), ct_encode=ct, d_source=None)))


def _norm_sums(M, lay: _Layout, l1: bool, l2: bool):
    """Σ|M| and ΣM² over the mesh (``None`` where off), sentinel pads
    excluded, differentiable, replicated."""
    z = torch.where(M > PAD_GUARD, M, torch.zeros_like(M))

    def total(x):
        return sum_replicated(sum_replicated(x, lay.cell), lay.spot)

    return (total(torch.sum(torch.abs(z))) if l1 else None,
            total(torch.sum(z * z)) if l2 else None)


class _Blocks(NamedTuple):
    """The fixed blocks of one fit: A's rows (gene-masked S, the one-hot
    cell types appended with the island term), w's, and the replicated
    data."""

    S: torch.Tensor
    ct: Optional[torch.Tensor]
    w: torch.Tensor
    data: MapperData


def _data_blocks(data: MapperData, lw, lay: _Layout) -> _Blocks:
    S = lay.cell_rows(torch.as_tensor(data.S, dtype=torch.float32))
    if data.gene_mask is not None:
        S = S * torch.as_tensor(data.gene_mask).to(S.device)[None, :]
    with_ct = lw.lambda_ct_islands > 0 and data.ct_encode is not None
    ct = lay.cell_rows(torch.as_tensor(data.ct_encode, dtype=torch.float32)) if with_ct else None
    if data.d_source is not None:
        w = lay.cell_rows(torch.as_tensor(data.d_source, dtype=torch.float32))
    else:
        w = lay.cvalid / lay.n_cells
    return _Blocks(S, ct, w, _replicated_data(data, lay.device, with_ct))


def _sharded_loss(params, blk: _Blocks, lw, lay: _Layout, constrained: bool):
    if constrained:
        M, F = params
        # F is replicated over the spot shards: its path through P sums
        # over them, its direct sums are the same on each
        w = torch.sigmoid(local_copy(F, lay.spot)) * lay.cvalid
        Y, q, h_sum = _sharded_core(M, blk.S * w[:, None], w, lay)
        w_raw = torch.sigmoid(F) * lay.cvalid
        f_sums = (sum_replicated(torch.sum(w_raw), lay.cell),
                  sum_replicated(torch.sum(w_raw - w_raw * w_raw), lay.cell))
        return constrained_epilogue(Y[: lay.n_spots], q[: lay.n_spots], h_sum, None,
                                    blk.data, lw, f_sums=f_sums)
    M = params
    A = blk.S if blk.ct is None else torch.cat([blk.S, blk.ct], dim=1)
    Y, q, h_sum = _sharded_core(M, A, blk.w, lay)
    l1, l2 = _norm_sums(M, lay, lw.lambda_l1 != 0, lw.lambda_l2 != 0)
    return unconstrained_epilogue(Y[: lay.n_spots], q[: lay.n_spots], h_sum.reshape(1),
                                  l1, l2, blk.data, lw)


def _sharded_val_metrics(M, val_S, val_G, gene_mask, lay: _Layout):
    """``val_metrics`` of the mesh's M from this rank's block."""
    S = lay.cell_rows(torch.as_tensor(val_S, dtype=torch.float32))
    G = torch.as_tensor(val_G, dtype=torch.float32).to(lay.device)
    if gene_mask is not None:
        gene_mask = torch.as_tensor(gene_mask).to(lay.device)
        S, G = S * gene_mask[None, :], G * gene_mask[None, :]
    Y, _, h_sum = _sharded_core(M, S, lay.cvalid / lay.n_cells, lay)
    return val_metrics_from_projection(Y[: lay.n_spots], G, h_sum / lay.n_cells,
                                       lay.n_spots, gene_mask=gene_mask)


def _sharded_adafactor_update(M, g, count: int, vr, vc, learning_rate: float,
                              lay: _Layout):
    """:func:`~tangram_tpu_torch.models.mapper.adafactor_update` on this
    rank's block: the row and column means of g² summed over the spot and
    cell shards and taken over the real spots and cells, the normalizing
    mean over the real cells or spots, in M's type as there."""
    dt = M.dtype
    decay, one_minus = adafactor_decay(count)
    valid = lay.cvalid[:, None] * lay.svalid[None, :]
    grad_sqr = (g * g + torch.tensor(ADAFACTOR_EPS, dtype=dt)).float() * valid
    row = all_sum_(grad_sqr.sum(dim=1), lay.spot) / lay.n_spots
    col = all_sum_(grad_sqr.sum(dim=0), lay.cell) / lay.n_cells
    vr = (decay * vr.float() + one_minus * row.to(dt).float()).to(dt)
    vc = (decay * vc.float() + one_minus * col.to(dt).float()).to(dt)
    # padded rows and columns have g = 0: a unit statistic keeps their factor finite
    vr_f = torch.where(lay.cvalid > 0, vr, torch.ones_like(vr))
    vc_f = torch.where(lay.svalid > 0, vc, torch.ones_like(vc))

    def mean(v, valid, axis, n):
        return (all_sum_((v.float() * valid).sum(), axis) / n).to(dt)

    if lay.n_spots >= lay.n_cells:
        rowf = (vr_f / mean(vr_f, lay.cvalid, lay.cell, lay.n_cells)) ** -0.5
        u = g * rowf[:, None] * (vc_f ** -0.5)[None, :]
    else:
        colf = (vc_f / mean(vc_f, lay.svalid, lay.spot, lay.n_spots)) ** -0.5
        u = g * colf[None, :] * (vr_f ** -0.5)[:, None]
    M.sub_(torch.tensor(float(np.float32(learning_rate)), dtype=dt) * u)
    return vr, vc


_GENERIC_OPTIONS = ("optimizer", "constrained", "with_val", "val_data", "val_each",
                    "step_offset", "opt_state", "return_opt_state", "impl", "donate",
                    "fused", "moment_dtype", "compute_dtype", "param_dtype", "rounding")


def fit_mapping_sharded(params, data: MapperData, lw, num_epochs: int,
                        learning_rate: float, mesh=None, **kwargs):
    """:func:`~tangram_tpu_torch.models.mapper.fit_mapping`'s autograd loop
    on this rank's block of a mesh (the counterpart of the JAX package's
    GSPMD path): the materialized core with the softmax, projection and
    entropy reductions summed over the shards, the loss epilogue replicated
    on every rank, the optimizer on the block (Adam, or Adafactor with its
    factored statistics summed over the shards). Every rank of the mesh
    calls it with the same arguments.

    ``params`` is the full M, or ``(M, F)`` with ``constrained=True``, as
    tensors or arrays; ``kwargs`` are ``fit_mapping``'s: ``optimizer``,
    ``constrained``, ``with_val``, ``val_data``, ``val_each``,
    ``step_offset``, ``opt_state`` (this rank's blocks, as a previous call
    returned them) and ``return_opt_state``; ``impl`` must name the
    materialized core (``"auto"``, ``"reference"``, or JAX's ``"xla"``);
    the low-precision options act on the fused loops only, as there, and
    ``donate`` has nothing to do (the blocks are the fit's own copies).
    Returns ``(params, history)`` or ``(params, opt_state, history)``:
    params gathered to the host of every rank in M's type, the history
    replicated on the blocks' device.
    """
    unknown = set(kwargs) - set(_GENERIC_OPTIONS)
    if unknown:
        raise TypeError(f"fit_mapping_sharded got unexpected options {sorted(unknown)}")
    optimizer = _check_optimizer(kwargs.get("optimizer", "adam"))
    constrained = bool(kwargs.get("constrained", False))
    impl = kwargs.get("impl", "auto")
    if impl not in ("auto", "reference", "xla"):
        raise ValueError(f"fit_mapping_sharded runs the materialized core (impl='auto', "
                         f"'reference' or 'xla'), not impl={impl!r}; the kernels run "
                         "shard by shard in fit_mapping_fused_sharded")
    rounding = kwargs.get("rounding", "nearest")
    if rounding == "stochastic":
        raise ValueError("rounding='stochastic' is implemented in the fused sharded "
                         "step (a mesh with a 'cell' axis); the generic sharded path "
                         "stores round-to-nearest.")
    _check_low_precision(rounding, kwargs.get("param_dtype", "float32"),
                         kwargs.get("moment_dtype", "float32"))
    with_val = bool(kwargs.get("with_val", False))
    val_data = data if kwargs.get("val_data") is None else kwargs["val_data"]
    val_each = int(kwargs.get("val_each", 1))
    step_offset = int(kwargs.get("step_offset", 0))
    if mesh is None:
        mesh = make_mesh()
    num_epochs = int(num_epochs)
    learning_rate = resolve_lr(learning_rate, num_epochs)

    M_full = torch.as_tensor(params[0] if constrained else params)
    lay = _Layout(mesh, *M_full.shape)
    M = lay.block(M_full)
    F = lay.cell_rows(torch.as_tensor(params[1]), F_PAD_LOGIT).clone() if constrained else None
    blk = _data_blocks(data, lw, lay)
    leaves = (M, F) if constrained else (M,)
    opt_state = _generic_state(kwargs.get("opt_state"), leaves, optimizer, constrained, lay)

    keys = CONSTRAINED_HISTORY_KEYS if constrained else TERM_KEYS
    rows = []
    count = opt_state[0]
    for t in range(num_epochs):
        with torch.enable_grad():
            req = tuple(p.detach().requires_grad_() for p in leaves)
            total, terms = _sharded_loss(req if constrained else req[0], blk, lw, lay,
                                         constrained)
            grads = torch.autograd.grad(total, req)
        lr = learning_rate if np.ndim(learning_rate) == 0 else float(learning_rate[t])
        with torch.no_grad():
            if optimizer == "adam":
                for p, g, mu, nu in zip(leaves, grads, *opt_state[1:]):
                    if p.dtype == torch.float32:
                        _adam_vector(p, g, mu, nu, *adam_scalars(count + 1, lr))
                    else:
                        adam_update_low_precision(p, g, mu, nu, count + 1, lr)
            else:
                state = _sharded_adafactor_update(M, grads[0], count, *opt_state[1:3], lr,
                                                  lay)
                if constrained:
                    state += (adafactor_vector_update(F, grads[1], count, opt_state[3], lr),)
                opt_state = (count,) + state
            count += 1
            opt_state = (count,) + tuple(opt_state[1:])
            row = [terms[k].detach() for k in keys]
            if with_val:
                if (step_offset + t) % val_each == 0:
                    vm = _sharded_val_metrics(M, val_data.S, val_data.G, val_data.gene_mask,
                                              lay)
                    row += [vm[k] for k in VAL_KEYS]
                else:
                    row += [torch.full((), float("nan"), device=lay.device)] * len(VAL_KEYS)
            rows.append(torch.stack(row))
    names = keys + (VAL_KEYS if with_val else [])
    table = (torch.stack(rows) if rows
             else torch.empty((0, len(names)), device=lay.device))
    history = {k: table[:, i] for i, k in enumerate(names)}
    out = ((lay.gather(M), lay.gather(F, spots=False)) if constrained
           else lay.gather(M))
    if kwargs.get("return_opt_state", False):
        return out, _trimmed_state(opt_state, optimizer, constrained, lay), history
    return out, history


def _generic_state(state, leaves, optimizer: str, constrained: bool, lay: _Layout):
    """The autograd carry on the padded blocks: fresh (moments in each
    parameter's type, as optax's init makes them), or this rank's trimmed
    blocks as a previous call returned them, padded with zeros. Adam's is
    ``(count, mus, nus)`` with one moment per parameter."""
    M = leaves[0]

    def pad(x, like, spots=True):
        x = lay._pad(x, 0, lay.c_local, 0.0)
        return (lay._pad(x, 1, lay.s_local, 0.0) if spots else x).to(like.dtype)

    if optimizer == "adam":
        if state is None:
            return (0, tuple(torch.zeros_like(p) for p in leaves),
                    tuple(torch.zeros_like(p) for p in leaves))
        count, mu, nu = state
        mus, nus = (mu, nu) if constrained else ((mu,), (nu,))
        return (int(count), tuple(pad(m, p, p.dim() == 2) for m, p in zip(mus, leaves)),
                tuple(pad(n, p, p.dim() == 2) for n, p in zip(nus, leaves)))
    if state is None:
        fresh = (0, torch.zeros(lay.c_local, dtype=M.dtype, device=lay.device),
                 torch.zeros(lay.s_local, dtype=M.dtype, device=lay.device))
        return fresh + ((torch.zeros_like(leaves[1]),) if constrained else ())
    vr = pad(state[1], M, spots=False)
    vc = lay._pad(state[2], 0, lay.s_local, 0.0).to(M.dtype)
    extra = (pad(state[3], leaves[1], spots=False),) if constrained else ()
    return (int(state[0]), vr, vc) + extra


def _trimmed_state(state, optimizer: str, constrained: bool, lay: _Layout):
    """The carry as this rank's real blocks, in the port's autograd-loop
    layout (Adam ``(count, mu, nu)``, constrained with (M, F) pairs)."""
    count = state[0]
    if optimizer == "adam":
        mus = tuple(lay.trim(x, x.dim() == 2) for x in state[1])
        nus = tuple(lay.trim(x, x.dim() == 2) for x in state[2])
        return (count, mus, nus) if constrained else (count, mus[0], nus[0])
    vc = state[2][: lay.cols.stop - lay.cols.start]
    extra = (lay.trim(state[3], False),) if constrained else ()
    return (count, lay.trim(state[1], False), vc) + extra


def train_step_sharded(M, data: MapperData, lw, learning_rate: float, mesh):
    """One sharded Adam step (for harness dry-runs and step benchmarks)."""
    return fit_mapping_sharded(M, data, lw, 1, learning_rate, mesh=mesh)
