"""The core's kernels: row stats, the projection, the softmax-VJP row
reduction and the unfused backward, and :class:`MapperCore` around them.

Counterpart of ``tangram_tpu/ops/pallas_core.py`` (``_rowstats``,
``_project``, ``_backward`` and the ``mapper_core_pallas`` custom VJP) and
of ``tangram_tpu/ops/fused_step.py::_rbar``. Each wrapper takes the JAX
function's arguments and returns its outputs in the same shapes. On a CUDA tensor it launches the
hand-written kernel from ``csrc/`` (the row stats from ``mapper_kernels.cu``;
rbar at K depths up to 256 from ``dp_wgmma_kernels.cu``, the persistent
warpgroup-MMA dP tile, deeper rbar and the unfused backward's second pass
from ``dp_tensor_kernels.cu``, the ``mma.sync`` dP tile (:func:`dp_route`);
the projection from ``project_tc_kernels.cu``, on the tensor cores too)
(and counts the launch in :data:`LAUNCHES`, and while a
:func:`~tangram_tpu_torch.profiling.record_phases` recording is active
times it on the card in :data:`DEVICE_SECONDS`); on a CPU tensor it runs the
plain PyTorch twin that sits beside it. There is no other path: a CUDA
launch that fails raises.

The kernels never pad the gene axis (the JAX package pads k to 128 lanes
for the TPU); they mask ragged tiles themselves.

M may be stored in bf16 (the JAX package's ``param_dtype``), and A and dY
may come rounded to bf16 (its ``compute_dtype``): the kernels read them
in their type and compute in f32, as the JAX kernels do. The unfused
backward (``_backward``, ``MapperCore``'s gradient) takes an f32 or bf16 M
with f32 A and dY, and returns dM in M's type, as ``pallas_core._backward``.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import NamedTuple

import torch

from .. import profiling

__all__ = ["LAUNCHES", "DEVICE_SECONDS", "reset_launches", "device_seconds", "kernels_for",
           "MapperCore", "_rowstats", "rowstats_load_bytes", "_project", "_rbar", "_backward",
           "tf32_split", "DpOperands", "dp_operand", "dp_operands", "backward_operands",
           "project_operand", "project_tf32_plain", "dm_backward_tf32_plain",
           "ext_product_tf32_plain", "dp_route", "wgmma_splits", "wgmma_operand",
           "wgmma_operand_plain", "wgmma_operand_rows"]

#: the kernels with a bf16 variant: a launch on bf16 storage (M, mu or nu;
#: A for project) counts as ``name + ".bf16"``
BF16_KERNELS = ("rowstats", "project", "rbar", "dm_adam", "rowstats_norms", "gsq",
                "dm_adafactor", "backward_rbar", "dm_backward", "init_normal", "dp_wgmma")

#: launches of each kernel since the last :func:`reset_launches`;
#: ``backward_rbar`` counts the rbar kernel when :func:`_backward` runs it,
#: ``init_normal`` the two passes of a seeded start drawn on the card
#: (``ops/init_draw.py``); ``dp_wgmma`` counts, beside its role's own
#: count (``rbar``, ``backward_rbar``), each launch that
#: :func:`dp_route` sends to the warpgroup-MMA kernel, with the role's key
#: suffix (untimed: the role's :data:`DEVICE_SECONDS` time the launch).
#: With a graph term on, ``graph`` counts the fused step's spot-graph
#: products in its loss epilogue, forward and VJP (untimed;
#: ``ops.fused_step._epilogue_span``)
LAUNCHES = dict.fromkeys(
    ["rowstats", "project", "rbar", "dm_adam", "rowstats_norms", "gsq",
     "dm_adafactor", "backward_rbar", "dm_backward", "init_normal", "dp_wgmma",
     "graph"]
    + [name + ".bf16" for name in BF16_KERNELS], 0)

F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)


#: card seconds of each kernel's launches since the last
#: :func:`reset_launches`, keyed as :data:`LAUNCHES`: a wrapper's whole
#: launch sequence (the kernel with its merge or reduction) between two
#: timing events on its stream, timed while a
#: :func:`~tangram_tpu_torch.profiling.record_phases` recording is active.
#: Launches finish on the card after the host moves on: read the totals
#: with :func:`device_seconds`. ``epilogue`` is no launch: the fused
#: step's loss epilogue with a graph term on, forward and backward, the
#: stream's time between two events around it (:func:`timed`), the host's
#: gaps in issuing its small launches included.
DEVICE_SECONDS = dict.fromkeys([*LAUNCHES, "epilogue"], 0.0)

#: (key, start event, end event, device) of the timed launches not yet
#: added to DEVICE_SECONDS, oldest first
_PENDING: collections.deque = collections.deque()
#: event pairs of added launches, for reuse, by device
_FREE_EVENTS: dict = {}


def reset_launches() -> None:
    """Zero :data:`LAUNCHES` and :data:`DEVICE_SECONDS`, and drop the timed
    launches not yet added."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in DEVICE_SECONDS:
        DEVICE_SECONDS[name] = 0.0
    _PENDING.clear()


def launch_key(name: str, *storage: torch.Tensor) -> str:
    """``name``, or ``name.bf16`` when any of the ``storage`` tensors is
    bf16: the key of a launch in :data:`LAUNCHES`."""
    return name + ".bf16" if any(t.dtype == torch.bfloat16 for t in storage) else name


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


def _add_finished(all_pending: bool) -> None:
    """Add the card time of each timed launch whose end event has passed
    to :data:`DEVICE_SECONDS`, oldest first, stopping at the first one
    still running unless ``all_pending``. Queries events; never waits."""
    running = []
    while _PENDING:
        item = _PENDING.popleft()
        key, start, end, device = item
        if end.query():
            DEVICE_SECONDS[key] += start.elapsed_time(end) / 1e3
            _FREE_EVENTS.setdefault(device, []).append((start, end))
        elif all_pending:
            running.append(item)
        else:
            _PENDING.appendleft(item)
            break
    _PENDING.extend(running)


def device_seconds() -> dict:
    """:data:`DEVICE_SECONDS` with every timed launch that the card has
    finished added, as a new dict. It does not wait: a launch still running
    counts at a later call, so call it after a synchronize for the totals
    of a finished run."""
    _add_finished(all_pending=True)
    return dict(DEVICE_SECONDS)


@contextlib.contextmanager
def timed(key: str, like: torch.Tensor):
    """While a recording is active, brackets the body with two timing
    events on the current stream of ``like``'s CUDA device, taken from a
    pool of reused pairs, whose time goes to :data:`DEVICE_SECONDS`
    ``[key]``; the timed spans that have finished by then are added
    first. Else nothing."""
    if not profiling.recording():
        yield
        return
    _add_finished(all_pending=False)
    device = like.device
    free = _FREE_EVENTS.get(device)
    start, end = free.pop() if free else (_timing_event(), _timing_event())
    start.record()
    yield
    end.record()
    _PENDING.append((key, start, end, device))


@contextlib.contextmanager
def launch(name: str, *storage: torch.Tensor):
    """One launch of kernel ``name`` on the card: the body makes the
    kernel library's call, inside the wrapper's device guard. Counts it
    in :data:`LAUNCHES` under :func:`launch_key` once the call returns,
    and while a recording is active :func:`timed` brackets the call."""
    key = launch_key(name, *storage)
    with timed(key, storage[0]):
        yield
    LAUNCHES[key] += 1


def is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def kernels_for(*tensors: torch.Tensor):
    """The kernel library when every tensor is on one CUDA device, ``None``
    when every tensor is on the CPU; raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from ._build import load_kernels

    return load_kernels()


def check(name: str, t: torch.Tensor, shape: tuple, dtypes=F32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and one of
    ``dtypes`` (f32 by default) — what the kernels take. The wrappers check
    CPU tensors too, so the CPU tests hold callers to the same contract."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def vec2_ok(s: int, *tensors: torch.Tensor) -> int:
    """1 when the tensor-core dP tile may access 2 entries at once along
    spots of each (c, s) tensor: s even and each base aligned to 2 entries
    (8 bytes in f32, 4 in bf16)."""
    return int(s % 2 == 0
               and all(t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors))


# ---------------------------------------------------------------------------
# row stats
# ---------------------------------------------------------------------------


def _rowstats_plain(M):
    """Per-cell m = max, l = Σ exp(M − m), u = Σ exp(M − m)·M, each (c, 1)
    f32, from M read as f32."""
    M = M.float()
    m = M.amax(dim=1, keepdim=True)
    e = torch.exp(M - m)
    return m, e.sum(dim=1, keepdim=True), (e * M).sum(dim=1, keepdim=True)


def rowstats_load_bytes(M) -> int:
    """Bytes per load of the row-stats kernels' stream along M's rows:
    :func:`stage_granule` (16, 8 or 4: what divides a row's length in bytes
    and M's base), or for a bf16 M with an odd row length 2, one entry at a
    time. The tutorial shape's 9,852 spots take 16 in f32 and 8 in bf16."""
    return stage_granule(M.shape[1], M) or M.element_size()


def _rowstats(M):
    """Softmax row stats of M (c, s), f32 or bf16 → (m, l, u), each (c, 1)
    f32."""
    c, s = M.shape
    check("M", M, (c, s), F32_BF16)
    lib = kernels_for(M)
    if lib is None:
        return _rowstats_plain(M)
    m, l, u = (torch.empty((c, 1), dtype=torch.float32, device=M.device)
               for _ in range(3))
    if c:
        with torch.cuda.device(M.device), launch("rowstats", M):
            lib.call("tg_rowstats", M.data_ptr(), m.data_ptr(), l.data_ptr(),
                     u.data_ptr(), c, s, is_bf16(M), rowstats_load_bytes(M),
                     stream_of(M))
    return m, l, u


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

_PJ_SPOTS = 64    # spots per block of the project kernel
_PJ_COLS = 256    # columns of [A | w] per block
_PJ_CELLS = 16    # cells per chunk (one fresh tensor-core accumulator)
# what a block pays once, whatever its share of the cells (filling its copy
# ring, writing its partial), in chunks
_PJ_BLOCK_OVERHEAD = 4


def project_splits(c: int, s: int, k: int, sm_count: int) -> int:
    """How many contiguous cell ranges the project kernel reduces over in
    parallel (grid.z). One block is resident per SM and the blocks of a
    launch run in waves of sm_count, so the split is the one with the least
    estimated time, waves × (chunks of 16 cells per block + the block's
    fixed cost), the fewest splits on a tie: 6 at the tutorial shape (154
    spot tiles × 6 = 924 blocks, exactly 7 waves of 132), 1 for clusters
    mode's few cells, whose 154 spot tiles fill the card alone."""
    base = math.ceil(s / _PJ_SPOTS) * math.ceil((k + 1) / _PJ_COLS)
    chunks = max(1, math.ceil(c / _PJ_CELLS))
    best, best_cost = 1, math.inf
    for n in range(1, min(chunks, 4 * sm_count) + 1):
        per = math.ceil(chunks / n)
        if math.ceil(chunks / per) != n:  # the same blocks as a smaller n
            continue
        cost = math.ceil(base * n / sm_count) * (per + _PJ_BLOCK_OVERHEAD)
        if cost < best_cost:
            best, best_cost = n, cost
    return best


def _rows_of_8(A):
    """A bf16 A (c, k) as the project kernel copies it, 16 bytes at a time:
    its rows padded with zeros to a multiple of 8 entries (a bf16 copy, as
    the JAX package pads k for the TPU), and that row stride."""
    c, k = A.shape
    k8 = -(-k // 8) * 8
    if k8 == k and A.data_ptr() % 16 == 0:
        return A, k
    A8 = torch.zeros((c, k8), dtype=A.dtype, device=A.device)
    A8[:, :k] = A
    return A8, k8


def project_operand(A, w):
    """The X operand of the project kernel and its row stride: for an f32 A,
    [A | w] (c, ldx) f32 with ldx = k + 1 rounded up to a multiple of 4 and
    zeros beyond column k (16-byte rows, what the kernel's asynchronous
    copies take); for a bf16 A, A's rows padded to 8 entries
    (:func:`_rows_of_8`), w apart, since q = wP takes the f32 P. Built per
    call: a copy of 26.6 MB at the tutorial shape, 0.02 ms of HBM traffic
    against the kernel's milliseconds."""
    c, k = A.shape
    if A.dtype == torch.bfloat16:
        return _rows_of_8(A)
    ldx = -(-(k + 1) // 4) * 4
    X = torch.zeros((c, ldx), dtype=torch.float32, device=A.device)
    X[:, :k] = A
    X[:, k] = w
    return X, ldx


def _project_p(M, m, l):
    return torch.exp(M.float() - m) * (1.0 / l)


def _project_plain(M, A, w, m, l):
    P = _project_p(M, m, l)
    # Y = PᵀA takes P in A's type (JAX's P.astype(A.dtype)); q = wP the f32 P
    PA = P.to(A.dtype).float() if A.dtype != torch.float32 else P
    return PA.T @ A.float(), w @ P


def project_tf32_plain(M, A, w, m, l, terms: int = 3):
    """(Y, q) of an f32 A as the tensor-core project kernel forms them: the
    product Pᵀ [A | w] of the TF32 parts of P and of X = [A | w]
    (:func:`tf32_product_plain`: ``lo·hi + hi·lo + hi·hi``, the small terms
    first, f32 accumulation), split into its first k columns and its last;
    ``terms=1`` is the single TF32 pass, which loses f32 accuracy."""
    X = _ext(A, w)
    Y_ext = tf32_product_plain(_project_p(M, m, l).T.contiguous(), X.T.contiguous(), terms)
    return Y_ext[:, :-1], Y_ext[:, -1]


def project_rounding_slack(M, A, m, l, window: int = 16):
    """(s, k): how far Y = bf16(P)ᵀ A may move when P is formed by another
    exp (the kernel's, JAX's) a few f32 ulps away. An entry of P within
    ``window`` f32 ulps of a bf16 rounding midpoint may round to either
    neighbour, one bf16 ulp apart, so Y moves by at most Σ_c (that ulp)·|A|
    over those entries. The measure for checking Y of a bf16 A beside
    summation order."""
    P = torch.exp(M.float() - m) * (1.0 / l)
    bits = P.view(torch.int32)
    near = ((bits & 0xFFFF) - 0x8000).abs() <= window
    ulp = (bits & 0x7F800000).view(torch.float32) * 2.0 ** -7
    return (near * ulp).T @ A.float().abs()


def _project(M, A, w, m, l):
    """Y = Pᵀ A (s, k) and q = w P (s,), with P = exp(M − m)/l recomputed
    from the row stats; P is never stored. M and A are f32 or bf16; with a
    bf16 A, Y takes P rounded to bf16 (f32 accumulation) and q the f32 P,
    as ``pallas_core._project_kernel``."""
    c, s = M.shape
    k = A.shape[1]
    check("M", M, (c, s), F32_BF16)
    check("A", A, (c, k), F32_BF16)
    check("w", w, (c,))
    check("m", m, (c, 1))
    check("l", l, (c, 1))
    lib = kernels_for(M, A, w, m, l)
    if lib is None:
        return _project_plain(M, A, w, m, l)
    dev = M.device
    nsplit = project_splits(c, s, k, _sm_count(M))
    partial = torch.empty((nsplit, s, k + 1), dtype=torch.float32, device=dev)
    Y = torch.empty((s, k), dtype=torch.float32, device=dev)
    q = torch.empty((s,), dtype=torch.float32, device=dev)
    X, ldx = project_operand(A, w)
    # the kernel copies w, m and l 16 bytes at a time
    w, m, l = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (w, m, l))
    if s:
        with torch.cuda.device(dev), launch("project", M, A):
            lib.call("tg_project", M.data_ptr(), X.data_ptr(), w.data_ptr(),
                     m.data_ptr(), l.data_ptr(), partial.data_ptr(), Y.data_ptr(),
                     q.data_ptr(), c, s, k, ldx, nsplit, is_bf16(M), is_bf16(A),
                     stage_granule(s, M), stream_of(M))
    return Y, q


# ---------------------------------------------------------------------------
# dP tiles: what the rbar, update and backward kernels share
# ---------------------------------------------------------------------------


_TC_CELLS = 64     # cells per block of the tensor-core dP tile
_TC_SPOTS = 128    # spots per tile
_TC_K = 32         # the operands' K is padded to a multiple of this
_TC_BLOCKS_PER_SM = 1
# what a block pays once, whatever its share of the spot tiles (the copy of
# its resident A panel, the final reduction), in spot tiles
_TC_BLOCK_OVERHEAD = 0.5


def dp_splits(c: int, s: int, sm_count: int) -> int:
    """How many blocks share the 128-spot tiles of one 64-cell group in the
    tensor-core dP-tile kernels (rbar, gsq, dm_adam, dm_adafactor,
    dm_backward).
    One block is resident per SM, and the blocks of a launch run in waves
    of sm_count; 407 cell
    groups alone (the tutorial shape) fill 3.08 waves and leave most of the
    fourth idle. So the split is the one with the least estimated time,
    waves × (tiles per block + the block's fixed cost), the fewest blocks
    on a tie: 7 at the tutorial shape (11 tiles each, 21.6 waves), one tile
    per block for clusters mode's one cell group."""
    groups, tiles = math.ceil(c / _TC_CELLS), math.ceil(s / _TC_SPOTS)
    slots = _TC_BLOCKS_PER_SM * sm_count
    best, best_cost = 1, math.inf
    for n in range(1, tiles + 1):
        per = math.ceil(tiles / n)
        if math.ceil(tiles / per) != n:  # the same blocks as a smaller n
            continue
        cost = math.ceil(groups * n / slots) * (per + _TC_BLOCK_OVERHEAD)
        if cost < best_cost:
            best, best_cost = n, cost
    return best


def _sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _ext(X, v):
    """[X | v] (n, k + 1), contiguous."""
    return torch.cat([X, v[:, None]], dim=1)


def _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh):
    """Materialized P and dP = A dYᵀ + w ⊗ dq [+ dh ⊙ (log P + 1)], all f32
    (M, A and dY read as f32: a bf16 A times a bf16 dY is exact in f32)."""
    M = M.float()
    P = torch.exp(M - m) * (1.0 / l)
    dP = A.float() @ dY.float().T + w[:, None] * dq[None, :]
    if with_dh:
        dP = dP + dh[:, None] * ((M - m - torch.log(l)) + 1.0)
    return P, dP


def _check_dp_args(M, A, w, m, l, dY, dq, dh, dtypes=F32_BF16):
    """Shapes and types of the dP-tile kernels' shared inputs: M f32 or
    bf16, A and dY of ``dtypes``, the vectors f32."""
    c, s = M.shape
    k = A.shape[1]
    for name, t, shape, types in (("M", M, (c, s), F32_BF16), ("A", A, (c, k), dtypes),
                                  ("w", w, (c,), F32), ("m", m, (c, 1), F32),
                                  ("l", l, (c, 1), F32), ("dY", dY, (s, k), dtypes),
                                  ("dq", dq, (s,), F32), ("dh", dh, (c,), F32)):
        check(name, t, shape, types)
    return c, s, k


# ---------------------------------------------------------------------------
# the tensor-core dP tile (rbar, gsq, the updates, dm_backward): 3×TF32 and
# its operands
# ---------------------------------------------------------------------------


def tf32_split(x):
    """``(hi, lo)`` of an f32 tensor: ``hi`` is x rounded to TF32 (10
    mantissa bits: round to nearest on the 13 dropped bits, ties away from
    zero, as the card's ``cvt.rna.tf32.f32``; truncated instead where
    rounding up would overflow) and ``lo`` is x − hi (exact in f32) rounded
    the same way. Both have 13 zero low bits; hi + lo is within 2⁻²¹ of x
    relative to x, and lo is 0 for a bf16-representable x. By integer
    arithmetic on the bits, the same on the CPU and the card. The plain
    version of the split inside the kernel, which forms hi by Veltkamp's
    product on the FMA pipes (ties to even) and leaves lo's last bit to the
    tensor core's truncation: the same hi up to ties, the same accuracy."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {x.dtype}")

    def round_tf32(v):
        bits = v.contiguous().view(torch.int32)
        up = (bits + 0x1000) & ~0x1FFF
        overflow = (up & 0x7F800000) == 0x7F800000
        return torch.where(overflow, bits & ~0x1FFF, up).view(torch.float32)

    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def tf32_product_plain(A, dY, terms: int = 3):
    """A dYᵀ as the tensor-core tile forms it from f32 operands: the sum of
    ``lo·hi + hi·lo + hi·hi`` of their :func:`tf32_split` parts (the small
    terms first), each product with f32 accumulation; ``terms=1`` is the
    single TF32 pass ``hi·hi``, which loses f32 accuracy."""
    a_hi, a_lo = tf32_split(A)
    d_hi, d_lo = tf32_split(dY)
    if terms == 1:
        return a_hi @ d_hi.T
    return (a_lo @ d_hi.T + a_hi @ d_lo.T) + a_hi @ d_hi.T


def dp_operand(X, depth: int | None = None):
    """A contraction operand of the tensor-core dP tile: X (n, k), f32 or
    bf16, as a contiguous f32 (n, Kp) array, K-major, its columns padded
    with zeros to Kp, the first multiple of 32 at or past ``depth`` (k by
    default; rows of 128 bytes: what the kernel's 16-byte asynchronous
    copies and its K chunks of 32 take). A bf16 X keeps its values, which
    are exact in TF32."""
    n, k = X.shape
    depth = k if depth is None else depth
    Kp = max(_TC_K, -(-depth // _TC_K) * _TC_K)
    op = torch.zeros((n, Kp), dtype=torch.float32, device=X.device)
    op[:, :k] = X
    return op


# the warpgroup-MMA dP tile (dp_wgmma_kernels.cu)
_WG_CELLS = 64    # cells per group: wgmma's M
_WG_SPOTS = 64    # spots per tile: wgmma's N
_WG_KMAX = 256    # deepest K of its resident A panel
#: the roles whose dP tile the warpgroup-MMA kernel forms
WGMMA_ROLES = ("rbar", "backward_rbar")
# what a unit (a 64-cell group's run of spot tiles) pays once, whatever its
# tiles (its partial rows; at a new group the A panel), in tiles
_WG_UNIT_OVERHEAD = 0.5


def dp_route(role: str, Kp: int, c: int, a_dtype, dy_dtype) -> str:
    """The kernel that forms a launch's dP tile: ``"wgmma.tf32"`` (the
    persistent warpgroup-MMA kernel of ``dp_wgmma_kernels.cu``, 3×TF32 on
    f32 operands), ``"wgmma.bf16"`` (the same on bf16 operands: A and dY
    both bf16, one exact product) or ``"tile"`` (``dp_tensor_kernels.cu``).
    The warpgroup kernel takes rbar (``"rbar"``, ``"backward_rbar"``) while
    the operands' depth Kp fits its resident panel (256) and there is a
    cell to map; deeper K (the island term's one-hot types past 256 genes)
    walks panels on the tile, and dm_adam, gsq, dm_adafactor and
    dm_backward stay there (an Adam epilogue on the warpgroup kernel
    measured slower than the tile's; ``dp_wgmma_kernels.cu``)."""
    if role not in WGMMA_ROLES or not 0 < Kp <= _WG_KMAX or c < 1:
        return "tile"
    both_bf16 = a_dtype == torch.bfloat16 and dy_dtype == torch.bfloat16
    return "wgmma.bf16" if both_bf16 else "wgmma.tf32"


def wgmma_splits(c: int, s: int, sm_count: int) -> tuple[int, int]:
    """(nsplit, blocks) of the warpgroup-MMA kernel: each 64-cell group's
    64-spot tiles are cut into ``nsplit`` runs (units), and ``blocks``
    persistent blocks, one per SM at most, take contiguous ranges of the
    units; a block's two warpgroups take its tiles in turn. The split is
    the one with the least estimated time, units per block × (tiles per
    unit + a unit's fixed cost), the fewest splits on a tie: 7 at the
    tutorial shape (22 tiles a unit, 2,891 units, 22 a block)."""
    groups, tiles = math.ceil(c / _WG_CELLS), math.ceil(s / _WG_SPOTS)
    best, best_cost = 1, math.inf
    for n in range(1, max(tiles, 1) + 1):
        per = math.ceil(tiles / n) if tiles else 0
        if tiles and math.ceil(tiles / per) != n:  # the same units as a smaller n
            continue
        cost = math.ceil(groups * n / sm_count) * (per + _WG_UNIT_OVERHEAD)
        if cost < best_cost:
            best, best_cost = n, cost
    return best, max(1, min(sm_count, groups * best))


def _wg_perm(split: bool):
    """(32,) the column of a 32-wide K chunk that the kernel's logical K
    index holds: the order in which one 16-byte load of a row gives a
    thread its A fragment of two k8 steps (f32) or two k16 steps (bf16)."""
    L = torch.arange(32)
    kk = L >> 4
    if split:
        ks, j = (L >> 3) & 1, L & 7
        return 8 * (j & 3) + 4 * kk + 2 * ks + (j >> 2)
    kl = L & 15
    return 8 * ((kl & 7) >> 1) + 4 * kk + 2 * (kl >> 3) + (kl & 1)


def wgmma_operand_plain(X, Kp: int, split: bool):
    """X (n, k) as the warpgroup-MMA kernel's dY stages, in plain PyTorch:
    rows padded with zeros to a multiple of 64 and columns to Kp, each
    32-wide chunk's columns in :func:`_wg_perm`'s order, then per (64-row
    tile, chunk) stage wgmma's K-major layout without swizzle: 8 × 16-byte
    core matrices, K-major between them, then rows. ``split``: f32 stages of
    :func:`tf32_split`'s hi then lo, (T, C, 2, 8, 8, 8, 4); else bf16,
    (T, C, 4, 8, 8, 8), of a bf16 X's exact values."""
    n, k = X.shape
    T, C = -(-n // _WG_SPOTS), Kp // _TC_K
    if Kp % _TC_K or k > Kp:
        raise ValueError(f"depth {Kp} does not take {k} columns in chunks of {_TC_K}")
    dtype = torch.float32 if split else torch.bfloat16
    pad = torch.zeros((T * _WG_SPOTS, Kp), dtype=dtype, device=X.device)
    pad[:n, :k] = X
    cols = (torch.arange(C)[:, None] * _TC_K + _wg_perm(split)[None, :]).reshape(-1)
    logical = pad[:, cols.to(X.device)]
    if split:
        parts = tf32_split(logical)
        # (T, n8, r, C, kc, e) -> (T, C, kc, n8, r, e)
        return torch.stack([p.reshape(T, 8, 8, C, 8, 4).permute(0, 3, 4, 1, 2, 5)
                            for p in parts], dim=2).contiguous()
    return logical.reshape(T, 8, 8, C, 4, 8).permute(0, 3, 4, 1, 2, 5).contiguous()


def wgmma_operand_rows(tiles, n: int, split: bool):
    """The inverse of :func:`wgmma_operand_plain`: the (n, Kp) rows of the
    columns in their own order (with ``split``, ``(hi, lo)``)."""
    T, C = tiles.shape[:2]
    inverse = torch.argsort(_wg_perm(split))
    cols = (torch.arange(C)[:, None] * _TC_K + inverse[None, :]).reshape(-1)

    def rows(part):
        logical = part.permute(0, 3, 4, 1, 2, 5).reshape(T * _WG_SPOTS, C * _TC_K)
        return logical[:, cols.to(tiles.device)][:n]

    if split:
        return rows(tiles[:, :, 0]), rows(tiles[:, :, 1])
    return rows(tiles)


def wgmma_operand(X, Kp: int, split: bool):
    """dY's stages for the warpgroup-MMA kernel (:func:`wgmma_operand_plain`'s
    layout), once per step: on a CUDA tensor one launch of
    ``tg_dp_wgmma_operand``, on the CPU the plain version. X (n, k) is f32
    or bf16 (bf16 when not ``split``), its rows contiguous."""
    lib = kernels_for(X)
    if lib is None:
        return wgmma_operand_plain(X, Kp, split)
    n, k = X.shape
    if not split and X.dtype != torch.bfloat16:
        raise TypeError("the bf16 product takes a bf16 dY")
    check("X", X, (n, k), F32_BF16)
    T, C = -(-n // _WG_SPOTS), Kp // _TC_K
    shape = (T, C, 2, 8, 8, 8, 4) if split else (T, C, 4, 8, 8, 8)
    out = torch.empty(shape, dtype=torch.float32 if split else torch.bfloat16,
                      device=X.device)
    with torch.cuda.device(X.device):
        lib.call("tg_dp_wgmma_operand", X.data_ptr(), out.data_ptr(), is_bf16(X), n, k, k,
                 Kp, int(split), stream_of(X))
    return out


class DpOperands(NamedTuple):
    """The contraction operands of dP = A dYᵀ for the tensor-core tiles:
    ``A_op`` (c, Kp) and ``dY_op`` (s, Kp) from :func:`dp_operand`;
    ``split``: whether the tiles take three TF32 products of their split
    parts (f32 inputs) or one product (both inputs bf16: exact); ``ext``:
    whether ``dY_op`` is [dY | dq] with ``A_op`` 0 in column k
    (:func:`backward_operands`, what dm_backward's second product takes);
    ``dY_tiles``: dY's stages for the warpgroup-MMA kernel
    (:func:`wgmma_operand`), or ``None`` where rbar does not go there (and
    on the CPU)."""

    A_op: torch.Tensor
    dY_op: torch.Tensor
    split: bool
    ext: bool = False
    dY_tiles: torch.Tensor | None = None


def dp_operands(A, dY, A_op=None) -> DpOperands:
    """The operands of one step's dP tiles, built once for the rbar, gsq
    and update kernels: ``dY_op`` for the ``mma.sync`` tile and, on a CUDA
    device where rbar goes to the warpgroup-MMA kernel (:func:`dp_route`),
    ``dY_tiles``. ``A_op`` is ``dp_operand(A)`` when the caller has it
    already (A does not change between the steps of an unconstrained
    fit)."""
    split = not (A.dtype == torch.bfloat16 and dY.dtype == torch.bfloat16)
    A_op = dp_operand(A) if A_op is None else A_op
    Kp = A_op.shape[1]
    route = dp_route("rbar", Kp, A.shape[0], A.dtype, dY.dtype)
    on_card = kernels_for(A_op, dY) is not None
    tiles = wgmma_operand(dY, Kp, split) if on_card and route != "tile" else None
    return DpOperands(A_op, dp_operand(dY), split, dY_tiles=tiles)


def backward_operands(A, dY, dq) -> DpOperands:
    """The operands of the unfused backward's two kernels, built once per
    backward: ``A_op`` = A and ``dY_op`` = [dY | dq], both f32 and padded
    with zeros to a depth past k (column k of ``A_op`` is 0, so the dP
    product ignores dq there; dm_backward's second product P [dY | dq]
    takes it), and on a CUDA device, when its rbar pass goes to the
    warpgroup-MMA kernel, ``dY_tiles`` of ``dY_op``. Always the split product: the backward's A
    and dY are f32."""
    k = A.shape[1]
    A_op, dY_op = dp_operand(A, k + 1), dp_operand(_ext(dY.float(), dq), k + 1)
    Kp = A_op.shape[1]
    route = dp_route("backward_rbar", Kp, A.shape[0], A.dtype, dY.dtype)
    on_card = kernels_for(dY_op) is not None
    tiles = wgmma_operand(dY_op, Kp, True) if on_card and route != "tile" else None
    return DpOperands(A_op, dY_op, True, True, tiles)


def dp_from_operands_plain(ops: DpOperands, w, dq):
    """dP = A dYᵀ + w ⊗ dq from the kernel's operands, as the tensor-core
    tiles compute it (the split products, then the rank-one term in f32);
    from ``dY_tiles`` when ``dY_op`` is ``None``."""
    s = dq.shape[0]
    if ops.dY_op is not None:
        dY_op = ops.dY_op
        product = (tf32_product_plain(ops.A_op, dY_op) if ops.split
                   else ops.A_op @ dY_op.T)
    elif ops.split:
        hi, lo = wgmma_operand_rows(ops.dY_tiles, s, True)
        a_hi, a_lo = tf32_split(ops.A_op)
        product = (a_lo @ hi.T + a_hi @ lo.T) + a_hi @ hi.T
    else:
        product = ops.A_op @ wgmma_operand_rows(ops.dY_tiles, s, False).float().T
    return product + w[:, None] * dq[None, :]


def _check_operands(ops: DpOperands, A, dY) -> int:
    """Raise unless ``ops`` fits A (c, k) and dY (s, k); returns Kp."""
    Kp = ops.A_op.shape[1]
    if Kp % _TC_K or Kp < A.shape[1]:
        raise ValueError(f"operands of depth {Kp} do not fit k = {A.shape[1]}")
    check("A_op", ops.A_op, (A.shape[0], Kp))
    if ops.dY_op is not None:
        check("dY_op", ops.dY_op, (dY.shape[0], Kp))
        if ops.dY_op.data_ptr() % 16:
            raise ValueError("the dP operands must be 16-byte aligned")
    if ops.dY_tiles is not None:
        T, C = -(-dY.shape[0] // _WG_SPOTS), Kp // _TC_K
        shape = (T, C, 2, 8, 8, 8, 4) if ops.split else (T, C, 4, 8, 8, 8)
        check("dY_tiles", ops.dY_tiles, shape,
              F32 if ops.split else (torch.bfloat16,))
        if ops.dY_tiles.data_ptr() % 16:
            raise ValueError("the dP operands must be 16-byte aligned")
    if ops.A_op.data_ptr() % 16:
        raise ValueError("the dP operands must be 16-byte aligned")
    return Kp


def stage_granule(s: int, t: torch.Tensor) -> int:
    """Bytes per asynchronous copy by which the tensor-core tile stages the
    rows of ``t`` (c, s) in shared memory: the largest of 16, 8 and 4 that
    divides a row's length in bytes and the base address; 0 when there is
    none (a bf16 array with an odd s), which the kernel copies entry by
    entry."""
    row_bytes = s * t.element_size()
    return next((g for g in (16, 8, 4) if row_bytes % g == 0 and t.data_ptr() % g == 0), 0)


# ---------------------------------------------------------------------------
# rbar
# ---------------------------------------------------------------------------


def _rbar_plain(M, A, w, m, l, dY, dq, dh, with_dh=True):
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    return (P * dP).sum(dim=1, keepdim=True)


def _rbar(M, A, w, m, l, dY, dq, dh, with_dh: bool = True, counter: str = "rbar",
          operands: DpOperands | None = None):
    """r_c = Σ_s P ⊙ dP (c, 1): the row reduction of the softmax VJP.
    ``with_dh=False`` drops the entropy cotangent path (λ_r = 0). A launch
    counts in ``LAUNCHES[counter]`` (``counter + ".bf16"`` with a bf16 M):
    ``"rbar"`` in the fused steps, ``"backward_rbar"`` as the first pass of
    :func:`_backward` (A and dY f32 there); :func:`dp_route` picks the
    kernel. ``operands`` are
    ``dp_operands(A, dY)`` (or :func:`backward_operands`) when the caller
    has built them already; the kernel reads A and dY from them (the CPU
    twin from A and dY themselves)."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh,
                             F32_BF16 if counter == "rbar" else F32)
    lib = kernels_for(M, A, w, m, l, dY, dq, dh)
    if operands is not None:
        _check_operands(operands, A, dY)
    if lib is None:
        return _rbar_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    ops = dp_operands(A, dY) if operands is None else operands
    Kp = ops.A_op.shape[1]
    route = dp_route(counter, Kp, c, A.dtype, dY.dtype)
    r = torch.empty((c, 1), dtype=torch.float32, device=M.device)
    if not c:
        return r
    common = (w.data_ptr(), dq.data_ptr(), dh.data_ptr(), m.data_ptr(), l.data_ptr())
    if route == "tile":
        nsplit = dp_splits(c, s, _sm_count(M))
        r_part = torch.empty((nsplit, c), dtype=torch.float32, device=M.device)
        with torch.cuda.device(M.device), launch(counter, M):
            lib.call("tg_rbar", M.data_ptr(), ops.A_op.data_ptr(),
                     ops.dY_op.data_ptr(), *common, r_part.data_ptr(),
                     r.data_ptr(), c, s, Kp, int(with_dh), vec2_ok(s, M), nsplit,
                     is_bf16(M), int(ops.split), stage_granule(s, M), stream_of(M))
        return r
    nsplit, blocks = wgmma_splits(c, s, _sm_count(M))
    if ops.dY_tiles is None:
        raise ValueError("these dP operands hold no dY stages for the warpgroup-MMA kernel")
    r_part = torch.empty((2 * nsplit, c), dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device), launch(counter, M):
        lib.call("tg_rbar_wgmma", M.data_ptr(), ops.A_op.data_ptr(), ops.dY_tiles.data_ptr(),
                 *common, r_part.data_ptr(), r.data_ptr(), c, s, Kp, int(with_dh),
                 vec2_ok(s, M), nsplit, blocks, is_bf16(M), int(ops.split), stream_of(M))
        LAUNCHES[launch_key("dp_wgmma", M)] += 1
    return r


# ---------------------------------------------------------------------------
# the unfused backward: dM, dA, dw
# ---------------------------------------------------------------------------


def _dm_backward_plain(M, A, w, m, l, dY, dq, dh, r, with_dh=True):
    P, dP = _dp_plain(M, A, w, m, l, dY, dq, dh, with_dh)
    return (P * (dP - r)).to(M.dtype), P @ dY, P @ dq


def ext_product_tf32_plain(P, dY, dq, terms: int = 3):
    """(dA, dw) = P [dY | dq] as the dm_backward kernel's second product
    forms it: :func:`tf32_product_plain` of P (c, s) and [dY | dq] over the
    spot axis; ``terms=1`` is the single TF32 pass, which loses f32
    accuracy."""
    out = tf32_product_plain(P, _ext(dY, dq).T.contiguous(), terms)
    return out[:, :-1], out[:, -1]


def dm_backward_tf32_plain(M, A, w, m, l, dY, dq, dh, r, with_dh=True, terms: int = 3):
    """(dM, dA, dw) as the dm_backward kernel forms them: dP from the TF32
    parts of A and dY plus w ⊗ dq in f32, then [dA | dw] from the TF32
    parts of P and [dY | dq] (:func:`ext_product_tf32_plain`), dM in M's
    type; ``terms=1`` takes a single TF32 pass in both products."""
    Mf = M.float()
    P = torch.exp(Mf - m) * (1.0 / l)
    dP = tf32_product_plain(A, dY, terms) + w[:, None] * dq[None, :]
    if with_dh:
        dP = dP + dh[:, None] * ((Mf - m - torch.log(l)) + 1.0)
    dA, dw = ext_product_tf32_plain(P, dY, dq, terms)
    return (P * (dP - r)).to(M.dtype), dA, dw


def _dm_backward(M, A, w, m, l, dY, dq, dh, r, with_dh: bool = True,
                 operands: DpOperands | None = None):
    """The softmax VJP through the core, given ``r`` from :func:`_rbar`
    with the same ``dh``: dM = P ⊙ (dP − r) (c, s) in M's type (f32 or
    bf16, rounded to nearest, as ``pallas_core._dm_kernel``), dA = P dY
    (c, k) and dw = P dq (c,) in f32. P and dP are formed tile by tile and
    never stored. A and dY are f32. ``operands`` are
    :func:`backward_operands` when the caller has built them already (the
    kernel reads A, dY and dq's copy from them)."""
    c, s, k = _check_dp_args(M, A, w, m, l, dY, dq, dh, F32)
    check("r", r, (c, 1))
    lib = kernels_for(M, A, w, m, l, dY, dq, dh, r)
    if operands is not None:
        _check_operands(operands, A, dY)
        if not operands.ext or operands.A_op.shape[1] <= k:
            raise ValueError("dm_backward takes backward_operands(A, dY, dq)")
    if lib is None:
        return _dm_backward_plain(M, A, w, m, l, dY, dq, dh, r, with_dh)
    dev = M.device
    ops = backward_operands(A, dY, dq) if operands is None else operands
    nsplit = dp_splits(c, s, _sm_count(M))
    dM = torch.empty_like(M)
    ext_part = torch.empty((nsplit, c, k + 1), dtype=torch.float32, device=dev)
    dA = torch.empty((c, k), dtype=torch.float32, device=dev)
    dw = torch.empty((c,), dtype=torch.float32, device=dev)
    if c:
        with torch.cuda.device(dev), launch("dm_backward", M):
            lib.call("tg_dm_backward_tc", M.data_ptr(), ops.A_op.data_ptr(),
                     ops.dY_op.data_ptr(), w.data_ptr(), dq.data_ptr(), dh.data_ptr(),
                     m.data_ptr(), l.data_ptr(), r.data_ptr(), dM.data_ptr(),
                     ext_part.data_ptr(), dA.data_ptr(), dw.data_ptr(), c, s, k,
                     ops.A_op.shape[1], int(with_dh), vec2_ok(s, dM), nsplit, is_bf16(M),
                     stage_granule(s, M), stream_of(M))
    return dM, dA, dw


def _backward(M, A, w, m, l, dY, dq, dh, with_dh: bool = True):
    """The VJP of the core (Y, q, h) → (dM, dA, dw) in two streamed
    passes, as ``pallas_core._backward``: the rbar kernel (counted as
    ``backward_rbar``), then the dm_backward kernel, both on the operands
    of :func:`backward_operands`, built once. M is f32 or bf16 (dM comes
    back in its type), A and dY f32. ``with_dh=False`` is for a backward
    where h had no cotangent at all."""
    _check_dp_args(M, A, w, m, l, dY, dq, dh, F32)
    ops = backward_operands(A, dY, dq)
    r = _rbar(M, A, w, m, l, dY, dq, dh, with_dh=with_dh, counter="backward_rbar",
              operands=ops)
    return _dm_backward(M, A, w, m, l, dY, dq, dh, r, with_dh=with_dh, operands=ops)


def _forward_parts(M, A, w):
    m, l, u = _rowstats(M)
    Y, q = _project(M, A, w, m, l)
    # h = Σ_s P log P = u/l − m − log l
    h = (u[:, 0] / l[:, 0]) - m[:, 0] - torch.log(l[:, 0])
    return Y, q, h, m, l


class MapperCore(torch.autograd.Function):
    """(Y, q, h) = mapper_core(M, A, w) through the kernels, with the
    streamed :func:`_backward` as its VJP: the counterpart of
    ``mapper_core_pallas``. The forward runs the rowstats and project
    kernels and saves M, A, w and the row stats (never P); on CPU tensors
    every wrapper runs its twin. Inputs are contiguous; A and w f32, M f32
    or bf16 (the validation metrics of bf16 storage, and a bf16 M's
    gradient, which comes back in bf16 as ``mapper_core_pallas`` gives
    it)."""

    @staticmethod
    def forward(ctx, M, A, w):
        Y, q, h, m, l = _forward_parts(M, A, w)
        ctx.save_for_backward(M, A, w, m, l)
        ctx.set_materialize_grads(False)
        return Y, q, h

    @staticmethod
    def backward(ctx, dY, dq, dh):
        M, A, w, m, l = ctx.saved_tensors
        # An output the loss did not use has no cotangent (None); autograd's
        # cotangents may also be expanded (stride 0). The kernels take
        # contiguous f32, so zeros stand in for a missing one; a missing dh
        # also lets the kernels drop the entropy path.
        with_dh = dh is not None
        f32 = dict(dtype=torch.float32, device=M.device)
        dY = torch.zeros((M.shape[1], A.shape[1]), **f32) if dY is None else dY.contiguous()
        dq = torch.zeros(M.shape[1], **f32) if dq is None else dq.contiguous()
        dh = torch.zeros_like(w) if dh is None else dh.contiguous()
        return _backward(M, A, w, m, l, dY, dq, dh, with_dh=with_dh)
