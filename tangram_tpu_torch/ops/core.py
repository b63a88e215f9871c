"""The numeric core of the mapping optimizer, plain PyTorch version.

Every unconstrained Tangram loss reduces to one primitive::

    mapper_core(M, A, w) -> (Y, q, h)

      P = softmax(M, axis=1)        # rows over spots  (c × s)
      Y = P.T @ A                   # projected expression (s × k)
      q = w @ P                     # weighted spot marginal (s,)
      h = sum_s P * log(P)          # per-cell negative entropy (c,)

:func:`mapper_core_reference` materializes P and lets autograd differentiate
it; it is the counterpart of ``tangram_tpu.ops.core._mapper_core_xla``. The
streamed CUDA kernels (``ops/cuda_core.py``, ``ops/fused_step.py``) compute
the same values without ever storing P or dP; :func:`mapper_core` picks one
or the other.

The spot graphs of the spatial terms are here too: :class:`NeighborGraph`,
the structured k-NN form of a spot × spot weight matrix, and
:func:`graph_matmul`, W @ X for W dense or a ``NeighborGraph`` (the
counterpart of ``tangram_tpu/ops/core.py:89-254``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["mapper_core", "mapper_core_reference", "resolve_impl", "softmax_row_chunks",
           "unported", "NeighborGraph", "graph_matmul", "transpose_arrays",
           "neighbor_graph_from_dense"]

IMPLS = ("auto", "kernels", "fused", "reference")


def unported(what: str, item: str) -> NotImplementedError:
    """The error raised for an option the port does not cover yet; ``item``
    names the ROADMAP entry that will port it."""
    return NotImplementedError(
        f"{what} is not ported to tangram_tpu_torch yet (ROADMAP {item}); "
        "the JAX package tangram_tpu supports it"
    )


def mapper_core_reference(M, A, w):
    """Materialized softmax, ``log_softmax`` entropy and full-f32 products,
    for M (c, s) or a batch (..., c, s) of independent problems (the tuner's
    population), each with the same A and w; the softmax runs over spots,
    the last axis.

    The products run through ``torch.matmul``; on CUDA that is IEEE f32 as
    long as ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
    default), which the port never changes.
    """
    P = torch.softmax(M, dim=-1)
    Y = P.transpose(-1, -2) @ A
    q = w @ P
    # log-softmax form avoids log(P) underflow for very negative logits
    h = torch.sum(P * torch.log_softmax(M, dim=-1), dim=-1)
    return Y, q, h


def resolve_impl(impl: str, M: torch.Tensor) -> str:
    """Which training loop runs for logits ``M``.

    * ``"kernels"`` — the fused loop through the hand-written CUDA kernels;
      ``M`` must be a CUDA tensor.
    * ``"fused"`` — the same fused loop on any device: on a CUDA tensor each
      wrapper launches its kernel, on a CPU tensor it runs its plain twin.
    * ``"reference"`` — materialized softmax plus autograd.
    * ``"auto"`` — ``"kernels"`` for a CUDA tensor, ``"reference"`` for a
      CPU tensor.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernels" if M.is_cuda else "reference"
    if impl == "kernels" and not M.is_cuda:
        raise ValueError(
            f"impl='kernels' needs CUDA tensors; M is on {M.device}. Use "
            "impl='fused' to run the fused loop with the plain twins, or "
            "impl='reference'."
        )
    return impl


def mapper_core(M, A, w, impl: str = "auto"):
    """(Y, q, h) of the core, differentiable in M, A and w
    (``tangram_tpu.ops.core.mapper_core``). ``impl`` is resolved for ``M``
    by :func:`resolve_impl`: ``"reference"`` runs
    :func:`mapper_core_reference`; ``"kernels"`` and ``"fused"`` run
    :class:`~tangram_tpu_torch.ops.cuda_core.MapperCore`, whose wrappers
    launch the kernels on CUDA tensors and run their twins on CPU tensors;
    ``"auto"`` takes the kernels on a CUDA tensor and the reference core on
    a CPU tensor."""
    if resolve_impl(impl, M) == "reference":
        return mapper_core_reference(M, A, w)
    from .cuda_core import MapperCore

    return MapperCore.apply(M.contiguous(), A.contiguous(), w.contiguous())


#: rows of M per chunk of the row softmaxes that leave training (~128 MB of
#: f32 at the tutorial width)
SOFTMAX_CHUNK_ELEMENTS = 1 << 25


def softmax_row_chunks(M):
    """(start row, f32 softmax of a chunk of M's rows) in row order: the
    mapping in f32 without an f32 copy of all of M (stored in bf16 under
    ``param_dtype``) or of all of softmax(M) on its device at once."""
    rows = max(1, SOFTMAX_CHUNK_ELEMENTS // max(M.shape[1], 1))
    for r0 in range(0, M.shape[0], rows):
        yield r0, torch.softmax(M[r0:r0 + rows].float(), dim=1)


class NeighborGraph(NamedTuple):
    """A k-nearest-neighbor spot graph in structure-of-arrays form.

    A dense spot × spot weight matrix costs O(s²) memory (388 MB in f32 at
    9,852 spots, 10 GB at 50k); the spot graphs of KNN, Delaunay or Visium
    grids have ~6 neighbors per spot, so the graph is stored as (s, k)
    neighbor indices and weights, and W @ X is k gathered, weighted row
    sums. ``t_indices``/``t_weights`` hold the TRANSPOSE graph in the same
    form; with them, :func:`graph_matmul`'s backward is the gather
    Wᵀ @ cotangent, not a scatter-add. Every builder in this package fills
    them in. The graph tensors are data, never differentiated.
    """

    indices: torch.Tensor  # (s, k) int64, padded entries point at row 0
    weights: torch.Tensor  # (s, k) float32, padded entries have weight 0
    t_indices: Optional[torch.Tensor] = None  # (s, k_t) transpose adjacency
    t_weights: Optional[torch.Tensor] = None

    @property
    def n_spots(self) -> int:
        return self.indices.shape[0]

    def matmul(self, X):
        return graph_matmul(self, X)

    def to(self, device, dtype=torch.float32) -> "NeighborGraph":
        """The graph on ``device``, its weights in ``dtype``."""
        def move(t, to_dtype):
            return None if t is None else t.to(device=device, dtype=to_dtype)

        return NeighborGraph(move(self.indices, torch.int64), move(self.weights, dtype),
                             move(self.t_indices, torch.int64), move(self.t_weights, dtype))

    def row_sums(self):
        return torch.sum(self.weights, dim=1)

    def col_sums(self):
        # from the transpose whenever it is there: a scatter-add sums in no
        # fixed order on CUDA
        if self.t_weights is not None:
            return torch.sum(self.t_weights, dim=1)
        out = torch.zeros(self.n_spots, dtype=self.weights.dtype,
                          device=self.weights.device)
        return out.index_add_(0, self.indices.reshape(-1), self.weights.reshape(-1))

    def to_dense(self):
        s = self.n_spots
        W = torch.zeros((s, s), dtype=self.weights.dtype, device=self.weights.device)
        rows = torch.arange(s, device=W.device)[:, None].expand(self.indices.shape)
        return W.index_put_((rows.reshape(-1), self.indices.reshape(-1)),
                            self.weights.reshape(-1), accumulate=True)


_UNROLL_MAX_K = 16


def _apply_graph(indices, weights, X):
    """Σ_k w[:, k] ⊙ X[idx[:, k]]: k row gathers accumulated in slot order
    for small k; one (s, k, g) gather and a contraction for wide graphs."""
    k = indices.shape[1]
    if k == 0:
        return torch.zeros((indices.shape[0], X.shape[1]), dtype=X.dtype,
                           device=X.device)
    if k > _UNROLL_MAX_K:
        return torch.einsum("skg,sk->sg", X[indices], weights)
    out = weights[:, 0:1] * X.index_select(0, indices[:, 0])
    for j in range(1, k):
        out = out + weights[:, j:j + 1] * X.index_select(0, indices[:, j])
    return out


class _GraphMatmul(torch.autograd.Function):
    """W @ X with the transpose-graph backward (``_graph_mm_nt`` of the JAX
    package): both directions are gathers. Autograd of the gathers would
    scatter-add, which on CUDA sums with atomics in no fixed order, and a
    fit would no longer repeat bit for bit."""

    @staticmethod
    def forward(ctx, X, indices, weights, t_indices, t_weights):
        ctx.save_for_backward(t_indices, t_weights)
        return _apply_graph(indices, weights, X)

    @staticmethod
    def backward(ctx, ct):
        t_indices, t_weights = ctx.saved_tensors
        return _apply_graph(t_indices, t_weights, ct), None, None, None, None


def graph_matmul(W, X):
    """W @ X for W a dense (s, s) tensor or a :class:`NeighborGraph`. The
    dense product is ``torch.matmul``: IEEE f32 on CUDA while
    ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
    default, which the port never changes)."""
    if isinstance(W, NeighborGraph):
        if W.t_indices is not None:
            return _GraphMatmul.apply(X, W.indices, W.weights, W.t_indices, W.t_weights)
        return _apply_graph(W.indices, W.weights, X)
    return torch.matmul(W, X)


def _padded_from_coo(rows, cols, vals, n_rows: int):
    """(rows, cols, vals) COO triplets → padded (n_rows, k) numpy arrays,
    entries in stable row order (host side, one vectorized scatter)."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    k = int(counts.max()) if len(rows) else 0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.arange(len(rows)) - starts[rows]
    indices = np.zeros((n_rows, k), dtype=np.int64)
    weights = np.zeros((n_rows, k), dtype=np.float32)
    indices[rows, slots] = cols
    weights[rows, slots] = vals
    return indices, weights


def transpose_arrays(indices, weights):
    """Padded (s, k_t) numpy form of the transpose adjacency (host side)."""
    indices = np.asarray(indices)
    weights = np.asarray(weights)
    s, k = indices.shape
    rows = np.repeat(np.arange(s), k)
    cols = indices.reshape(-1)
    vals = weights.reshape(-1)
    keep = vals != 0  # padded entries carry weight 0
    # every edge (i → j, w) becomes (j → i, w)
    return _padded_from_coo(cols[keep], rows[keep], vals[keep], s)


def graph_from_arrays(indices, weights) -> NeighborGraph:
    """A :class:`NeighborGraph` of CPU tensors from padded numpy arrays,
    its transpose filled in."""
    t_idx, t_w = transpose_arrays(indices, weights)
    return NeighborGraph(*(torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
                           for a, dt in ((indices, np.int64), (weights, np.float32),
                                         (t_idx, np.int64), (t_w, np.float32))))


def neighbor_graph_from_dense(W, k: Optional[int] = None) -> NeighborGraph:
    """A dense (s, s) weight matrix as a :class:`NeighborGraph` of CPU
    tensors (host side, one vectorized scatter); each row keeps its first
    ``k`` nonzeros (all by default)."""
    W = np.asarray(W)
    s = W.shape[0]
    rows, cols = np.nonzero(W)
    nnz_per_row = np.bincount(rows, minlength=s)
    if k is None:
        k = int(nnz_per_row.max()) if s and len(rows) else 0
    row_starts = np.concatenate([[0], np.cumsum(nnz_per_row)[:-1]])
    slots = np.arange(len(rows)) - row_starts[rows]
    keep = slots < k
    indices = np.zeros((s, k), dtype=np.int64)
    weights = np.zeros((s, k), dtype=np.float32)
    indices[rows[keep], slots[keep]] = cols[keep]
    weights[rows[keep], slots[keep]] = W[rows[keep], cols[keep]]
    return graph_from_arrays(indices, weights)
