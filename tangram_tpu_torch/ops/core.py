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
"""

from __future__ import annotations

import torch

__all__ = ["mapper_core", "mapper_core_reference", "resolve_impl", "softmax_row_chunks",
           "unported"]

IMPLS = ("auto", "kernels", "fused", "reference")


def unported(what: str, item: str) -> NotImplementedError:
    """The error raised for an option the port does not cover yet; ``item``
    names the ROADMAP entry that will port it."""
    return NotImplementedError(
        f"{what} is not ported to tangram_tpu_torch yet (ROADMAP {item}); "
        "the JAX package tangram_tpu supports it"
    )


def mapper_core_reference(M, A, w):
    """Materialized softmax, ``log_softmax`` entropy and full-f32 products.

    The products run through ``torch.matmul``; on CUDA that is IEEE f32 as
    long as ``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
    default), which the port never changes.
    """
    P = torch.softmax(M, dim=1)
    Y = P.T @ A
    q = w @ P
    # log-softmax form avoids log(P) underflow for very negative logits
    h = torch.sum(P * torch.log_softmax(M, dim=1), dim=1)
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


def mapper_core(M, A, w, impl: str):
    """(Y, q, h) of the core, differentiable in M, A and w
    (``tangram_tpu.ops.core.mapper_core``). ``impl`` is a resolved impl:
    ``"reference"`` runs :func:`mapper_core_reference`; ``"kernels"`` and
    ``"fused"`` run :class:`~tangram_tpu_torch.ops.cuda_core.MapperCore`,
    whose wrappers launch the kernels on CUDA tensors and run their twins
    on CPU tensors."""
    if impl == "reference":
        return mapper_core_reference(M, A, w)
    if impl not in ("kernels", "fused"):
        raise ValueError(f"mapper_core takes a resolved impl, got {impl!r}")
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
