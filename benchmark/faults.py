"""Faults planted under the timed path, to show that the check sees them.

Each is a context manager that patches the program while it is open:

* ``unchanged``: the Adam update returns M, mu and nu as they were;
* ``half_batch``: the second half of the cells left out of the projection
  and the gradient, the marginal taken as the mean over the first half;
* ``answer``: the answer altered where it is produced: the mapping fetch
  hands back its rows one cell out of place, and each step's reported
  loss is moved by 1e-3;
* ``few_rows``: a minority of the answer altered: the fetch hands back
  one row in a hundred (at least three) with its spots one place out.

The CPU tests drive a whole run under each; ``benchmark.calibrate`` reads
them on the card.
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def unchanged():
    from tangram_tpu_torch.ops import cuda_core, fused_step

    def dm_adam(M, A, w, m, l, dY, dq, dh, r, mu, nu, scalars, **kw):
        return (M, mu, nu) + tuple(cuda_core._rowstats(M))

    with _patched(fused_step, "_dm_adam", dm_adam):
        yield


@contextlib.contextmanager
def half_batch():
    from tangram_tpu_torch.ops import fused_step

    inputs = fused_step.unconstrained_inputs

    def halved(M, data, lw):
        A, w = inputs(M, data, lw)
        keep = A.shape[0] // 2
        A, w = A.clone(), w.clone()
        A[keep:] = 0
        w[:keep] *= w.sum() / w[:keep].sum()
        w[keep:] = 0
        return A, w

    with _patched(fused_step, "unconstrained_inputs", halved):
        yield


@contextlib.contextmanager
def answer():
    import numpy as np

    from tangram_tpu_torch.models import mapper
    from tangram_tpu_torch.ops import fused_step

    softmax, epilogue = mapper._final_softmax, fused_step.unconstrained_epilogue

    def shifted(M):
        return np.roll(softmax(M), 1, axis=0)

    def moved(*args, **kw):
        total, terms = epilogue(*args, **kw)
        terms = dict(terms, total_loss=terms["total_loss"] + 1e-3)
        return total, terms

    with _patched(mapper, "_final_softmax", shifted), \
            _patched(fused_step, "unconstrained_epilogue", moved):
        yield


@contextlib.contextmanager
def few_rows():
    import numpy as np

    from tangram_tpu_torch.models import mapper

    softmax = mapper._final_softmax

    def altered(M):
        P = softmax(M)
        rows = np.arange(0, P.shape[0], 100)
        if len(rows) < 3:
            rows = np.arange(min(3, P.shape[0]))
        P[rows] = np.roll(P[rows], 1, axis=1)
        return P

    with _patched(mapper, "_final_softmax", altered):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "answer": answer,
          "few_rows": few_rows}
