"""Learning-rate schedules for the mapping optimizers.

Counterpart of ``tangram_tpu/ops/schedules.py``. The reference trains Adam
at a constant learning rate (default 0.1, ``mapping_utils.py:148-149``),
and that stays the default; every training entry point (``fit_mapping``,
``Mapper.train``, ``MapperConstrained.train``, ``map_cells_to_space``,
``cross_val``, ``checkpoint.train_checkpointed``) also takes a per-epoch
learning-rate vector, or a callable ``epoch -> lr``, through the same
``learning_rate`` argument. The training loops read the vector on the host,
one float per step.
"""

import numpy as np

__all__ = ["cosine_lr", "cosine_value", "resolve_lr"]


def cosine_value(t, peak, end, decay_len, xp=np):
    """Cosine-decay value at epoch ``t`` (no warmup), vectorized over ``t``:
    the one decay formula of :func:`cosine_lr` (numpy) and of the tuner's
    per-member schedule on the device (``xp=torch``, tensors)."""
    phase = xp.clip(t / decay_len, 0.0, 1.0)
    return end + (peak - end) * 0.5 * (1.0 + xp.cos(xp.pi * phase))


def cosine_lr(peak, num_epochs, end=0.0, warmup=0):
    """Per-epoch lr vector: linear warmup to ``peak`` over ``warmup`` epochs,
    then cosine decay to ``end`` over the remainder.

    Returns a float32 array of shape ``(num_epochs,)`` accepted by the
    ``learning_rate`` argument of every training entry point.
    """
    num_epochs = int(num_epochs)
    warmup = int(warmup)
    if not 0 <= warmup <= num_epochs:
        raise ValueError(
            f"warmup must be within [0, num_epochs], got {warmup} vs {num_epochs}"
        )
    t = np.arange(num_epochs, dtype=np.float64)
    if warmup > 0:
        ramp = peak * (t + 1) / warmup
    else:
        ramp = np.full_like(t, peak)
    decay_len = max(num_epochs - warmup, 1)
    decay = cosine_value(t - warmup, peak, end, decay_len)
    return np.where(t < warmup, ramp, decay).astype(np.float32)


def resolve_lr(learning_rate, num_epochs):
    """Normalize a ``learning_rate`` argument.

    * scalar → ``float`` (constant lr, the reference behavior),
    * callable → evaluated at ``0..num_epochs-1`` into a float32 vector,
    * array-like → validated ``(num_epochs,)`` float32 vector.
    """
    num_epochs = int(num_epochs)
    if callable(learning_rate):
        t = np.arange(num_epochs)
        try:
            vec = np.asarray(learning_rate(t), dtype=np.float32)
            if vec.shape != (num_epochs,):
                raise TypeError("not vectorized")
        except (TypeError, ValueError):
            vec = np.asarray(
                [float(learning_rate(int(i))) for i in range(num_epochs)],
                dtype=np.float32,
            )
        return vec
    if np.ndim(learning_rate) == 0:
        return float(learning_rate)
    shape = np.shape(learning_rate)
    if shape != (num_epochs,):
        raise ValueError(
            f"learning_rate vector has shape {shape}; expected "
            f"({num_epochs},) — one value per epoch of this call"
        )
    return np.asarray(learning_rate, dtype=np.float32)
