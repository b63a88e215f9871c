"""Carry state across from the JAX package.

The tests feed both packages identical state: arrays taken from
``tangram_tpu`` (as numpy, e.g. through ``np.asarray``) become the port's
tensors on a given device. Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.core import NeighborGraph
from .ops.losses import MapperData

__all__ = ["state_from_jax", "constrained_state_from_jax", "adafactor_state_from_jax",
           "constrained_adafactor_state_from_jax", "mapper_data_from_jax",
           "neighbor_graph_from_jax"]


def _tensor(x, device):
    """A JAX array as a tensor on ``device``: f32, or bf16 where the array
    is bf16 (numpy's ``bfloat16`` from ml_dtypes), bit for bit — a bf16
    widens to f32 exactly and narrows back unchanged."""
    if x is None:
        return None
    bf16 = getattr(getattr(x, "dtype", None), "name", None) == "bfloat16"
    # np.array copies: the port updates M, mu and nu in place, and arrays
    # handed out by jax are read-only
    t = torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
    return t.to(torch.bfloat16) if bf16 else t


def state_from_jax(M, count, mu, nu, stats, device="cpu"):
    """``(M, count, mu, nu, stats)`` of the JAX fused step → the port's
    ``(M, count, mu, nu, stats)``: tensors on ``device`` (f32, or bf16
    where the JAX state is stored in bf16), ``count`` a host int, ``stats``
    a tuple of (c, 1) tensors — (m, l, u), or
    (m, l, u, s1, s2) when the L1/L2 terms are on."""
    return (
        _tensor(M, device),
        int(np.asarray(count)),
        _tensor(mu, device),
        _tensor(nu, device),
        tuple(_tensor(s, device) for s in stats),
    )


def constrained_state_from_jax(params, count, mus, nus, stats, device="cpu"):
    """``((M, F), count, (mu, muF), (nu, nuF), stats)`` of the JAX fused
    constrained step → the port's, as :func:`state_from_jax` converts it."""
    pair = lambda xs: tuple(_tensor(x, device) for x in xs)  # noqa: E731
    return (pair(params), int(np.asarray(count)), pair(mus), pair(nus),
            pair(stats))


def adafactor_state_from_jax(count, v_row, v_col, c: int, s: int, device="cpu"):
    """optax ``FactoredState`` statistics of a (c, s) parameter → the
    port's Adafactor carry ``(count, vr (c,), vc (s,))``. optax's ``v_row``
    is the mean over the LARGER axis, so it lies on the smaller one: on
    cells when s ≥ c, on spots otherwise (as the JAX fused path maps it)."""
    vr, vc = (v_row, v_col) if s >= c else (v_col, v_row)
    vr, vc = _tensor(vr, device), _tensor(vc, device)
    if tuple(vr.shape) != (c,) or tuple(vc.shape) != (s,):
        raise ValueError(f"factored statistics of shapes {tuple(vr.shape)} and "
                         f"{tuple(vc.shape)} do not belong to a ({c}, {s}) parameter")
    return int(np.asarray(count)), vr, vc


def constrained_adafactor_state_from_jax(count, v_row, v_col, v, c: int, s: int,
                                         device="cpu"):
    """optax ``FactoredState`` of the constrained (M, F) pytree — ``v_row``,
    ``v_col`` and ``v`` each a pair (M's, F's) — → the port's carry
    ``(count, vr (c,), vc (s,), vF (c,))``: M's factored statistics as
    :func:`adafactor_state_from_jax` maps them, and F's unfactored ``v``."""
    count, vr, vc = adafactor_state_from_jax(count, v_row[0], v_col[0], c, s, device)
    vF = _tensor(v[1], device)
    if tuple(vF.shape) != (c,):
        raise ValueError(f"F's statistic has shape {tuple(vF.shape)}, not ({c},)")
    return count, vr, vc, vF


def _is_jax_graph(x) -> bool:
    """A ``tangram_tpu.ops.core.NeighborGraph``, told by its fields (the
    port imports nothing of the JAX package)."""
    return getattr(x, "_fields", None) == NeighborGraph._fields


def neighbor_graph_from_jax(graph, device="cpu") -> NeighborGraph:
    """A JAX ``NeighborGraph`` (indices, weights and the transpose's) → the
    port's on ``device``: int64 indices, f32 weights, the same values."""
    def indices(x):
        return None if x is None else torch.from_numpy(
            np.array(x, dtype=np.int64)).to(device)

    return NeighborGraph(indices(graph.indices), _tensor(graph.weights, device),
                         indices(graph.t_indices), _tensor(graph.t_weights, device))


def mapper_data_from_jax(data, device="cpu") -> MapperData:
    """A ``tangram_tpu.ops.losses.MapperData`` → the port's ``MapperData``
    on ``device``, its spot graphs as dense tensors or the port's
    ``NeighborGraph``."""
    def convert(x):
        return neighbor_graph_from_jax(x, device) if _is_jax_graph(x) else _tensor(x, device)

    return MapperData(**{name: convert(getattr(data, name)) for name in MapperData._fields})
