"""Forward kernels of the fused core: row stats and the projection.

Counterpart of ``tangram_tpu/ops/pallas_core.py`` (``_rowstats``,
``_project``). Each wrapper takes the JAX function's arguments and returns
its outputs in the same shapes. On a CUDA tensor it launches the
hand-written kernel from ``csrc/mapper_kernels.cu`` (and counts the launch
in :data:`LAUNCHES`); on a CPU tensor it runs the plain PyTorch twin that
sits beside it. There is no other path: a CUDA launch that fails raises.

The kernels never pad the gene axis (the JAX package pads k to 128 lanes
for the TPU); they mask ragged tiles themselves.
"""

from __future__ import annotations

import math

import torch

__all__ = ["LAUNCHES", "reset_launches", "kernels_for", "_rowstats", "_project"]

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"rowstats": 0, "project": 0, "rbar": 0, "dm_adam": 0,
            "rowstats_norms": 0, "gsq": 0, "dm_adafactor": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def check(name: str, t: torch.Tensor, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor of ``shape`` — what the
    kernels take. The wrappers check CPU tensors too, so the CPU tests hold
    callers to the same contract."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def vec4_ok(s: int, *tensors: torch.Tensor) -> int:
    """1 when the kernels may use 16-byte accesses along spots of each
    tensor, (c, s) or (s,)."""
    return int(s % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


# ---------------------------------------------------------------------------
# row stats
# ---------------------------------------------------------------------------


def _rowstats_plain(M):
    """Per-cell m = max, l = Σ exp(M − m), u = Σ exp(M − m)·M, each (c, 1)."""
    m = M.amax(dim=1, keepdim=True)
    e = torch.exp(M - m)
    return m, e.sum(dim=1, keepdim=True), (e * M).sum(dim=1, keepdim=True)


def _rowstats(M):
    """Softmax row stats of M (c, s) → (m, l, u), each (c, 1) f32."""
    c, s = M.shape
    check("M", M, (c, s))
    lib = kernels_for(M)
    if lib is None:
        return _rowstats_plain(M)
    m, l, u = (torch.empty((c, 1), dtype=torch.float32, device=M.device)
               for _ in range(3))
    if c:
        with torch.cuda.device(M.device):
            lib.call("tg_rowstats", M.data_ptr(), m.data_ptr(), l.data_ptr(),
                     u.data_ptr(), c, s, stream_of(M))
        LAUNCHES["rowstats"] += 1
    return m, l, u


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

_PJ_SPOTS = 64    # spots per block of the project kernel
_PJ_COLS = 256    # columns of [A | w] per block


def project_splits(c: int, s: int, k: int, sm_count: int) -> int:
    """How many contiguous cell ranges the project kernel reduces over in
    parallel: enough blocks for about eight per SM, each range at least 512
    cells (fewer splits for few cells — clusters mode has tens)."""
    base = math.ceil(s / _PJ_SPOTS) * math.ceil((k + 1) / _PJ_COLS)
    want = math.ceil(8 * sm_count / max(base, 1))
    return max(1, min(want, math.ceil(c / 512), 16))


def _project_plain(M, A, w, m, l):
    P = torch.exp(M - m) * (1.0 / l)
    return P.T @ A, w @ P


def _project(M, A, w, m, l):
    """Y = Pᵀ A (s, k) and q = w P (s,), with P = exp(M − m)/l recomputed
    from the row stats; P is never stored."""
    c, s = M.shape
    k = A.shape[1]
    check("M", M, (c, s))
    check("A", A, (c, k))
    check("w", w, (c,))
    check("m", m, (c, 1))
    check("l", l, (c, 1))
    lib = kernels_for(M, A, w, m, l)
    if lib is None:
        return _project_plain(M, A, w, m, l)
    dev = M.device
    nsplit = project_splits(
        c, s, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((nsplit, s, k + 1), dtype=torch.float32, device=dev)
    Y = torch.empty((s, k), dtype=torch.float32, device=dev)
    q = torch.empty((s,), dtype=torch.float32, device=dev)
    if s:
        with torch.cuda.device(dev):
            lib.call("tg_project", M.data_ptr(), A.data_ptr(), w.data_ptr(),
                     m.data_ptr(), l.data_ptr(), partial.data_ptr(),
                     Y.data_ptr(), q.data_ptr(), c, s, k, nsplit, stream_of(M))
        LAUNCHES["project"] += 1
    return Y, q
