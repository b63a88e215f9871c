"""numpy's legacy normal stream drawn on the card, bit for bit.

:func:`legacy_normal` is ``np.random.normal(0, 1, shape).astype(np.float32)``
from numpy's global state, as a tensor of ``dtype`` on ``device``, and
leaves that state as ``np.random.normal`` would have left it: the seeded
start of the reference, which the benchmark's plain reference and the JAX
package draw on the host. On a CUDA device it launches the two passes of
``csrc/legacy_normal.cu`` (counted in ``cuda_core.LAUNCHES["init_normal"]``,
``.bf16`` on a bf16 tensor, and timed with the other kernels); on the CPU
it runs their plain twin in NumPy, the same passes with the same
checkpoints, counts, scan and per-segment regeneration. A failed launch
raises; nothing falls back to the host draw on a CUDA device.

NumPy's legacy RandomState draws a pair of normals per accepted attempt of
Marsaglia's polar method, four MT19937 words an attempt. The passes cut the
stream into segments of :data:`SEGMENT_BLOCKS` blocks of 624 words: pass A
walks the stream in order and saves each segment's 624-word start, then
counts each segment's accepted attempts and scans the counts; pass B
regenerates each segment and writes its pairs at their places. Only the
state's copy to the card, the read-back of its 5 KB of results and the
few outputs near an f32 rounding midpoint (listed by the kernel, recomputed
here with the host's libm, which numpy calls) stay on the host.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from .. import profiling
from . import cuda_core as cc

__all__ = ["legacy_normal", "SEGMENT_BLOCKS"]

#: words in a block of MT19937's state
MT_N = 624
#: attempts that start in one block of 624 words
ATTEMPTS_PER_BLOCK = MT_N // 4
#: blocks per segment: 65,520 attempts, ~2,500 segments at the tutorial's
#: 26,431 x 9,852 (checkpoints of 6.3 MB)
SEGMENT_BLOCKS = 420
#: f64 ulps around an f32 rounding midpoint within which an output is
#: recomputed on the host (csrc/legacy_normal.cu's NEAR_TIE)
NEAR_TIE = 64
# the int64 meta array of the kernels
META_LEN, META_SEG, META_POS, META_NFIX, META_R2, META_X1, META_KEY = 640, 1, 2, 3, 4, 5, 8

_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER, _LOWER = np.uint32(0x80000000), np.uint32(0x7FFFFFFF)
_ACCEPT = math.pi / 4  # the polar method's acceptance rate


def _attempt_bound(pairs: int) -> int:
    """Attempts that hold ``pairs`` accepted ones but for a chance far
    below any that matters: the mean plus eight standard deviations. A
    shortfall still comes out right: the draw runs again on twice as many."""
    sd = math.sqrt(pairs * (1 - _ACCEPT)) / _ACCEPT
    return math.ceil(pairs / _ACCEPT + 8 * sd) + ATTEMPTS_PER_BLOCK


def _fix_capacity(n: int) -> int:
    """Room for the outputs near an f32 midpoint: ~2.4e-7 of them expected
    (2 x 64 ulps of 2^29), room for 64 times that and 1,024 more."""
    return 1024 + (n >> 16)


def legacy_normal(shape, dtype=torch.float32, device="cpu", keep: bool = True):
    """``np.random.normal(0, 1, shape)`` cast to f32, then to ``dtype`` (f32
    or bf16), on ``device``, drawn from numpy's global state and leaving it
    as that call leaves it (key, pos, the cached Gaussian); ``keep=False``
    writes nothing and returns None (a draw that only moves the state).
    Under :func:`~tangram_tpu_torch.profiling.record_phases` the state's copy
    to the card is phase ``init_upload`` and the rest of a card draw
    ``init_draw``."""
    shape = tuple(int(x) for x in shape)
    n = math.prod(shape)
    device = torch.device(device)
    if dtype not in cc.F32_BF16:
        raise TypeError(f"legacy_normal draws float32 or bfloat16, not {dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    name, key, pos, has_gauss, gauss = np.random.get_state()
    if name != "MT19937":
        raise ValueError(f"numpy's global generator is {name}, not the legacy MT19937")
    key, pos = np.asarray(key, dtype=np.uint32), int(pos)
    head = int(bool(has_gauss) and n > 0)
    pairs = (n - head + 1) // 2
    draw = SimpleNamespace(key=key, pos=pos, n=n, head=head, head_value=float(gauss),
                           pairs=pairs, segment_blocks=SEGMENT_BLOCKS)
    if device.type == "cuda":
        out = torch.empty(shape, dtype=dtype, device=device) if keep else None
        result = _draw_cuda(draw, out, device)
    else:
        flat = np.empty(n, dtype=np.float32) if keep else None
        result = _draw_plain(draw, flat)
        out = torch.from_numpy(flat.reshape(shape)).to(dtype) if keep else None
    if keep and result.fixes.size:
        _apply_fixes(out, result.fixes)
    if pairs == 0:
        state = (key, pos, 0, 0.0) if head else (key, pos, int(has_gauss), float(gauss))
    else:
        odd = (n - head) % 2 == 1
        last = result.x1 * math.sqrt(-2.0 * math.log(result.r2) / result.r2)
        state = (result.key, result.pos, int(odd), last if odd else 0.0)
    np.random.set_state(("MT19937",) + state)
    return out


def _polar_value(r2: float, x: float) -> float:
    """numpy's output 0 + f x, f = sqrt(-2 log(r2) / r2), with the host's
    libm (Python's math module calls it, as numpy's C code does)."""
    return 0.0 + math.sqrt(-2.0 * math.log(r2) / r2) * x


def _apply_fixes(out, fixes):
    """Write numpy's own values at the listed outputs: (index, r2 bits, x
    bits) rows."""
    r2 = fixes[:, 1].view(np.float64)
    x = fixes[:, 2].view(np.float64)
    values = np.array([_polar_value(a, b) for a, b in zip(r2, x)], dtype=np.float32)
    idx = torch.from_numpy(np.ascontiguousarray(fixes[:, 0])).to(out.device)
    out.view(-1)[idx] = torch.from_numpy(values).to(device=out.device, dtype=out.dtype)


def _segments(attempts: int, segment_blocks: int) -> int:
    return max(1, -(-attempts // (ATTEMPTS_PER_BLOCK * segment_blocks)))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def card_buffers(draw, device, attempts: int, fix_cap: int):
    """The passes' scratch on ``device``: checkpoints (segments, 624),
    counts, their exclusive prefix, the meta array and the near-tie list."""
    k = _segments(attempts, draw.segment_blocks)
    i32, i64 = dict(dtype=torch.int32, device=device), dict(dtype=torch.int64, device=device)
    return SimpleNamespace(segments=k, ckpt=torch.empty((k, MT_N), **i32),
                           counts=torch.empty(k, **i32), excl=torch.empty(k, **i64),
                           meta=torch.empty(META_LEN, **i64),
                           fix=torch.empty((fix_cap, 3), **i64), fix_cap=fix_cap)


def pass_a(lib, draw, key_d, buf, stream: int) -> None:
    lib.call("tg_normal_pass_a", key_d.data_ptr(), draw.pos, draw.segment_blocks,
             buf.segments, draw.pairs, buf.ckpt.data_ptr(),
             buf.counts.data_ptr(), buf.excl.data_ptr(), buf.meta.data_ptr(), stream)


def pass_b(lib, draw, out, buf, stream: int) -> None:
    lib.call("tg_normal_pass_b", buf.ckpt.data_ptr(), draw.pos, draw.segment_blocks,
             buf.segments, buf.excl.data_ptr(), buf.meta.data_ptr(), draw.pairs, draw.n,
             draw.head, draw.head_value, None if out is None else out.data_ptr(),
             0 if out is None else cc.is_bf16(out), buf.fix.data_ptr(), buf.fix_cap, stream)


def _draw_cuda(draw, out, device):
    from ._build import load_kernels

    lib = load_kernels()
    if draw.pairs == 0:
        if out is not None and draw.head:
            out.view(-1)[0] = float(np.float32(draw.head_value))
        return SimpleNamespace(fixes=np.empty((0, 3), np.int64))
    with profiling.phase("init_upload"):
        key_d = torch.from_numpy(draw.key.view(np.int32)).to(device)
    with profiling.phase("init_draw"):
        attempts, fix_cap = _attempt_bound(draw.pairs), _fix_capacity(draw.n)
        while True:
            buf = card_buffers(draw, device, attempts, fix_cap)
            with torch.cuda.device(device), cc.launch("init_normal",
                                                      buf.ckpt if out is None else out):
                stream = torch.cuda.current_stream(device).cuda_stream
                pass_a(lib, draw, key_d, buf, stream)
                pass_b(lib, draw, out, buf, stream)
            meta = buf.meta.cpu().numpy()
            if meta[META_SEG] < 0:
                attempts *= 2
            elif meta[META_NFIX] > fix_cap:
                fix_cap = int(meta[META_NFIX])
            else:
                break
        fixes = buf.fix[:int(meta[META_NFIX])].cpu().numpy()
    return _result(meta, fixes)


def _result(meta, fixes):
    """The state after the draw and the last pair's (r2, x1), from the
    meta array, with the near-tie list."""
    return SimpleNamespace(key=meta[META_KEY:META_KEY + MT_N].astype(np.uint32),
                           pos=int(meta[META_POS]),
                           r2=float(meta[META_R2:META_R2 + 1].view(np.float64)[0]),
                           x1=float(meta[META_X1:META_X1 + 1].view(np.float64)[0]),
                           fixes=fixes)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def _twist(a, b):
    y = (a & _UPPER) | (b & _LOWER)
    return (y >> np.uint32(1)) ^ ((b & np.uint32(1)) * _MATRIX_A)


def mt_regen_plain(old):
    """numpy's mt19937_gen: the block of 624 words after ``old``, in the
    kernel's three runs (words 0-226 from the old block, 227-453 and
    454-622 each from the run before, 623 last)."""
    new = np.empty(MT_N, dtype=np.uint32)
    new[:227] = old[397:] ^ _twist(old[:227], old[1:228])
    new[227:454] = new[:227] ^ _twist(old[227:454], old[228:455])
    new[454:623] = new[227:396] ^ _twist(old[454:623], old[455:])
    new[623] = new[396] ^ _twist(old[623], new[0])
    return new


def _temper(y):
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    return y ^ (y >> np.uint32(18))


def _checkpoints_plain(key, pos, segment_blocks, segments):
    """Pass A's checkpoints: block 0, then every ``segment_blocks``
    regenerations of the walk."""
    ckpt = np.empty((segments, MT_N), dtype=np.uint32)
    ckpt[0] = mt_regen_plain(key) if pos >= MT_N else key
    for k in range(1, segments):
        cur = ckpt[k - 1]
        for _ in range(segment_blocks):
            cur = mt_regen_plain(cur)
        ckpt[k] = cur
    return ckpt


def _segment_plain(start, pos0, segment_blocks):
    """A segment regenerated from its checkpoint: its blocks, and for each
    of its attempts the offset of its first word, x1, x2, r2 and whether
    it is accepted."""
    blocks = [start]
    for _ in range(segment_blocks):
        blocks.append(mt_regen_plain(blocks[-1]))
    words = _temper(np.concatenate(blocks))
    first = pos0 + 4 * np.arange(ATTEMPTS_PER_BLOCK * segment_blocks)
    w = words[first[:, None] + np.arange(4)]
    a = (w >> np.uint32(5)).astype(np.float64)
    b = (w >> np.uint32(6)).astype(np.float64)
    x1 = 2.0 * ((a[:, 0] * 67108864.0 + b[:, 1]) / 9007199254740992.0) - 1.0
    x2 = 2.0 * ((a[:, 2] * 67108864.0 + b[:, 3]) / 9007199254740992.0) - 1.0
    r2 = x1 * x1 + x2 * x2
    return blocks, first, x1, x2, r2, (r2 < 1.0) & (r2 != 0.0)


def _near_tie(v):
    low = v.view(np.int64) & 0x1FFFFFFF
    return np.abs(low - 0x10000000) <= NEAR_TIE


def _draw_plain(draw, out):
    """Pass A and pass B as the kernels run them, segment by segment, into
    the f32 array ``out`` (or nowhere)."""
    if out is not None and draw.head:
        out[0] = np.float32(0.0 + draw.head_value)
    if draw.pairs == 0:
        return SimpleNamespace(fixes=np.empty((0, 3), np.int64))
    pos0 = draw.pos % MT_N
    attempts = _attempt_bound(draw.pairs)
    while True:
        ckpt = _checkpoints_plain(draw.key, draw.pos, draw.segment_blocks,
                                  _segments(attempts, draw.segment_blocks))
        counts = np.array([_segment_plain(c, pos0, draw.segment_blocks)[5].sum()
                           for c in ckpt], dtype=np.int64)
        excl = np.cumsum(counts) - counts
        holds = np.flatnonzero((excl < draw.pairs) & (excl + counts >= draw.pairs))
        if holds.size:
            break
        attempts *= 2
    meta = np.zeros(META_LEN, dtype=np.int64)
    fixes = []
    for k in range(int(holds[0]) + 1):
        blocks, first, x1, x2, r2, ok = _segment_plain(ckpt[k], pos0, draw.segment_blocks)
        p = excl[k] + np.cumsum(ok) - 1
        sel = ok & (p < draw.pairs)
        if out is not None:
            f = np.sqrt(-2.0 * np.log(r2[sel]) / r2[sel])
            idx = draw.head + 2 * p[sel]
            for i, x, v in ((idx, x2[sel], 0.0 + f * x2[sel]),
                            (idx + 1, x1[sel], 0.0 + f * x1[sel])):
                inside = i < draw.n
                i, x, v, r = i[inside], x[inside], v[inside], r2[sel][inside]
                out[i] = v.astype(np.float32)
                near = _near_tie(v)
                fixes.append(np.stack([i[near], r[near].view(np.int64),
                                       x[near].view(np.int64)], axis=1))
        last = np.flatnonzero(sel & (p == draw.pairs - 1))
        if last.size:
            a = int(last[0])
            q = int(first[a]) + 3  # the last word read
            meta[META_KEY:META_KEY + MT_N] = blocks[q // MT_N]
            meta[META_POS] = q % MT_N + 1
            meta[META_R2:META_X1 + 1] = np.array([r2[a], x1[a]]).view(np.int64)
    fixes = np.concatenate(fixes) if fixes else np.empty((0, 3), np.int64)
    return _result(meta, fixes)
