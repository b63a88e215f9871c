"""The init draw's plain twin (``ops/init_draw.py``) against numpy's own
legacy normal stream, bit for bit, and the mapper's routing of the numpy
stream between the card's kernels and the host.

The twin runs the kernels' two passes in NumPy (checkpoints every segment,
counts, their scan, each segment regenerated and its pairs written at
their places), so each case here checks the passes' arithmetic: the f32
draw equals ``np.random.normal(0, 1, shape).astype(np.float32)`` with
``np.array_equal``, and numpy's state afterwards (key, pos, the cached
Gaussian and the next uniform) equals the host draw's. The card runs the
same cases in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from _init_draw_cases import CASES, STARTS, same_state, state_after
from tangram_tpu_torch.models import mapper as mp
from tangram_tpu_torch.ops import init_draw
from tangram_tpu_torch.ops.init_draw import legacy_normal


def host_draws(start, shapes, keep):
    """numpy's draws of ``shapes`` from ``start``, f32, the discarded ones
    None, and the state after them."""
    STARTS[start]()
    out = []
    for shape, k in zip(shapes, keep):
        M = np.random.normal(0, 1, shape)
        out.append(M.astype(np.float32) if k else None)
    return out, state_after()


def twin_draws(start, shapes, keep, segment_blocks=init_draw.SEGMENT_BLOCKS,
               dtype=torch.float32):
    """The twin's draws from ``start``, with segments of ``segment_blocks``
    blocks, and the state after them."""
    STARTS[start]()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(init_draw, "SEGMENT_BLOCKS", segment_blocks)
        out = [legacy_normal(shape, dtype, "cpu", keep=k) for shape, k in zip(shapes, keep)]
    return out, state_after()


def assert_same(got, want, dtype=torch.float32):
    (g_out, g_state), (w_out, w_state) = got, want
    for g, w in zip(g_out, w_out):
        if w is None:
            assert g is None
        else:
            assert g.dtype == dtype and tuple(g.shape) == w.shape
            assert torch.equal(g, torch.from_numpy(w).to(dtype))
    assert same_state(g_state, w_state)


@pytest.mark.parametrize("start,shape,segment_blocks", CASES)
def test_twin_is_numpys_stream(start, shape, segment_blocks):
    assert_same(twin_draws(start, [shape], [True], segment_blocks),
                host_draws(start, [shape], [True]))


@pytest.mark.parametrize("start", ["seeded", "cached", "straddle"])
def test_twin_bf16_is_numpys_stream_cast(start):
    """bf16 storage: the f32 draw rounded once more, as the host's
    ``.to(torch.bfloat16)``."""
    assert_same(twin_draws(start, [(90, 91)], [True], 1, torch.bfloat16),
                host_draws(start, [(90, 91)], [True]), torch.bfloat16)


@pytest.mark.parametrize("start", ["seeded", "cached", "unseeded"])
def test_twin_constrained_triple(start):
    """MapperConstrained's three draws in turn, the state carried: one
    discarded draw of M's shape (which moves the state only), M, then F."""
    shapes, keep = [(40, 33), (40, 33), (40,)], [False, True, True]
    assert_same(twin_draws(start, shapes, keep, 1), host_draws(start, shapes, keep))


@pytest.mark.parametrize("start", ["seeded", "straddle", "cached"])
def test_twin_count_ends_on_a_segment_boundary(start):
    """A draw whose last pair is the last attempt of a segment: the state
    after it is the next segment's checkpoint, at pos0."""
    STARTS[start]()
    _, key, pos, has_gauss, _ = np.random.get_state()
    ckpt = init_draw._checkpoints_plain(key, pos, 1, 6)
    pos0 = pos % 624
    counts = [init_draw._segment_plain(c, pos0, 1)[5] for c in ckpt]
    k = next(k for k in range(1, 6) if counts[k][-1])
    pairs = int(sum(c.sum() for c in counts[:k + 1]))
    n = 2 * pairs + int(has_gauss)
    twin = twin_draws(start, [(n,)], [True], 1)
    assert_same(twin, host_draws(start, [(n,)], [True]))
    key_after, pos_after = twin[1][0], twin[1][1]
    assert pos_after == (pos0 if pos0 else 624)
    assert np.array_equal(key_after, ckpt[k + 1] if pos0 else ckpt[k])


def test_twin_redraws_after_a_short_bound(monkeypatch):
    """Checkpoints for too few attempts: the draw runs again on twice as
    many, with the same result."""
    monkeypatch.setattr(init_draw, "_attempt_bound", lambda pairs: pairs // 3)
    assert_same(twin_draws("seeded", [(70, 71)], [True], 1),
                host_draws("seeded", [(70, 71)], [True]))


def test_near_midpoint_outputs_take_the_hosts_libm(monkeypatch):
    """An output within NEAR_TIE ulps of an f32 rounding midpoint is
    recomputed with the host's libm. A log off by ~2^17 ulps (far more than
    the card's 1 ulp) moves some f32 roundings; a window wider than that
    puts every one right again, and without the window some stay wrong."""
    log = np.log
    monkeypatch.setattr(np, "log", lambda x: log(x) * (1 + 2.0 ** -35))
    shape = (300, 333)
    want = host_draws("seeded", [shape], [True])
    monkeypatch.setattr(init_draw, "NEAR_TIE", -1)
    off = twin_draws("seeded", [shape], [True], 4)
    assert (off[0][0] != torch.from_numpy(want[0][0])).sum() > 0
    monkeypatch.setattr(init_draw, "NEAR_TIE", 1 << 20)
    assert_same(twin_draws("seeded", [shape], [True], 4), want)


def test_mt_regen_plain_is_numpys_block():
    """The twin's block regeneration (the kernel's three runs) gives the
    words numpy reads after the block: a seeded state's next 624 raw words,
    read through random_sample's tempering."""
    np.random.seed(123)
    _, key, pos, _, _ = np.random.get_state()
    assert pos == 624
    block = init_draw.mt_regen_plain(key)
    words = init_draw._temper(block)
    a, b = (words[0::2] >> np.uint32(5)).astype(np.float64), \
        (words[1::2] >> np.uint32(6)).astype(np.float64)
    assert np.array_equal((a * 67108864.0 + b) / 9007199254740992.0, np.random.random(312))


def test_empty_and_rejected_arguments():
    STARTS["cached"]()
    before = state_after()
    STARTS["cached"]()
    out = legacy_normal((0, 5))
    assert out.shape == (0, 5) and same_state(state_after(), before)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        legacy_normal((2, 2), torch.float64)


# ---------------------------------------------------------------------------
# routing in models/mapper.py
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")


@pytest.mark.parametrize("method,n,device,mesh,where", [
    ("numpy", 10**8, CUDA, None, CUDA),
    ("auto", 10**8, CUDA, None, CUDA),
    ("auto", 10**8, CUDA, "mesh", "cpu"),
    ("numpy", 10**8, torch.device("cpu"), None, "cpu"),
    ("auto", 2**31, CUDA, None, CUDA),
    ("jax", 10, CUDA, "mesh", CUDA),
])
def test_draw_device(method, n, device, mesh, where):
    assert mp._draw_device(method, n, device, mesh) == where


def test_draw_dtype_is_storage_only_for_the_numpy_stream_on_the_card():
    bf16 = torch.bfloat16
    assert mp._draw_dtype("auto", 10**8, CUDA, bf16) == bf16
    assert mp._draw_dtype("numpy", 10**8, "cpu", bf16) == torch.float32
    assert mp._draw_dtype("auto", 2**31, CUDA, bf16) == torch.float32  # torch.randn
    assert mp._draw_dtype("jax", 10, CUDA, bf16) == torch.float32


def card_recorder(monkeypatch):
    """The kernels' entry replaced by a recorder that draws with the twin
    on the CPU, and the host's draw made to fail: the list of its calls."""
    calls = []

    def card(shape, dtype, device, keep=True):
        calls.append((shape, dtype, device, keep))
        return legacy_normal(shape, dtype, "cpu", keep=keep)

    def host(*args, **kwargs):
        raise AssertionError("the host drew the numpy stream")

    monkeypatch.setattr(mp, "legacy_normal", card)
    monkeypatch.setattr(mp.np.random, "normal", host)
    return calls


@pytest.mark.parametrize("shape", [(1,), (7,), (300, 401)])
def test_numpy_stream_on_a_cuda_device_takes_the_kernels(monkeypatch, shape):
    """On a CUDA device every draw of the numpy stream goes to the kernels,
    whatever its size, in the storage type asked for."""
    STARTS["seeded"]()
    with monkeypatch.context() as patch:
        calls = card_recorder(patch)
        got = mp._numpy_stream(shape, torch.bfloat16, CUDA)
        after = state_after()
    assert calls == [(shape, torch.bfloat16, CUDA, True)]
    want, want_state = host_draws("seeded", [shape], [True])
    assert torch.equal(got, torch.from_numpy(want[0]).to(torch.bfloat16))
    assert same_state(after, want_state)


def test_constrained_draws_on_a_cuda_device_take_the_kernels(monkeypatch):
    """MapperConstrained's three draws on a CUDA device, each to the
    kernels in turn: the discarded one (nothing kept), M in its storage
    type, then F in f32."""
    c, s = 40, 33
    with monkeypatch.context() as patch:
        calls = card_recorder(patch)
        M, F = mp.init_constrained_logits(c, s, 11, "numpy", device=CUDA, dtype=torch.bfloat16)
        after = state_after()
    assert calls == [((c, s), torch.float32, CUDA, False), ((c, s), torch.bfloat16, CUDA, True),
                     ((c,), torch.float32, CUDA, True)]
    want, want_state = host_draws("seeded_11", [(c, s), (c, s), (c,)], [False, True, True])
    assert torch.equal(M, torch.from_numpy(want[1]).to(torch.bfloat16))
    assert torch.equal(F, torch.from_numpy(want[2]))
    assert same_state(after, want_state)


def test_init_logits_on_the_cpu_keeps_the_host_draw(monkeypatch):
    """Every CPU run keeps np.random.normal (the twin is the kernels'
    stand-in in the tests only): the seeded start and the state after."""
    monkeypatch.setattr(mp, "legacy_normal", None)  # never called on the CPU
    M = mp.init_logits(40, 30, 7, "auto", device="cpu")
    after = state_after()
    np.random.seed(7)
    assert torch.equal(M, torch.from_numpy(np.random.normal(0, 1, (40, 30)).astype(np.float32)))
    assert same_state(after, state_after())
