"""The PyTorch port's kernel twins against the JAX package's Pallas kernels.

Each CUDA kernel of ``tangram_tpu_torch`` has a plain PyTorch twin, which
its wrapper runs for CPU tensors. Here every twin gets the same seeded
numpy inputs as the JAX function it replaces, which runs its Pallas kernel
in interpret mode on the CPU (as ``tests/test_pallas_core.py`` runs it).
The CUDA kernels themselves are held against these twins on the card by
``chip_smoke.py``.

Tolerance: rtol = atol = 1e-5 throughout (the unfused backward and the
``MapperCore`` gradients included), except for the Adafactor
statistics (vr, vc), which are small sums of squares and are held at
1e-5 of their largest entry, and dM of a bf16 M, stored in bf16 by both
sides: within one bf16 ulp beyond 1e-5 of its largest entry (each rounds
the same f32 value up to summation order, so they part only next to a
rounding midpoint). Both sides compute in f32; they differ only in
summation order and in the exp implementation (about one ulp), which moves
results by far less than 1e-5 at these sizes. The norm cases plant one
padding sentinel (``PAD`` < ``PAD_GUARD``) in M.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tangram_tpu.ops import fused_step as jfs
from tangram_tpu.ops import pallas_core as jpc
from tangram_tpu_torch.models.mapper import fit_mapping
from tangram_tpu_torch.ops import cuda_core as cc
from tangram_tpu_torch.ops import fused_step as fs
from tangram_tpu_torch.ops.core import mapper_core_reference, resolve_impl
from tangram_tpu_torch.ops.losses import LossWeights, MapperData

RTOL = ATOL = 1e-5
PAD = -1e25  # a padding sentinel: below PAD_GUARD, so it takes no norm
# (lambda_l1, lambda_l2) of the L1/L2 cases: each alone and both
NORMS = [(0.01, 0.0), (0.0, 0.02), (0.01, 0.02)]
SHAPES = [
    (8, 16, 4),       # tiny
    (300, 600, 7),    # ragged in every dimension
    (257, 513, 129),  # one past a tile boundary
]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inputs(c, s, k, seed=0, pad=False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    M = rng.normal(0, 1, (c, s)).astype(f32)
    if pad:
        M[0, 1 % s] = PAD
    return dict(
        M=M,
        A=rng.poisson(1.5, (c, k)).astype(f32),
        w=(rng.random(c) / c).astype(f32),
        dY=(rng.normal(0, 0.1, (s, k))).astype(f32),
        dq=rng.normal(0, 1, s).astype(f32),
        dh=rng.normal(0, 0.1, c).astype(f32),
        mu=rng.normal(0, 1e-3, (c, s)).astype(f32),
        nu=(rng.random((c, s)) * 1e-6).astype(f32),
    )


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def jax_stats(M):
    return [np.asarray(x) for x in jpc._rowstats(jnp.asarray(M))]


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rowstats_twin_matches_jax(c, s, k):
    x = make_inputs(c, s, k)
    got = cc._rowstats(T(x["M"]))
    for g, w in zip(got, jax_stats(x["M"])):
        assert tuple(g.shape) == w.shape == (c, 1)
        close(g, w)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_project_twin_matches_jax(c, s, k):
    x = make_inputs(c, s, k)
    m, l, _ = jax_stats(x["M"])
    Yj, qj = jpc._project(jnp.asarray(x["M"]), jpc._pad_k(jnp.asarray(x["A"])),
                          jnp.asarray(x["w"]), jnp.asarray(m), jnp.asarray(l))
    Y, q = cc._project(T(x["M"]), T(x["A"]), T(x["w"]), T(m), T(l))
    assert tuple(Y.shape) == (s, k) and tuple(q.shape) == (s,)
    close(Y, np.asarray(Yj)[:, :k])
    close(q, qj)


def jax_rbar(x, m, l, with_dh):
    return jfs._rbar(
        jnp.asarray(x["M"]), jpc._pad_k(jnp.asarray(x["A"])), jnp.asarray(x["w"]),
        jnp.asarray(m), jnp.asarray(l), jpc._pad_k(jnp.asarray(x["dY"])),
        jnp.asarray(x["dq"]), jnp.asarray(x["dh"]), with_dh=with_dh,
    )


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rbar_twin_matches_jax(c, s, k, with_dh):
    x = make_inputs(c, s, k)
    m, l, _ = jax_stats(x["M"])
    r = fs._rbar(T(x["M"]), T(x["A"]), T(x["w"]), T(m), T(l), T(x["dY"]),
                 T(x["dq"]), T(x["dh"]), with_dh=with_dh)
    assert tuple(r.shape) == (c, 1)
    close(r, jax_rbar(x, m, l, with_dh))


def test_adam_scalars_match_jax():
    for step in (1, 2, 3, 25, 1000):
        t = jnp.asarray(step).astype(jnp.float32)
        want = (np.float32(0.1), np.asarray(1.0 - jfs.BETA1 ** t),
                np.asarray(1.0 - jfs.BETA2 ** t))
        got = fs.adam_scalars(step, 0.1)
        np.testing.assert_array_equal(np.float32(got), np.float32(want))


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_adam_twin_matches_jax(c, s, k, with_dh):
    """f32 storage, no L1/L2 norms, round to nearest: the main path."""
    x = make_inputs(c, s, k)
    m, l, _ = jax_stats(x["M"])
    r = np.asarray(jax_rbar(x, m, l, with_dh))
    step = 3
    lr, bc1, bc2 = fs.adam_scalars(step, 0.1)
    scalars = jnp.asarray([[lr, bc1, bc2, float(step)]], jnp.float32)
    want = jfs._dm_adam(
        jnp.asarray(x["M"]), jpc._pad_k(jnp.asarray(x["A"])), jnp.asarray(x["w"]),
        jnp.asarray(m), jnp.asarray(l), jpc._pad_k(jnp.asarray(x["dY"])),
        jnp.asarray(x["dq"]), jnp.asarray(x["dh"]), jnp.asarray(r),
        jnp.asarray(x["mu"]), jnp.asarray(x["nu"]), scalars, 0.0, 0.0,
        with_norms=False, with_dh=with_dh,
    )
    M, mu, nu = T(x["M"]), T(x["mu"]), T(x["nu"])
    got = fs._dm_adam(M, T(x["A"]), T(x["w"]), T(m), T(l), T(x["dY"]),
                      T(x["dq"]), T(x["dh"]), T(r), mu, nu, (lr, bc1, bc2),
                      with_dh=with_dh)
    assert len(got) == len(want) == 6
    # M, mu and nu are updated in place, as the JAX kernel aliases them
    assert got[0] is M and got[1] is mu and got[2] is nu
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        close(g, w)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rowstats_norms_twin_matches_jax(c, s, k):
    x = make_inputs(c, s, k, pad=True)
    got = fs._rowstats_norms(T(x["M"]))
    want = jfs._rowstats_norms(jnp.asarray(x["M"]))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape == (c, 1)
        close(g, w)
    # the sentinel takes no norm
    z = np.where(x["M"] > fs.PAD_GUARD, x["M"], 0.0)
    close(got[3][:, 0], np.abs(z).sum(axis=1))


def jax_args(x, m, l):
    return (jnp.asarray(x["M"]), jpc._pad_k(jnp.asarray(x["A"])), jnp.asarray(x["w"]),
            jnp.asarray(m), jnp.asarray(l), jpc._pad_k(jnp.asarray(x["dY"])),
            jnp.asarray(x["dq"]), jnp.asarray(x["dh"]))


def torch_args(x, m, l):
    return (T(x["M"]), T(x["A"]), T(x["w"]), T(m), T(l), T(x["dY"]), T(x["dq"]),
            T(x["dh"]))


@pytest.mark.parametrize("lam", NORMS)
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_adam_norms_twin_matches_jax(c, s, k, with_dh, lam):
    """The L1/L2 branch: the gradient gains λ₁·sign(M) + 2λ₂·M and the
    kernel also emits the next s1, s2."""
    x = make_inputs(c, s, k, pad=True)
    m, l, _ = jax_stats(x["M"])
    r = np.asarray(jax_rbar(x, m, l, with_dh))
    lr, bc1, bc2 = fs.adam_scalars(2, 0.1)
    scalars = jnp.asarray([[lr, bc1, bc2, 2.0]], jnp.float32)
    want = jfs._dm_adam(*jax_args(x, m, l), jnp.asarray(r), jnp.asarray(x["mu"]),
                        jnp.asarray(x["nu"]), scalars, *lam, with_norms=True,
                        with_dh=with_dh)
    got = fs._dm_adam(*torch_args(x, m, l), T(r), T(x["mu"]), T(x["nu"]),
                      (lr, bc1, bc2), with_dh=with_dh, lam_l1=lam[0],
                      lam_l2=lam[1], with_norms=True)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        close(g, w)


def close_to_scale(got, want):
    """|got − want| ≤ 1e-5 · max |want|: for sums of small squares."""
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def jax_gsq(x, m, l, r, lam, with_dh):
    return jfs._gsq(*jax_args(x, m, l), jnp.asarray(r), *lam, with_dh=with_dh)


@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.01, 0.02)])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_gsq_twin_matches_jax(c, s, k, with_dh, lam):
    x = make_inputs(c, s, k, pad=lam != (0.0, 0.0))
    m, l, _ = jax_stats(x["M"])
    r = np.asarray(jax_rbar(x, m, l, with_dh))
    vr_j, vc_j = jax_gsq(x, m, l, r, lam, with_dh)
    vr, vc = fs._gsq(*torch_args(x, m, l), T(r), *lam, with_dh=with_dh)
    assert tuple(vr.shape) == (c,) and tuple(vc.shape) == (s,)
    close_to_scale(vr, vr_j)
    close_to_scale(vc, vc_j)


@pytest.mark.parametrize("with_norms", [False, True])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_adafactor_twin_matches_jax(c, s, k, with_dh, with_norms):
    """The update at the factors of this step's own statistics (count 0)."""
    lam = (0.01, 0.02) if with_norms else (0.0, 0.0)
    x = make_inputs(c, s, k, pad=with_norms)
    m, l, _ = jax_stats(x["M"])
    r = np.asarray(jax_rbar(x, m, l, with_dh))
    vr_sum, vc_sum = jax_gsq(x, m, l, r, lam, with_dh)
    _, _, rowf, colf = jfs.factored_rms_vectors(
        jnp.zeros((), jnp.int32), jnp.zeros((c,)), jnp.zeros((s,)), vr_sum, vc_sum,
        c, s)
    want = jfs._dm_adafactor(*jax_args(x, m, l), jnp.asarray(r), rowf, colf,
                             jnp.asarray([[0.1, 1.0]], jnp.float32), *lam,
                             with_norms=with_norms, with_dh=with_dh)
    M = T(x["M"])
    got = fs._dm_adafactor(M, *torch_args(x, m, l)[1:], T(r), T(rowf), T(colf),
                           0.1, *lam, with_norms=with_norms, with_dh=with_dh)
    assert len(got) == len(want) == (6 if with_norms else 4)
    assert got[0] is M  # updated in place
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        close(g, w)


def close_bf16(got, want):
    """Stored bf16 values: within one bf16 ulp of ``want`` beyond RTOL of
    its largest entry."""
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    over = np.abs(got - want) - RTOL * np.abs(want).max()
    assert float((over / ulp).max()) <= 1.0


@pytest.mark.parametrize("m_bf16", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_backward_twin_matches_jax(c, s, k, m_bf16):
    """The unfused backward's two passes (rbar with dh, then dM, dA, dw)
    against ``pallas_core._backward``; JAX pads k to 128, so its dA is
    sliced back to k columns. With a bf16 M (A and dY f32), dM comes back
    in bf16 on both sides."""
    x = make_inputs(c, s, k)
    if m_bf16:
        x["M"] = np.asarray(jnp.asarray(x["M"]).astype(jnp.bfloat16).astype(jnp.float32))
    M_j = jnp.asarray(x["M"]).astype(jnp.bfloat16 if m_bf16 else jnp.float32)
    m, l, _ = [np.asarray(v) for v in jpc._rowstats(M_j)]
    dM_j, dA_j, dw_j = jpc._backward(M_j, *jax_args(x, m, l)[1:])
    M = T(x["M"]).to(torch.bfloat16 if m_bf16 else torch.float32)
    dM, dA, dw = cc._backward(M, *torch_args(x, m, l)[1:])
    assert (tuple(dM.shape), tuple(dA.shape), tuple(dw.shape)) == ((c, s), (c, k), (c,))
    assert dM.dtype == M.dtype and dA.dtype == dw.dtype == torch.float32
    if m_bf16:
        assert dM_j.dtype == jnp.bfloat16
        close_bf16(dM, dM_j)
    else:
        close(dM, dM_j)
    close(dA, np.asarray(dA_j)[:, :k])
    close(dw, dw_j)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_backward_tf32_twin_matches_jax_and_float64(c, s, k):
    """dM, dA and dw as the tensor-core dm_backward kernel forms them (both
    products from three TF32 terms of split operands) against the JAX
    kernel (interpret mode) at the twins' tolerance, and against a float64
    backward within 1e-6 of each output's largest entry."""
    x = make_inputs(c, s, k)
    A = fractional(x["A"])
    m, l, _ = jax_stats(x["M"])
    args = (T(x["M"]), T(A)) + torch_args(x, m, l)[2:]
    r = cc._rbar_plain(*args)
    got = cc.dm_backward_tf32_plain(*args, r)
    x_j = dict(x, A=A)
    dM_j, dA_j, dw_j = jpc._backward(*jax_args(x_j, m, l))
    for g, w in zip(got, (dM_j, np.asarray(dA_j)[:, :k], dw_j)):
        close(g, w)
    Md, Ad, wd, md, ld, dYd, dqd, dhd = (t.double() for t in args)
    P = torch.exp(Md - md) / ld
    dP = Ad @ dYd.T + wd[:, None] * dqd[None, :] + dhd[:, None] * ((Md - md - torch.log(ld)) + 1.0)
    want = (P * (dP - r.double()), P @ dYd, P @ dqd)
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 1e-6 * float(w.abs().max())


def core_grads(core, x, cts):
    """Values and (dM, dA, dw) of Σ Y⊙gY + Σ q⊙gq [+ Σ h⊙gh] through
    ``core``; without gh the loss leaves h out, so h has no cotangent."""
    with torch.enable_grad():
        leaves = [T(x[n]).requires_grad_() for n in ("M", "A", "w")]
        outs = core(*leaves)
        loss = sum((o * g).sum() for o, g in zip(outs, cts))
        return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("with_h", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_mapper_core_gradients_match_autograd_reference(c, s, k, with_h):
    """MapperCore (the kernels' twins on the CPU) against autograd through
    the materialized core, with seeded cotangents."""
    x = make_inputs(c, s, k)
    rng = np.random.default_rng(5)
    shapes = ((s, k), (s,), (c,))[:3 if with_h else 2]
    cts = [T(rng.normal(0, 1, shape)) for shape in shapes]
    out, got = core_grads(cc.MapperCore.apply, x, cts)
    out_r, want = core_grads(mapper_core_reference, x, cts)
    for g, w in zip(out + list(got), out_r + list(want)):
        assert g.shape == w.shape
        close(g, w)


@pytest.mark.parametrize("c,s", [(13, 21), (21, 13)])
def test_factored_rms_vectors_match_jax(c, s):
    """Both orientations, from zero and from carried statistics; rtol 1e-6
    as ``tests/test_adafactor.py:59-87`` holds the JAX bookkeeping to optax."""
    rng = np.random.default_rng(c)
    vr, vc = np.zeros(c, np.float32), np.zeros(s, np.float32)
    for count in range(3):
        g = rng.normal(0, 1e-2, (c, s)).astype(np.float32)
        sums = ((g * g).sum(axis=1), (g * g).sum(axis=0))
        want = jfs.factored_rms_vectors(jnp.asarray(count, jnp.int32), jnp.asarray(vr),
                                        jnp.asarray(vc), *map(jnp.asarray, sums), c, s)
        got = fs.factored_rms_vectors(count, T(vr), T(vc), *map(T, sums), c, s)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        vr, vc = np.asarray(want[0]), np.asarray(want[1])


def test_adafactor_decay_uses_the_pre_increment_count():
    """decay = 1 − (count + 1)^−0.8: 0 at the first step, as optax's."""
    assert fs.adafactor_decay(0) == (0.0, 1.0)
    for count in (1, 2, 9, 999):
        want = 1.0 - (jnp.asarray(count, jnp.int32).astype(jnp.float32) + 1.0) ** -0.8
        decay, one_minus = fs.adafactor_decay(count)
        assert decay == pytest.approx(float(want), rel=1e-6)
        assert one_minus == float(np.float32(1.0) - np.float32(decay))


def test_cpu_tensors_never_launch_and_kernels_impl_raises():
    x = make_inputs(12, 20, 3)
    cc.reset_launches()
    M = T(x["M"])
    F = T(x["dh"])
    data = MapperData(S=T(x["A"]), G=T(np.abs(x["dY"][:, :3]) + 0.1),
                      target_count=torch.tensor(5.0))
    norms = LossWeights(lambda_l1=0.01, lambda_l2=0.01)
    for lw in (LossWeights(), norms):
        for optimizer in ("adam", "adafactor"):
            for impl in ("fused", "reference"):
                for fused in (True, False):
                    fit_mapping(M.clone(), data, lw, 3, impl=impl, optimizer=optimizer,
                                fused=fused, with_val=True)
    for optimizer in ("adam", "adafactor"):
        fit_mapping((M.clone(), F.clone()), data, LossWeights(), 3, impl="fused",
                    optimizer=optimizer, constrained=True)
    m, l, _ = cc._rowstats(M)
    cc._project(M, T(x["A"]), T(x["w"]), m, l)
    kernels = {"rowstats", "project", "rbar", "dm_adam", "rowstats_norms", "gsq",
               "dm_adafactor", "backward_rbar", "dm_backward", "init_normal", "dp_wgmma"}
    # and the graph terms' spot-graph products, which have no bf16 variant
    assert set(cc.LAUNCHES) == kernels | {name + ".bf16" for name in kernels} | {"graph"}
    assert not any(cc.LAUNCHES.values())
    assert resolve_impl("auto", M) == "reference"
    with pytest.raises(ValueError, match="kernels"):
        resolve_impl("kernels", M)
    with pytest.raises(ValueError, match="kernels"):
        fit_mapping(M.clone(), data, LossWeights(), 1, impl="kernels")
    with pytest.raises(ValueError, match="impl"):
        resolve_impl("pallas", M)
    with pytest.raises(ValueError, match="optimizer"):
        fit_mapping(M.clone(), data, LossWeights(), 1, optimizer="sgd")


def test_project_split_count():
    """The cell split of the project kernel (one block of 64 spots x 256
    columns per SM): at the tutorial shape the split that fills whole waves
    of 132 blocks (6: 154 spot tiles x 6 = 924 blocks, 7 waves), none for
    clusters mode's few cells (154 spot tiles alone), one wave of 132
    blocks where one spot tile is all there is, fewer with two column
    panels (k = 300)."""
    assert cc.project_splits(26_000, 9_852, 249, sm_count=132) == 6
    assert cc.project_splits(22, 9_852, 249, sm_count=132) == 1
    assert cc.project_splits(10**6, 64, 3, sm_count=132) == 132
    assert cc.project_splits(26_000, 9_852, 300, sm_count=132) == 3
    # every split owns whole 16-cell chunks, and none is empty
    for c, s, k in ((26_000, 9_852, 249), (5_000, 9_852, 249), (37, 53, 7), (530, 52, 9)):
        n = cc.project_splits(c, s, k, sm_count=132)
        chunks = -(-c // 16)
        assert 1 <= n <= chunks and -(-chunks // -(-chunks // n)) == n


def test_dp_split_count():
    """The spot split of the rbar / dm_adam kernels (the tensor-core tile,
    one block of 64 cells x 128-spot tiles per SM): at the tutorial shape the
    split that fills whole waves of 132 blocks best (7: 2,849 blocks, 21.6
    waves, 11 tiles each), one 128-spot tile per block for clusters mode's
    one cell group, none where one tile is all there is."""
    assert cc.dp_splits(26_000, 9_852, sm_count=132) == 7
    assert cc.dp_splits(22, 9_852, sm_count=132) == 77
    assert cc.dp_splits(5_000, 9_852, sm_count=132) == 5
    assert cc.dp_splits(64, 100, sm_count=132) == 1
    # every block gets at least one tile, and no split is empty
    for c, s in ((26_000, 9_852), (5_000, 9_852), (130, 1_000), (64, 129)):
        n = cc.dp_splits(c, s, sm_count=132)
        tiles = -(-s // 128)
        assert 1 <= n <= tiles and -(-tiles // -(-tiles // n)) == n


def test_dp_fma_split_count():
    """The f32 FMA dP tile and its own spot split are gone: gsq runs on the
    tensor-core tile with the split of every dP-tile kernel (``dp_splits``:
    7 at the tutorial shape, 77 for clusters mode), so no entry point, no
    wrapper and no kernel source keeps the FMA tile or its transposed
    [A | w]ᵀ, [dY | dq]ᵀ operands."""
    from tangram_tpu_torch.ops import _build

    assert not hasattr(cc, "dp_fma_splits") and not hasattr(cc, "_dp_kernel_args")
    assert "tg_gsq" not in _build.SIGNATURES and "tg_gsq_tc" in _build.SIGNATURES
    csrc = os.path.join(REPO, "tangram_tpu_torch", "csrc")
    with open(os.path.join(csrc, "mapper_kernels.cu")) as f:
        rowstats_source = f.read()
    with open(os.path.join(csrc, "dp_tensor_kernels.cu")) as f:
        tile_source = f.read()
    for name in ("gsq_kernel", "GsqArgs", "tg_gsq(", "DP_KC"):
        assert name not in rowstats_source
    assert "TC_GSQ" in tile_source and 'extern "C" int tg_gsq_tc(' in tile_source
    assert cc.dp_splits(26_000, 9_852, sm_count=132) == 7
    assert cc.dp_splits(22, 9_852, sm_count=132) == 77


# ---------------------------------------------------------------------------
# the tensor-core dP tile: the TF32 split, its product and the operands
# ---------------------------------------------------------------------------


def split_inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 6, n)
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_split_parts_are_tf32_and_sum_to_x():
    x = split_inputs()
    hi, lo = cc.tf32_split(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi + lo is exact in f32 (no overlap), so the sum is taken in f64
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -21
    # hi alone is x to TF32's 11 significant bits
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11


def test_tf32_split_of_bf16_values_has_no_low_part():
    x = split_inputs(1).to(torch.bfloat16).float()
    hi, lo = cc.tf32_split(x)
    assert torch.equal(hi, x)
    assert int((lo != 0).sum()) == 0


def test_tf32_split_edge_values_stay_finite():
    big = float(np.finfo(np.float32).max)
    x = torch.tensor([0.0, -0.0, 1e-45, -1e-40, 1.17549435e-38, big, -big, 1.0, -3.0],
                     dtype=torch.float32)
    hi, lo = cc.tf32_split(x)
    assert bool(torch.isfinite(hi).all()) and bool(torch.isfinite(lo).all())
    assert float((hi[:2].abs() + lo[:2].abs()).max()) == 0.0
    # the largest f32 is truncated, not rounded up to infinity
    assert float(hi[5]) <= big and float(hi[6]) >= -big
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err[4:] / x[4:].double().abs()).max()) <= 2.0 ** -21
    with pytest.raises(TypeError, match="float32"):
        cc.tf32_split(x.double())


def test_three_tf32_terms_keep_f32_accuracy_and_one_does_not():
    """K = 250: the three-term product of split operands within 1e-6 of a
    float64 product (of its largest entry), the single TF32 pass beyond
    1e-4: the fault the kernels' accuracy witness exists for."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(0, 1, (64, 250)).astype(np.float32))
    dY = torch.from_numpy(rng.normal(0, 1, (96, 250)).astype(np.float32))
    want = A.double() @ dY.double().T
    scale = float(want.abs().max())
    three = float((cc.tf32_product_plain(A, dY).double() - want).abs().max()) / scale
    one = float((cc.tf32_product_plain(A, dY, terms=1).double() - want).abs().max()) / scale
    assert three <= 1e-6 < 1e-4 < one, (three, one)


@pytest.mark.parametrize("signed", [False, True])
def test_second_product_three_tf32_terms_keep_f32_accuracy_and_one_does_not(signed):
    """dm_backward's second product [dA | dw] = P [dY | dq] over a deep
    spot axis (6,000 spots; P a softmax, every entry > 0): the three-term
    product of split operands within 1e-6 of a float64 product (of its
    largest entry), the single TF32 pass beyond 1e-4 on centred
    cotangents and beyond 5e-5 on positive ones (``signed`` False: every
    term >= 0, where a truncated running sum would show as a one-sided
    bias and one rounding of each factor partly averages out)."""
    rng = np.random.default_rng(2)
    c, s, k = 48, 6_000, 24
    P = torch.softmax(T(rng.normal(0, 2, (c, s))), dim=1)
    dY = rng.normal(0, 1, (s, k)) + (0.0 if signed else 3.0)
    dY, dq = T(dY), T(rng.normal(0, 1, s) + (0.0 if signed else 3.0))
    want = (P.double() @ dY.double(), P.double() @ dq.double())

    def err(terms):
        got = cc.ext_product_tf32_plain(P, dY, dq, terms)
        return max(float((g.double() - t).abs().max()) / float(t.abs().max())
                   for g, t in zip(got, want))

    three, one = err(3), err(1)
    assert three <= 1e-6 < (1e-4 if signed else 5e-5) < one, (three, one)


@pytest.mark.parametrize("k", [1, 7, 31, 32, 249, 256, 300])
def test_backward_operands_layout(k):
    """The unfused backward's operands: A and [dY | dq], f32, K-major,
    padded with zeros to a multiple of 32 past k (A's column k is 0, so
    the dP product ignores dq), 16-byte aligned; their product plus the
    rank-one term is A dYᵀ + w ⊗ dq, and the second product's operand
    holds [dY | dq]."""
    x = make_inputs(9, 13, k)
    A, dY, w, dq = T(x["A"]), T(x["dY"]), T(x["w"]), T(x["dq"])
    ops = cc.backward_operands(A, dY, dq)
    Kp = ops.A_op.shape[1]
    assert ops.split and ops.ext and Kp % 32 == 0 and 0 < Kp - k <= 32
    assert tuple(ops.A_op.shape) == (9, Kp) and tuple(ops.dY_op.shape) == (13, Kp)
    assert ops.A_op.data_ptr() % 16 == 0 and ops.dY_op.data_ptr() % 16 == 0
    assert torch.equal(ops.A_op[:, :k], A) and float(ops.A_op[:, k:].abs().sum()) == 0
    assert torch.equal(ops.dY_op[:, :k], dY) and torch.equal(ops.dY_op[:, k], dq)
    assert float(ops.dY_op[:, k + 1:].abs().sum()) == 0
    want = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    got = cc.dp_from_operands_plain(ops, w, dq)
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_dm_backward_takes_only_backward_operands():
    """dm_backward's second product reads dq from its operand, so the step
    operands of the fused kernels (no dq column) are refused, on the CPU
    too; with its own operands it equals the call that builds them."""
    x = make_inputs(12, 40, 5)
    m, l, _ = jax_stats(x["M"])
    args = torch_args(x, m, l)
    r = cc._rbar_plain(*args)
    with pytest.raises(ValueError, match="backward_operands"):
        cc._dm_backward(*args, r, operands=cc.dp_operands(args[1], args[5]))
    ops = cc.backward_operands(args[1], args[5], args[6])
    for a, b in zip(cc._dm_backward(*args, r, operands=ops), cc._dm_backward(*args, r)):
        assert torch.equal(a, b)


def fractional(x, seed=5):
    """Counts plus a seeded fraction: small integers are exact in TF32 and
    would hide a rounded operand."""
    rng = np.random.default_rng(seed)
    return (x + rng.random(x.shape)).astype(np.float32)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_project_tf32_twin_matches_jax_and_float64(c, s, k):
    """project's Y and q as the tensor-core kernel forms them (the three-term
    TF32 product of P and [A | w]) against the JAX kernel (interpret mode)
    at the twins' tolerance, and against a float64 projection within 1e-6 of
    its largest entry."""
    x = make_inputs(c, s, k)
    A = fractional(x["A"])
    m, l, _ = jax_stats(x["M"])
    Yj, qj = jpc._project(jnp.asarray(x["M"]), jpc._pad_k(jnp.asarray(A)),
                          jnp.asarray(x["w"]), jnp.asarray(m), jnp.asarray(l))
    Y, q = cc.project_tf32_plain(T(x["M"]), T(A), T(x["w"]), T(m), T(l))
    assert tuple(Y.shape) == (s, k) and tuple(q.shape) == (s,)
    close(Y, np.asarray(Yj)[:, :k])
    close(q, qj)
    P = torch.exp(T(x["M"]).double() - T(m).double()) / T(l).double()
    for got, want in ((Y, P.T @ T(A).double()), (q, T(x["w"]).double() @ P)):
        assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("signed", [False, True])
def test_project_single_tf32_pass_misses(signed):
    """2,000 cells: the three-term product within 1e-6 of a float64
    projection (of its largest entry), a single TF32 pass beyond 1e-5 on
    the counts (every term >= 0) and beyond 1e-4 on signed operands, where
    its rounding does not average out; the fault the kernel's accuracy
    witness exists for."""
    rng = np.random.default_rng(4)
    c, s, k = 2_000, 40, 12
    M = T(rng.normal(0, 1, (c, s)))
    A = fractional(rng.poisson(1.5, (c, k)))
    w = rng.random(c) / c
    if signed:
        A, w = A - A.mean(axis=0), w * np.where(rng.random(c) < 0.5, -1.0, 1.0)
    A, w = T(A), T(w)
    m, l, _ = cc._rowstats_plain(M)
    P = torch.exp(M.double() - m.double()) / l.double()
    want = (P.T @ A.double(), w.double() @ P)

    def err(terms):
        got = cc.project_tf32_plain(M, A, w, m, l, terms)
        return max(float((g.double() - t).abs().max()) / float(t.abs().max())
                   for g, t in zip(got, want))

    three, one = err(3), err(1)
    assert three <= 1e-6 < (1e-4 if signed else 1e-5) < one, (three, one)


@pytest.mark.parametrize("k", [1, 3, 4, 7, 249, 255, 256, 300])
def test_project_operand_layout(k):
    """The project kernel's X operand: for an f32 A, [A | w] with rows of
    k + 1 rounded up to 4 entries (16 bytes) and zeros beyond; for a bf16 A,
    A's rows padded to 8 entries (16 bytes), w apart."""
    x = make_inputs(9, 5, k)
    A, w = T(x["A"]), T(x["w"])
    X, ldx = cc.project_operand(A, w)
    assert X.dtype == torch.float32 and tuple(X.shape) == (9, ldx) and X.is_contiguous()
    assert ldx % 4 == 0 and 0 <= ldx - (k + 1) < 4 and X.data_ptr() % 16 == 0
    assert torch.equal(X[:, :k], A) and torch.equal(X[:, k], w)
    assert float(X[:, k + 1:].abs().sum()) == 0
    Ab = A.to(torch.bfloat16)
    Xb, lda = cc.project_operand(Ab, w)
    assert Xb.dtype == torch.bfloat16 and tuple(Xb.shape) == (9, lda) and Xb.is_contiguous()
    assert lda % 8 == 0 and 0 <= lda - k < 8 and Xb.data_ptr() % 16 == 0
    assert torch.equal(Xb[:, :k], Ab) and float(Xb[:, k:].float().abs().sum()) == 0


@pytest.mark.parametrize("c,s,k", SHAPES + [(5, 9, 33), (3, 4, 64)])
def test_dp_operands_layout_reproduces_dp(c, s, k):
    """The operand arrays: K-major f32, K padded with zeros to a multiple
    of 32, 16-byte aligned; their product plus the rank-one term is
    A dY^T + w (x) dq."""
    x = make_inputs(c, s, k)
    A, dY, w, dq = T(x["A"]), T(x["dY"]), T(x["w"]), T(x["dq"])
    ops = cc.dp_operands(A, dY)
    Kp = ops.A_op.shape[1]
    assert Kp % 32 == 0 and 0 <= Kp - k < 32 and ops.split
    assert tuple(ops.A_op.shape) == (c, Kp) and tuple(ops.dY_op.shape) == (s, Kp)
    assert ops.A_op.is_contiguous() and ops.dY_op.is_contiguous()
    assert ops.A_op.data_ptr() % 16 == 0 and ops.dY_op.data_ptr() % 16 == 0
    assert torch.equal(ops.A_op[:, :k], A) and torch.equal(ops.dY_op[:, :k], dY)
    assert float(ops.A_op[:, k:].abs().sum()) == 0 and float(ops.dY_op[:, k:].abs().sum()) == 0
    want = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    got = cc.dp_from_operands_plain(ops, w, dq)
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # a prebuilt A operand is taken as it is
    again = cc.dp_operands(A, dY, ops.A_op)
    assert again.A_op is ops.A_op and torch.equal(again.dY_op, ops.dY_op)


def test_dp_operands_of_bf16_inputs_take_one_exact_product():
    x = make_inputs(40, 70, 19)
    bf = torch.bfloat16
    A, dY, w, dq = T(x["A"]).to(bf), T(x["dY"]).to(bf), T(x["w"]), T(x["dq"])
    ops = cc.dp_operands(A, dY)
    assert not ops.split and ops.A_op.dtype == ops.dY_op.dtype == torch.float32
    assert torch.equal(ops.A_op[:, :19], A.float())
    # every value is exact in TF32, so the split would find no low part
    assert int((cc.tf32_split(ops.dY_op)[1] != 0).sum()) == 0
    want = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    got = cc.dp_from_operands_plain(ops, w, dq)
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # one bf16 operand alone still takes the split
    assert cc.dp_operands(A, dY.float()).split and cc.dp_operands(A.float(), dY).split


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("role,Kp,c,a_dtype,dy_dtype,want", [
    ("rbar", 256, 26_431, F32, F32, "wgmma.tf32"),       # the tutorial, f32
    ("rbar", 256, 26_431, BF16, BF16, "wgmma.bf16"),     # the tutorial, bf16
    ("rbar", 256, 100_000, BF16, BF16, "wgmma.bf16"),    # the north star's operands
    ("rbar", 256, 26_431, BF16, F32, "wgmma.tf32"),      # one bf16 operand: the split
    ("rbar", 32, 1, F32, F32, "wgmma.tf32"),             # one cell, shallow K
    ("rbar", 256, 22, F32, F32, "wgmma.tf32"),           # clusters mode
    ("backward_rbar", 256, 26_431, F32, F32, "wgmma.tf32"),
    ("rbar", 288, 26_431, F32, F32, "tile"),             # the island term's K = 271
    ("backward_rbar", 288, 26_431, F32, F32, "tile"),    # k + 1 = 257
    ("rbar", 256, 0, F32, F32, "tile"),                  # no cell to map
    ("dm_adam", 256, 26_431, F32, F32, "tile"),
    ("dm_adam", 256, 26_431, BF16, BF16, "tile"),
    ("gsq", 256, 26_431, F32, F32, "tile"),
    ("dm_adafactor", 256, 26_431, F32, F32, "tile"),
    ("dm_backward", 256, 26_431, F32, F32, "tile"),
])
def test_dp_route_by_role_depth_cells_and_dtypes(role, Kp, c, a_dtype, dy_dtype, want):
    """The kernel that forms a launch's dP tile, from what the wrapper can
    observe: rbar's roles at K up to 256 on the warpgroup-MMA kernel (its
    bf16 product where A and dY are both bf16), everything else on the
    mma.sync tile."""
    assert cc.dp_route(role, Kp, c, a_dtype, dy_dtype) == want


@pytest.mark.parametrize("c,s,want", [
    (26_431, 9_852, (7, 132)),    # the tutorial: 22 tiles a unit, 2,891 units
    (22, 9_852, (77, 77)),        # clusters mode: two tiles a unit, one a warpgroup
    (100_000, 50_000, (7, 132)),  # the north star: 112 tiles a unit
    (37, 53, (1, 1)),
    (5, 0, (1, 1)),               # no spot: one empty unit
])
def test_wgmma_splits_balance_the_units_over_the_card(c, s, want):
    assert cc.wgmma_splits(c, s, sm_count=132) == want
    nsplit, blocks = want
    if s:
        per = -(-(-(-s // 64)) // nsplit)
        assert -(-(-(-s // 64)) // per) == nsplit  # every split has a tile
    assert blocks <= 132 and blocks <= -(-c // 64) * nsplit or blocks == 1


def test_wg_perm_permutes_each_chunk():
    for split in (True, False):
        perm = cc._wg_perm(split)
        assert sorted(perm.tolist()) == list(range(32))


@pytest.mark.parametrize("n,k,Kp,dtype,split", [
    (70, 40, 64, F32, True), (64, 32, 32, F32, True), (1, 3, 32, F32, True),
    (130, 249, 256, F32, True), (75, 19, 32, BF16, True), (77, 200, 224, BF16, False),
    (9, 31, 32, BF16, False),
])
def test_wgmma_operand_holds_the_split_or_bf16_rows(n, k, Kp, dtype, split):
    """dY's stages for the warpgroup-MMA kernel: unpermuted and unlaid, the
    rows padded to a multiple of 64 with zeros give back dp_operand's (s,
    Kp) operand, as tf32_split's parts (split) or bf16 values kept bf16."""
    X = torch.from_numpy(np.random.default_rng(n + k).normal(0, 1, (n, k)).astype(np.float32))
    X = X.to(dtype)
    tiles = cc.wgmma_operand(X, Kp, split)
    T_ = -(-n // 64)
    if split:
        assert tiles.dtype == F32 and tuple(tiles.shape) == (T_, Kp // 32, 2, 8, 8, 8, 4)
    else:
        assert tiles.dtype == BF16 and tuple(tiles.shape) == (T_, Kp // 32, 4, 8, 8, 8)
    rows = cc.wgmma_operand_rows(tiles, n, split)
    op = cc.dp_operand(X, Kp)
    if split:
        hi, lo = cc.tf32_split(op)
        assert torch.equal(rows[0], hi) and torch.equal(rows[1], lo)
    else:
        assert torch.equal(rows, op.to(BF16))
    # the padding rows are zeros
    padded = cc.wgmma_operand_rows(tiles, T_ * 64, split)
    for part in padded if split else (padded,):
        assert not part[n:].float().abs().sum()


@pytest.mark.parametrize("c,s,k,bf16", [(20, 70, 40, False), (65, 129, 249, False),
                                         (20, 70, 40, True), (3, 64, 256, True)])
def test_wgmma_stages_read_as_wgmma_reads_them_give_the_product(c, s, k, bf16):
    """Each stage read as wgmma reads a K-major operand without swizzle (8 x
    16-byte core matrices, 1,024 bytes apart along K, 128 along N), against
    A's fragments in the order one 16-byte load a row gives them, forms
    A_op dY_opᵀ: the layout and the permutation agree."""
    rng = np.random.default_rng(c + s)
    A = torch.from_numpy(rng.normal(0, 1, (c, k)).astype(np.float32))
    dY = torch.from_numpy(rng.normal(0, 1, (s, k)).astype(np.float32))
    if bf16:
        A, dY = A.to(BF16), dY.to(BF16)
    A_op = cc.dp_operand(A)
    Kp = A_op.shape[1]
    split = not bf16
    tiles = cc.wgmma_operand(dY, Kp, split)
    perm = cc._wg_perm(split)
    esz = 4 if split else 2
    per_core = 16 // esz
    n_idx, L_idx = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    offset = ((L_idx // per_core) * 8 + n_idx // 8) * 128 + (n_idx % 8) * 16 \
        + (L_idx % per_core) * esz
    got = torch.zeros((c, tiles.shape[0] * 64), dtype=torch.float64)
    for t in range(tiles.shape[0]):
        for ch in range(Kp // 32):
            stage = tiles[t, ch].reshape(-1).double()
            if split:
                stage = stage[:2048] + stage[2048:]
            B = stage[torch.from_numpy(offset // esz)]  # (64 spots, 32 logical K)
            a_log = A_op[:, ch * 32 + perm].double()    # (c, 32 logical K)
            got[:, t * 64:(t + 1) * 64] += a_log @ B.T
    want = A_op.double() @ cc.dp_operand(dY, Kp).double().T
    err = float((got[:, :s] - want).abs().max())
    # the split's lo rounded to TF32 (tf32_split) leaves 2^-22 of each term
    assert err <= (1e-5 if split else 0.0) * float(want.abs().max() + 1)


@pytest.mark.parametrize("bf16", [False, True])
def test_dp_from_operands_plain_reads_the_wgmma_stages(bf16):
    """dp_from_operands_plain on operands that hold dY's stages in place of
    its rows gives what it gives on the rows, bit for bit; on the CPU
    dp_operands builds the rows alone."""
    x = make_inputs(40, 70, 19)
    A, dY, w, dq = T(x["A"]), T(x["dY"]), T(x["w"]), T(x["dq"])
    if bf16:
        A, dY = A.to(BF16), dY.to(BF16)
    ops = cc.dp_operands(A, dY)
    assert ops.dY_op is not None and ops.dY_tiles is None
    tiles = cc.wgmma_operand(dY, ops.A_op.shape[1], ops.split)
    staged = ops._replace(dY_op=None, dY_tiles=tiles)
    cc._check_operands(staged, A, dY)
    assert torch.equal(cc.dp_from_operands_plain(staged, w, dq),
                       cc.dp_from_operands_plain(ops, w, dq))
    bops = cc.backward_operands(A.float(), dY.float(), dq)
    assert bops.dY_tiles is None and bops.split


def test_stage_granule_follows_row_alignment():
    """The bytes per staging copy of the tensor-core tile: what divides the
    row length and the base; none for a bf16 array with an odd row."""
    f32, bf = torch.float32, torch.bfloat16
    assert cc.stage_granule(9_852, torch.zeros((2, 9_852), dtype=f32)) == 16
    assert cc.stage_granule(9_852, torch.zeros((2, 9_852), dtype=bf)) == 8
    assert cc.stage_granule(53, torch.zeros((2, 53), dtype=f32)) == 4
    assert cc.stage_granule(54, torch.zeros((2, 54), dtype=bf)) == 4
    assert cc.stage_granule(53, torch.zeros((2, 53), dtype=bf)) == 0
    assert cc.stage_granule(600, torch.zeros((2, 600), dtype=bf)) == 16
    base = torch.zeros(16 + 2 * 8, dtype=f32)
    assert cc.stage_granule(8, base[1:17].view(2, 8)) == 4  # a base 4 bytes off


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rbar_and_dm_adam_with_prebuilt_operands_match_jax(c, s, k, with_dh):
    """The wrappers as the fused steps call them, with the step's operands
    built once: equal to the JAX kernels at the twins' tolerance, and to
    the call without operands bit for bit."""
    x = make_inputs(c, s, k)
    m, l, _ = jax_stats(x["M"])
    args = torch_args(x, m, l)
    ops = cc.dp_operands(args[1], args[5])
    r = fs._rbar(*args, with_dh=with_dh, operands=ops)
    assert torch.equal(r, fs._rbar(*args, with_dh=with_dh))
    r_j = np.asarray(jax_rbar(x, m, l, with_dh))
    close(r, r_j)
    lr, bc1, bc2 = fs.adam_scalars(3, 0.1)
    want = jfs._dm_adam(*jax_args(x, m, l), jnp.asarray(r_j), jnp.asarray(x["mu"]),
                        jnp.asarray(x["nu"]), jnp.asarray([[lr, bc1, bc2, 3.0]], jnp.float32),
                        0.0, 0.0, with_norms=False, with_dh=with_dh)
    got = fs._dm_adam(*args, T(r_j), T(x["mu"]), T(x["nu"]), (lr, bc1, bc2),
                      with_dh=with_dh, operands=ops)
    for g, w in zip(got, want):
        close(g, w)
    # operands that do not fit the inputs are refused, on the CPU too
    with pytest.raises(ValueError):
        fs._rbar(*args, with_dh=with_dh, operands=cc.dp_operands(args[1][:-1], args[5]))


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_fused_steps_take_the_loops_a_operand(optimizer):
    """A step handed the loop's prebuilt A operand equals the step that
    builds its own, bit for bit."""
    x = make_inputs(12, 20, 3)
    data = MapperData(S=T(x["A"]), G=T(np.abs(x["dY"][:, :3]) + 0.1))
    lw = LossWeights(lambda_g2=0.5, lambda_r=0.01, lambda_l1=0.01)
    step = (fs.fused_unconstrained_step if optimizer == "adam"
            else fs.fused_unconstrained_step_adafactor)
    outs = []
    for prebuilt in (False, True):
        M = T(x["M"])
        state = (fs.init_fused_opt_state(M) if optimizer == "adam"
                 else fs.init_fused_adafactor_state(M))
        A_op = fs.unconstrained_a_operand(M, data, lw) if prebuilt else None
        if prebuilt:
            assert tuple(A_op.shape) == (12, 32) and torch.equal(A_op[:, :3], data.S)
        out = step(M, *state, fs.initial_stats(M, lw), data, lw, 0.1, A_op=A_op)
        outs.append((out[0], out[2], out[3]) + tuple(out[4]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_adafactor_step_passes_its_operands_to_the_update(monkeypatch):
    """The fused Adafactor step hands the dP operands it built for rbar to
    the update (``_dm_adafactor(operands=...)``), and its result is the one
    of an update that builds its own, bit for bit."""
    x = make_inputs(12, 20, 3)
    data = MapperData(S=T(x["A"]), G=T(np.abs(x["dY"][:, :3]) + 0.1))
    lw = LossWeights(lambda_g2=0.5, lambda_r=0.01, lambda_l1=0.01)
    update = fs._dm_adafactor
    seen = []

    def spy(*args, operands=None, drop=False, **kw):
        seen.append(operands)
        return update(*args, operands=None if drop else operands, **kw)

    outs = []
    for drop in (False, True):
        monkeypatch.setattr(fs, "_dm_adafactor",
                            lambda *a, drop=drop, **kw: spy(*a, drop=drop, **kw))
        M = T(x["M"])
        out = fs.fused_unconstrained_step_adafactor(
            M, *fs.init_fused_adafactor_state(M), fs.initial_stats(M, lw), data, lw, 0.1)
        outs.append((out[0], out[2], out[3]) + tuple(out[4]))
    assert all(isinstance(ops, cc.DpOperands) and not ops.ext for ops in seen)
    assert tuple(seen[0].A_op.shape) == (12, 32)
    assert torch.equal(seen[0].A_op[:, :3], data.S)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.01, 0.02)])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_gsq_with_prebuilt_operands_matches_jax(c, s, k, with_dh, lam):
    """gsq as the fused Adafactor step calls it, on the step's dP operands
    built once: equal to the JAX kernel (interpret mode) at the twins'
    tolerance and to the call without operands bit for bit; operands built
    from another A or dY are refused, on the CPU too."""
    x = make_inputs(c, s, k, pad=lam != (0.0, 0.0))
    m, l, _ = jax_stats(x["M"])
    r = np.asarray(jax_rbar(x, m, l, with_dh))
    args = torch_args(x, m, l)
    ops = cc.dp_operands(args[1], args[5])
    vr, vc = fs._gsq(*args, T(r), *lam, with_dh=with_dh, operands=ops)
    own = fs._gsq(*args, T(r), *lam, with_dh=with_dh)
    assert torch.equal(vr, own[0]) and torch.equal(vc, own[1])
    vr_j, vc_j = jax_gsq(x, m, l, r, lam, with_dh)
    close_to_scale(vr, vr_j)
    close_to_scale(vc, vc_j)
    for other in (cc.dp_operands(args[1][:-1], args[5]),
                  cc.dp_operands(args[1], args[5][:-1])):
        with pytest.raises(ValueError):
            fs._gsq(*args, T(r), *lam, with_dh=with_dh, operands=other)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", [(300, 600, 40), (64, 2_000, 249)])
def test_gsq_tf32_twin_keeps_f32_accuracy_and_one_pass_misses(c, s, k, with_dh):
    """gsq's vr and vc as the tensor-core kernel forms them (three TF32
    terms) err against float64 by at most 4× what the f32 twin errs, and a
    single TF32 pass misses them by more than 10× that margin: the witness
    of chip_smoke.py (F32_WITNESS), on a fractional A as it takes."""
    x = make_inputs(c, s, k, seed=5)
    rng = np.random.default_rng(6)
    M, w, dY, dq, dh = (T(x[n]) for n in ("M", "w", "dY", "dq", "dh"))
    A = T(x["A"] + rng.random(x["A"].shape))
    m, l, _ = cc._rowstats_plain(M)
    args = (M, A, w, m, l, dY, dq, dh)
    r = cc._rbar_plain(*args, with_dh)
    Md = M.double()
    P = torch.exp(Md - m.double()) / l.double()
    dP = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    if with_dh:
        dP = dP + dh.double()[:, None] * ((Md - m.double() - torch.log(l.double())) + 1.0)
    g2 = (P * (dP - r.double())) ** 2
    want = (g2.sum(dim=1), g2.sum(dim=0))
    f32 = fs._gsq_plain(*args, r, 0.0, 0.0, with_dh=with_dh)
    three = fs.gsq_tf32_plain(*args, r, 0.0, 0.0, with_dh=with_dh)
    one = fs.gsq_tf32_plain(*args, r, 0.0, 0.0, with_dh=with_dh, terms=1)
    for got, plain, single, ref in zip(three, f32, one, want):
        margin = 4.0 * float((plain.double() - ref).abs().max())
        assert float((got.double() - ref).abs().max()) <= margin
        assert float((single - got).abs().max()) > 10.0 * margin


@pytest.mark.parametrize("dtype,s,offset,want", [
    (torch.float32, 9_852, 0, 16),   # the tutorial shape: 16-byte loads
    (torch.float32, 600, 0, 16),
    (torch.float32, 9_850, 0, 8),    # rows of 39,400 bytes
    (torch.float32, 54, 0, 8),
    (torch.float32, 53, 0, 4),       # odd s: one f32 entry a load
    (torch.float32, 600, 1, 4),      # a base 4 bytes off
    (torch.bfloat16, 9_852, 0, 8),   # 19,704-byte rows: every other one 16-aligned
    (torch.bfloat16, 600, 0, 16),
    (torch.bfloat16, 9_850, 0, 4),
    (torch.bfloat16, 54, 0, 4),
    (torch.bfloat16, 53, 0, 2),      # odd s: one bf16 entry a load
    (torch.bfloat16, 600, 1, 2),     # a base 2 bytes off
    (torch.bfloat16, 600, 2, 4),
])
def test_rowstats_load_bytes_follow_shape_and_alignment(dtype, s, offset, want):
    """The row-stats kernels' loads along a row: the widest of 16, 8 and 4
    bytes that divides the row's length in bytes and M's base, else (a bf16
    row of odd length) one entry; a load never straddles a row's end. The
    twins' stats do not depend on it."""
    c = 3
    buf = torch.zeros(c * s + offset + 8, dtype=dtype)
    M = buf[offset:offset + c * s].view(c, s)
    rng = np.random.default_rng(s + offset)
    M.copy_(torch.from_numpy(rng.normal(0, 1, (c, s)).astype(np.float32)).to(dtype))
    got = cc.rowstats_load_bytes(M)
    assert got == want
    assert (s * M.element_size()) % got == 0 and M.data_ptr() % got == 0
    for g, w in zip(cc._rowstats(M), cc._rowstats_plain(M.contiguous().clone())):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lam", [dict(lambda_g2=0.5, lambda_r=0.01),
                                 dict(lambda_g2=0.5, lambda_r=0.01, lambda_l1=0.01,
                                      lambda_l2=0.02)])
def test_fused_adafactor_step_matches_jax(lam):
    """Two fused Adafactor steps on the CPU (rbar, gsq and the update on one
    set of dP operands per step, each kernel's plain twin) against the JAX
    fused step (Pallas in interpret mode), the second from the JAX step's
    own carry: M, the factor vectors, the next stats and the loss terms at
    the twins' tolerance."""
    from tangram_tpu.ops.losses import LossWeights as JLossWeights
    from tangram_tpu.ops.losses import MapperData as JMapperData

    rng = np.random.default_rng(4)
    c, s, g = 40, 72, 9
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    M0 = rng.normal(0, 1, (c, s)).astype(np.float32)
    jdata, jlw = JMapperData(S=jnp.asarray(S), G=jnp.asarray(G)), JLossWeights(**lam)
    data, lw = MapperData(S=T(S), G=T(G)), LossWeights(**lam)
    M_j = jnp.asarray(M0)
    count_j, vr_j, vc_j = jfs.init_fused_adafactor_state(M_j)
    stats_j = jfs.initial_stats(M_j, jlw)
    for step in range(2):
        got = fs.fused_unconstrained_step_adafactor(
            T(np.asarray(M_j)), step, T(np.asarray(vr_j)), T(np.asarray(vc_j)),
            tuple(T(np.asarray(v)) for v in stats_j), data, lw, 0.1)
        M_j, count_j, vr_j, vc_j, stats_j, terms_j = jfs.fused_unconstrained_step_adafactor(
            M_j, count_j, vr_j, vc_j, stats_j, jdata, jlw, 0.1)
        assert got[1] == step + 1 == int(count_j)
        for g_, w_ in [(got[0], M_j), (got[2], vr_j), (got[3], vc_j)]:
            close(g_, w_)
        assert len(got[4]) == len(stats_j)
        for g_, w_ in zip(got[4], stats_j):
            close(g_, w_)
        for key, v in got[5].items():  # a term that is off is NaN in both
            np.testing.assert_allclose(float(v), float(terms_j[key]), rtol=1e-5, atol=1e-6)


def test_adafactor_step_passes_its_operands_to_gsq(monkeypatch):
    """The fused Adafactor step hands gsq the dP operands it built for rbar
    (``_gsq(operands=...)``), the same ones the update takes, and its
    result is that of a gsq that builds its own, bit for bit."""
    x = make_inputs(12, 20, 3)
    data = MapperData(S=T(x["A"]), G=T(np.abs(x["dY"][:, :3]) + 0.1))
    lw = LossWeights(lambda_g2=0.5, lambda_r=0.01, lambda_l1=0.01)
    gsq, update = fs._gsq, fs._dm_adafactor
    seen = {"gsq": [], "update": []}

    def spy_gsq(*args, operands=None, drop=False, **kw):
        seen["gsq"].append(operands)
        return gsq(*args, operands=None if drop else operands, **kw)

    def spy_update(*args, operands=None, **kw):
        seen["update"].append(operands)
        return update(*args, operands=operands, **kw)

    monkeypatch.setattr(fs, "_dm_adafactor", spy_update)
    outs = []
    for drop in (False, True):
        monkeypatch.setattr(fs, "_gsq", lambda *a, drop=drop, **kw: spy_gsq(*a, drop=drop, **kw))
        M = T(x["M"])
        out = fs.fused_unconstrained_step_adafactor(
            M, *fs.init_fused_adafactor_state(M), fs.initial_stats(M, lw), data, lw, 0.1)
        outs.append((out[0], out[2], out[3]) + tuple(out[4]))
    assert all(isinstance(ops, cc.DpOperands) and not ops.ext for ops in seen["gsq"])
    assert all(a is b for a, b in zip(seen["gsq"], seen["update"]))
    assert torch.equal(seen["gsq"][0].A_op[:, :3], data.S)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_wrappers_reject_mixed_devices():
    x = make_inputs(4, 6, 2)
    M = T(x["M"])
    col = M[:, :1].contiguous()
    with pytest.raises(ValueError, match="devices"):
        cc._project(M, T(x["A"]), T(x["w"]), col.to("meta"), col)
    with pytest.raises(ValueError, match="contiguous"):
        cc._project(M, T(x["A"]), T(x["w"]), col, M[:, :1])


def test_import_leaves_jax_out():
    """Importing every module of the port (walked from the package, so a new
    module is covered when it lands) pulls in neither jax nor tangram_tpu,
    nor the repo's ``examples`` package (the JAX tutorials) or ``scripts``
    (the JAX tools; the port's are ``tangram_tpu_torch.scripts``), nor the
    plotting libraries that plot_utils and the mapping tutorial import only
    to draw."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import tangram_tpu_torch as pkg\n"
        "names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, 'tangram_tpu_torch.'))\n"
        "need = {'deconv', 'cell_selection', 'gene_selection', 'plot_utils', 'profiling',\n"
        "        'utils', 'evaluation', 'mapping', 'models.mapper', 'ops.cuda_core',\n"
        "        'north_star', 'examples.tutorial_mapping', 'examples.tutorial_deconvolution',\n"
        "        'examples.tutorial_atlas_mesh', 'examples.tutorial_fault_tolerant_sweep',\n"
        "        'scripts.fuzz_paths', 'scripts.fuzz_tuner', 'scripts.gen_api_docs',\n"
        "        'scripts.gen_tutorial_notebook'}\n"
        "missing = sorted(n for n in need if 'tangram_tpu_torch.' + n not in names)\n"
        "for m in names:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tangram_tpu' or m.startswith('tangram_tpu.')\n"
        "             or m == 'examples' or m.startswith('examples.')\n"
        "             or m == 'scripts' or m.startswith('scripts.')\n"
        "             or m in ('matplotlib', 'seaborn'))\n"
        "print(len(names), missing, bad)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
