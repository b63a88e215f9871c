"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: every test skips without an NVIDIA GPU. On a machine with
one (and nvcc), run

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest`` because the suite's conftest imports jax, which this file
does not need). ``chip_smoke.py`` makes the same comparison at the full
tutorial shape.

Tolerance: max |kernel − twin| ≤ 1e-4 · max |twin| per output (1e-5 for the
row stats): both are IEEE f32 and differ only in summation order. The L1/L2
cases plant one padding sentinel in M and take the scale of the other
entries. The dP tile (rbar, dm_adam, dm_adafactor, dm_backward) forms
A·dYᵀ, dm_backward also P·[dY | dq], and project Pᵀ[A | w], on the tensor
cores from TF32 parts of the f32 operands (3×TF32); the witness tests hold
them to f32 accuracy against float64. The shapes cover one resident A
panel and two (k = 300; dm_backward's output then in two column panels),
even and odd row lengths (16-, 8- and 4-byte staging copies, the bf16
element path, paired and single stores), a single ragged tile, and one cell
group spread over eight spot splits (c = 22 < 64, as clusters mode). The
row stats are also checked on rows that take each of their load widths.
The graph terms' products (dense and k-NN, forward and backward, bit for
bit on a second run), project, rbar and dm_adam at a cell-type-island
width (k + 1 > 256), one short ``map_cells_to_space`` with the five
graph terms on k-NN graphs and the island term with a standardized filter
(where its penalty is non-zero) are held against the CPU and the twins;
``projected_expression``'s device path against a float64 product.
"""

import numpy as np
import pytest
import torch

from tangram_tpu_torch.models.mapper import fit_mapping
from tangram_tpu_torch.ops import cuda_core as cc
from tangram_tpu_torch.ops import fused_step as fs
from tangram_tpu_torch.ops.losses import LossWeights, MapperData

pytestmark = pytest.mark.cuda

SHAPES = [(8, 16, 4), (37, 53, 7), (300, 600, 7), (257, 513, 129), (70, 301, 300),
          (22, 1_001, 9)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


PAD = -1e25  # a padding sentinel, below PAD_GUARD
NORMS = (0.01, 0.02)  # (lambda_l1, lambda_l2)
WITNESS = (4.0, 10.0)  # the f32-accuracy witness (chip_smoke.F32_WITNESS)


def inputs(c, s, k, dev, seed=0, pad=False):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)

    M = rng.normal(0, 1, (c, s))
    if pad:
        M[0, 1 % s] = PAD
    return dict(
        M=t(M), A=t(rng.poisson(1.5, (c, k))),
        w=t(rng.random(c) / c), dY=t(rng.normal(0, 0.1, (s, k))),
        dq=t(rng.normal(0, 1, s)), dh=t(rng.normal(0, 0.1, c)),
        mu=t(rng.normal(0, 1e-3, (c, s))), nu=t(rng.random((c, s)) * 1e-6),
    )


def assert_close(got, want, rtol=1e-4):
    err = float((got - want).abs().max())
    real = want.abs() < -fs.PAD_GUARD  # the sentinel does not set the scale
    scale = float(want[real].abs().max()) if bool(real.any()) else 0.0
    assert err <= rtol * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_forward_kernels_match_twins(dev, c, s, k):
    x = inputs(c, s, k, dev)
    before = dict(cc.LAUNCHES)
    m, l, u = cc._rowstats(x["M"])
    for g, w in zip((m, l, u), cc._rowstats_plain(x["M"])):
        assert_close(g, w, rtol=1e-5)
    for g, w in zip(cc._project(x["M"], x["A"], x["w"], m, l),
                    cc._project_plain(x["M"], x["A"], x["w"], m, l)):
        assert_close(g, w)
    assert cc.LAUNCHES["rowstats"] == before["rowstats"] + 1
    assert cc.LAUNCHES["project"] == before["project"] + 1


# project's own paths: ragged c, s and k; two column panels (k = 300);
# clusters mode's 22 cells over 9,852 spots; the staging of M's rows (f32
# rows of 56, 54 and 53 entries: 16-, 8- and 4-byte copies; bf16 rows of
# 56, 52, 54 and 53 entries: 16, 8 and 4 bytes, and entry by entry); a PAD
# sentinel in each
PROJECT_SHAPES = [(37, 53, 7), (70, 301, 300), (22, 9_852, 249), (1_000, 56, 255),
                  (33, 54, 256), (530, 52, 9)]


@pytest.mark.parametrize("a_bf16", [False, True])
@pytest.mark.parametrize("m_bf16", [False, True])
@pytest.mark.parametrize("c,s,k", PROJECT_SHAPES)
def test_project_kernel_matches_twin_and_repeats(dev, c, s, k, m_bf16, a_bf16):
    """The tensor-core project kernel against its twin (a bf16 A: Y by the
    bf16 rule below, beyond the slack of P's rounding), counted once under
    its name, and two repeats that give the same bits."""
    bf = torch.bfloat16
    x = inputs(c, s, k, dev, pad=True)
    M = x["M"].to(bf) if m_bf16 else x["M"]
    A = x["A"].to(bf) if a_bf16 else x["A"]
    m, l, _ = cc._rowstats_plain(M)
    cc.reset_launches()
    Y, q = cc._project(M, A, x["w"], m, l)
    name = "project.bf16" if m_bf16 or a_bf16 else "project"
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == {name: 1}
    Yp, qp = cc._project_plain(M, A, x["w"], m, l)
    assert_close(q, qp)
    if a_bf16:
        slack = cc.project_rounding_slack(M, A, m, l)
        assert float(((Y - Yp).abs() - slack).max()) <= Y_RTOL * float(Yp.abs().max())
    else:
        assert_close(Y, Yp)
    for _ in range(2):
        Y2, q2 = cc._project(M, A, x["w"], m, l)
        assert torch.equal(Y, Y2) and torch.equal(q, q2)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("c,s,k", [(37, 53, 7), (2_000, 301, 40), (22, 9_852, 249)])
def test_project_keeps_f32_accuracy(dev, c, s, k, signed):
    """Y and q against a float64 projection: the kernel errs at most 4×
    what the f32 twin errs; on signed operands (A centred, w of random
    sign) a twin whose P was rounded once to TF32 misses the kernel by more
    than 10× that margin (on the counts, all terms >= 0, one rounding of P
    averages out over deep sums, as chip_smoke.py's witness notes)."""
    x = inputs(c, s, k, dev, seed=3)
    M, A, w = x["M"], x["A"] + torch.rand_like(x["A"]), x["w"]
    if signed:
        A = A - A.mean(dim=0)
        w = w * torch.where(torch.rand_like(w) < 0.5, -1.0, 1.0)
    m, l, _ = cc._rowstats_plain(M)
    P = torch.exp(M.double() - m.double()) / l.double()
    P_t = cc.tf32_split(torch.exp(M - m) * (1.0 / l))[0]
    want = (P.T @ A.double(), w.double() @ P)
    got = cc._project(M, A, w, m, l)
    plain = cc._project_plain(M, A, w, m, l)
    rounded = (P_t.T @ A, w @ P_t)
    for g, p, r, t in zip(got, plain, rounded, want):
        margin = WITNESS[0] * float((p.double() - t).abs().max())
        assert float((g.double() - t).abs().max()) <= margin
        if signed:
            assert float((r - g).abs().max()) > WITNESS[1] * margin


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_backward_kernels_match_twins(dev, c, s, k, with_dh):
    x = inputs(c, s, k, dev)
    m, l, _ = cc._rowstats_plain(x["M"])
    args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args, with_dh=with_dh)
    assert_close(fs._rbar(*args, with_dh=with_dh), r)
    scalars = fs.adam_scalars(3, 0.1)
    k_state = [x["M"].clone(), x["mu"].clone(), x["nu"].clone()]
    p_state = [x["M"].clone(), x["mu"].clone(), x["nu"].clone()]
    got = fs._dm_adam(k_state[0], *args[1:], r, *k_state[1:], scalars, with_dh=with_dh)
    want = fs._dm_adam_plain(p_state[0], *args[1:], r, *p_state[1:], scalars,
                             with_dh=with_dh)
    assert got[0] is k_state[0]  # in place
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_backward_kernel_matches_twin(dev, c, s, k, with_dh):
    """dM, dA and dw of the unfused backward, with one padding sentinel."""
    x = inputs(c, s, k, dev, pad=True)
    m, l, _ = cc._rowstats_plain(x["M"])
    args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args, with_dh=with_dh)
    before = cc.LAUNCHES["dm_backward"]
    got = cc._dm_backward(*args, r, with_dh=with_dh)
    want = cc._dm_backward_plain(*args, r, with_dh=with_dh)
    assert cc.LAUNCHES["dm_backward"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w)



@pytest.mark.parametrize("c,s,k", SHAPES)
def test_tensor_core_tile_keeps_f32_accuracy(dev, c, s, k):
    """rbar's r and dm_adam's mu against float64: the kernel errs at most 4×
    what the f32 twin errs, and a twin whose A and dY were rounded once to
    TF32 (a single tensor-core pass) misses the kernel by more than 10×
    that margin. With the entropy cotangent off, as chip_smoke.py's witness:
    dh's term would drown the product's error."""
    x = inputs(c, s, k, dev, seed=3)
    M, A, w, dY, dq, dh = (x[n] for n in ("M", "A", "w", "dY", "dq", "dh"))
    # floats, not counts: small integers are exact in TF32 and hide the fault
    A = A + torch.rand_like(A)
    m, l, _ = cc._rowstats_plain(M)
    A_t, dY_t = cc.tf32_split(A)[0], cc.tf32_split(dY)[0]
    P = torch.exp(M.double() - m.double()) / l.double()
    dP = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    r64 = (P * dP).sum(dim=1, keepdim=True)
    r_p = cc._rbar_plain(M, A, w, m, l, dY, dq, dh, False)
    mu64 = (float(np.float32(fs.BETA1)) * x["mu"].double()
            + float(np.float32(1.0 - fs.BETA1)) * (P * (dP - r_p.double())))
    scalars = fs.adam_scalars(3, 0.1)

    def run(rbar, adam, A_in, dY_in):
        r = rbar(M, A_in, w, m, l, dY_in, dq, dh, False)
        out = adam(M.clone(), A_in, w, m, l, dY_in, dq, dh, r_p, x["mu"].clone(),
                   x["nu"].clone(), scalars, False)
        return r, out[1]

    kernel = run(fs._rbar, fs._dm_adam, A, dY)
    twin = run(cc._rbar_plain, fs._dm_adam_plain, A, dY)
    rounded = run(cc._rbar_plain, fs._dm_adam_plain, A_t, dY_t)
    for got, plain, tf32, want in zip(kernel, twin, rounded, (r64, mu64)):
        margin = WITNESS[0] * float((plain.double() - want).abs().max())
        assert float((got.double() - want).abs().max()) <= margin
        assert float((tf32 - got).abs().max()) > WITNESS[1] * margin


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_prebuilt_operands_and_repeats_give_the_same_bits(dev, c, s, k):
    """rbar and dm_adam with the step's prebuilt operands store what they
    store when they build their own, and a repeat stores the same bits (no
    atomics, a fixed reduction order), in f32 and with bf16 inputs."""
    for make in (inputs, bf16_inputs):
        x = make(c, s, k, dev)
        m, l, _ = cc._rowstats_plain(x["M"])
        args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
        ops = cc.dp_operands(x["A"], x["dY"])
        assert ops.split == (x["A"].dtype == torch.float32)
        r = fs._rbar(*args)
        assert torch.equal(r, fs._rbar(*args, operands=ops))
        assert torch.equal(r, fs._rbar(*args, operands=ops))
        scalars = fs.adam_scalars(3, 0.1)
        outs = [fs._dm_adam(x["M"].clone(), *args[1:], r, x["mu"].clone(), x["nu"].clone(),
                            scalars, operands=operands)
                for operands in (None, ops, ops)]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                   b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def core_gradients(M, A, w, cts, core):
    """(dM, dA, dw) of Σ Y⊙gY + Σ q⊙gq + Σ h⊙gh through ``core``."""
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (M, A, w)]
        outs = core(*leaves)
        loss = sum((o * g).sum() for o, g in zip(outs, cts))
        return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_mapper_core_kernels_match_autograd_reference(dev, c, s, k):
    """MapperCore (rowstats, project, backward_rbar, dm_backward) against
    autograd through the materialized core, on the card."""
    from tangram_tpu_torch.ops.core import mapper_core_reference

    x = inputs(c, s, k, dev)
    rng = np.random.default_rng(3)
    cts = [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
           for shape in ((s, k), (s,), (c,))]
    cc.reset_launches()
    got = core_gradients(x["M"], x["A"], x["w"], cts, cc.MapperCore.apply)
    assert {n: cc.LAUNCHES[n] for n in ("rowstats", "project", "backward_rbar",
                                        "dm_backward")} == dict.fromkeys(
        ("rowstats", "project", "backward_rbar", "dm_backward"), 1)
    want = core_gradients(x["M"], x["A"], x["w"], cts, mapper_core_reference)
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_bf16_m_backward_kernels_match_twins_and_repeat(dev, c, s, k, with_dh):
    """backward_rbar and dm_backward on a bf16 M with f32 A and dY (what
    MapperCore hands them), counted as their .bf16 variants: r, dA and dw
    as the f32 outputs, dM stored in bf16 within one bf16 ulp beyond the
    f32 tolerance; two repeats store the same bits, with the backward's
    operands built once or by each call."""
    x = inputs(c, s, k, dev, pad=True)
    M = x["M"].to(torch.bfloat16)
    m, l, _ = cc._rowstats_plain(M)
    args = (M, x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args, with_dh=with_dh)
    cc.reset_launches()
    assert_close(cc._rbar(*args, with_dh=with_dh, counter="backward_rbar"), r)
    got = cc._dm_backward(*args, r, with_dh=with_dh)
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == {
        "backward_rbar.bf16": 1, "dm_backward.bf16": 1}
    want = cc._dm_backward_plain(*args, r, with_dh=with_dh)
    assert_stored_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert_close(g, w)
    ops = cc.backward_operands(x["A"], x["dY"], x["dq"])
    for operands in (None, ops, ops):
        again = cc._dm_backward(*args, r, with_dh=with_dh, operands=operands)
        assert torch.equal(again[0].view(torch.int16), got[0].view(torch.int16))
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_backward_repeats_give_the_same_bits(dev, c, s, k):
    """f32 dM, dA and dw of three runs on the same inputs, with the
    backward's operands built once or by each call: the same bits (no
    atomics; the splits' partials added in order)."""
    x = inputs(c, s, k, dev)
    m, l, _ = cc._rowstats_plain(x["M"])
    args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args)
    ops = cc.backward_operands(x["A"], x["dY"], x["dq"])
    first = cc._dm_backward(*args, r)
    for operands in (ops, ops, None):
        for a, b in zip(first, cc._dm_backward(*args, r, operands=operands)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_backward_and_adafactor_keep_f32_accuracy(dev, c, s, k):
    """dm_backward's dM, dA, dw and dm_adafactor's stored M against
    float64: the kernel errs at most 4× what the f32 twin errs, and a twin
    with a single TF32 pass (A and dY, and P and [dY | dq] in dm_backward's
    second product, rounded once) misses the kernel by more than 10× that
    margin. Entropy cotangent off, as chip_smoke.py's witness."""
    x = inputs(c, s, k, dev, seed=3)
    M, A, w, dY, dq, dh = (x[n] for n in ("M", "A", "w", "dY", "dq", "dh"))
    A = A + torch.rand_like(A)
    m, l, _ = cc._rowstats_plain(M)
    args = (M, A, w, m, l, dY, dq, dh)
    r = cc._rbar_plain(*args, False)
    vr, vc = fs._gsq_plain(*args, r, 0.0, 0.0, with_dh=False)
    _, _, rowf, colf = fs.factored_rms_vectors(
        0, torch.zeros_like(vr), torch.zeros_like(vc), vr, vc, c, s)
    P = torch.exp(M.double() - m.double()) / l.double()
    dP = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    g = P * (dP - r.double())
    lr = float(np.float32(0.1))
    want = (g, P @ dY.double(), P @ dq.double(),
            M.double() - lr * (g * rowf.double()[:, None] * colf.double()[None, :]))
    A_t, dY_t = cc.tf32_split(A)[0], cc.tf32_split(dY)[0]

    def run(backward, adafactor, A_in, dY_in):
        out = adafactor(M.clone(), A_in, w, m, l, dY_in, dq, dh, r, rowf, colf, 0.1,
                        0.0, 0.0, False, with_dh=False)
        return tuple(backward(*args, r, with_dh=False)) + (out[0],)

    kernel = run(cc._dm_backward, fs._dm_adafactor, A, dY)
    twin = run(cc._dm_backward_plain, fs._dm_adafactor_plain, A, dY)
    rounded = run(lambda *a, with_dh: cc.dm_backward_tf32_plain(*a, with_dh=with_dh, terms=1),
                  fs._dm_adafactor_plain, A_t, dY_t)
    for got, plain, tf32, ref in zip(kernel, twin, rounded, want):
        margin = WITNESS[0] * float((plain.double() - ref).abs().max())
        assert float((got.double() - ref).abs().max()) <= margin
        assert float((tf32 - got).abs().max()) > WITNESS[1] * margin


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_dm_adafactor_with_prebuilt_operands_gives_the_same_bits(dev, c, s, k):
    """dm_adafactor with the step's prebuilt operands stores what it stores
    when it builds its own, and a repeat the same bits, in f32 and with
    bf16 inputs (stochastic rounding)."""
    for make, kw in ((inputs, {}), (bf16_inputs, dict(rounding="stochastic", step=4))):
        x = make(c, s, k, dev)
        m, l, _ = cc._rowstats_plain(x["M"])
        args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
        r = cc._rbar_plain(*args)
        vr, vc = fs._gsq_plain(*args, r, 0.0, 0.0)
        _, _, rowf, colf = fs.factored_rms_vectors(
            0, torch.zeros_like(vr), torch.zeros_like(vc), vr, vc, c, s)
        ops = cc.dp_operands(x["A"], x["dY"])
        outs = [fs._dm_adafactor(x["M"].clone(), *args[1:], r, rowf, colf, 0.1, 0.0, 0.0,
                                 False, operands=operands, **kw)
                for operands in (None, ops, ops)]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                   b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_mapper_core_kernels_on_bf16_m_match_autograd_reference(dev, c, s, k):
    """MapperCore on a bf16 M (the .bf16 variants of rowstats, project,
    backward_rbar and dm_backward, each once) against autograd through the
    materialized core of the same bf16 values: dA and dw at the f32
    tolerance, dM (stored in bf16) within one bf16 ulp beyond it of the
    reference's f32 gradient."""
    from tangram_tpu_torch.ops.core import mapper_core_reference

    x = inputs(c, s, k, dev)
    M = x["M"].to(torch.bfloat16)
    rng = np.random.default_rng(3)
    cts = [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
           for shape in ((s, k), (s,), (c,))]
    cc.reset_launches()
    got = core_gradients(M, x["A"], x["w"], cts, cc.MapperCore.apply)
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == dict.fromkeys(
        ("rowstats.bf16", "project.bf16", "backward_rbar.bf16", "dm_backward.bf16"), 1)
    want = core_gradients(M.float(), x["A"], x["w"], cts, mapper_core_reference)
    # the reference's f32 gradient, not a stored one: every entry within
    # one bf16 ulp beyond the f32 tolerance
    assert got[0].dtype == torch.bfloat16
    ulp = torch.exp2(torch.floor(torch.log2(want[0].abs().clamp_min(2.0 ** -126))) - 7)
    excess = (got[0].float() - want[0]).abs() - 1e-4 * float(want[0].abs().max())
    assert float((excess / ulp).max()) <= 1.0
    for g, w in zip(got[1:], want[1:]):
        assert_close(g, w)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rowstats_norms_kernel_matches_twin(dev, c, s, k):
    x = inputs(c, s, k, dev, pad=True)
    before = cc.LAUNCHES["rowstats_norms"]
    got = fs._rowstats_norms(x["M"])
    for g, w in zip(got, fs._rowstats_norms_plain(x["M"])):
        assert_close(g, w, rtol=1e-5)
    assert cc.LAUNCHES["rowstats_norms"] == before + 1


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_norm_and_adafactor_kernels_match_twins(dev, c, s, k, with_dh):
    """dm_adam with norms, gsq with and without norms, and dm_adafactor with
    and without norms, at the factors of the twin's own statistics."""
    x = inputs(c, s, k, dev, pad=True)
    m, l, _ = cc._rowstats_plain(x["M"])
    args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args, with_dh=with_dh)
    scalars = fs.adam_scalars(3, 0.1)
    k_state = [x["M"].clone(), x["mu"].clone(), x["nu"].clone()]
    p_state = [x["M"].clone(), x["mu"].clone(), x["nu"].clone()]
    norm_kw = dict(lam_l1=NORMS[0], lam_l2=NORMS[1], with_norms=True)
    got = fs._dm_adam(k_state[0], *args[1:], r, *k_state[1:], scalars,
                      with_dh=with_dh, **norm_kw)
    want = fs._dm_adam_plain(p_state[0], *args[1:], r, *p_state[1:], scalars,
                             with_dh, **norm_kw)
    assert len(got) == 8 and got[0] is k_state[0]
    for g, w in zip(got, want):
        assert_close(g, w)
    for lam in ((0.0, 0.0), NORMS):
        got = fs._gsq(*args, r, *lam, with_dh=with_dh)
        want = fs._gsq_plain(*args, r, *lam, with_dh=with_dh)
        for g, w in zip(got, want):
            assert_close(g, w)
        c_, s_ = x["M"].shape
        _, _, rowf, colf = fs.factored_rms_vectors(
            0, torch.zeros_like(want[0]), torch.zeros_like(want[1]), *want, c_, s_)
        Mk, Mp = x["M"].clone(), x["M"].clone()
        with_norms = lam != (0.0, 0.0)
        got = fs._dm_adafactor(Mk, *args[1:], r, rowf, colf, 0.1, *lam,
                               with_norms=with_norms, with_dh=with_dh)
        want = fs._dm_adafactor_plain(Mp, *args[1:], r, rowf, colf, 0.1, *lam,
                                      with_norms, with_dh)
        assert len(got) == (6 if with_norms else 4) and got[0] is Mk
        for g, w in zip(got, want):
            assert_close(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_gsq_kernel_with_prebuilt_operands_matches_twin_and_repeats(dev, c, s, k, with_dh,
                                                                     dtype):
    """gsq on the tensor-core tile, with and without the L1/L2 terms, as the
    fused Adafactor step calls it (the step's operands, built once): within
    1e-4 of the twin, the same bits as when it builds its own operands and
    on a repeat, one launch of ``gsq`` (``gsq.bf16`` for bf16 M, A, dY)."""
    x = inputs(c, s, k, dev, pad=True)
    x = {n: v.to(dtype) if n in ("M", "A", "dY") else v for n, v in x.items()}
    m, l, _ = cc._rowstats_plain(x["M"])
    args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args, with_dh=with_dh)
    ops = cc.dp_operands(x["A"], x["dY"])
    assert ops.split == (dtype == torch.float32)
    name = "gsq" if dtype == torch.float32 else "gsq.bf16"
    for lam in ((0.0, 0.0), NORMS):
        before = cc.LAUNCHES[name]
        got = fs._gsq(*args, r, *lam, with_dh=with_dh, operands=ops)
        assert cc.LAUNCHES[name] == before + 1
        for g, w in zip(got, fs._gsq_plain(*args, r, *lam, with_dh=with_dh)):
            assert_close(g, w)
        for again in (fs._gsq(*args, r, *lam, with_dh=with_dh),
                      fs._gsq(*args, r, *lam, with_dh=with_dh, operands=ops)):
            for a, b in zip(got, again):
                assert torch.equal(a, b)


# gsq's witness at the shapes where vc sums hundreds of cells. Summed over
# 8-70 cells (the other SHAPES), the largest of a few dozen sums compares a
# handful of roundings: the plain twins alone (three TF32 terms against the
# f32 product) exceed the 4x clause in 3-10% of random draws of A's
# fraction there, and in none of 100-200 draws at these two.
# chip_smoke.py's witness holds gsq at all its shapes, seeded.
@pytest.mark.parametrize("c,s,k", [(300, 600, 7), (257, 513, 129)])
def test_gsq_keeps_f32_accuracy(dev, c, s, k):
    """gsq's vr and vc against float64: the kernel errs at most 4× what the
    f32 twin errs, and a single TF32 pass (``gsq_tf32_plain(terms=1)``)
    misses the kernel by more than 10× that margin. Entropy cotangent off,
    as chip_smoke.py's witness; A's fraction from a seeded generator."""
    x = inputs(c, s, k, dev, seed=3)
    M, A, w, dY, dq, dh = (x[n] for n in ("M", "A", "w", "dY", "dq", "dh"))
    A = A + torch.rand(A.shape, generator=torch.Generator(device=dev).manual_seed(17),
                       device=dev)
    m, l, _ = cc._rowstats_plain(M)
    args = (M, A, w, m, l, dY, dq, dh)
    r = cc._rbar_plain(*args, False)
    P = torch.exp(M.double() - m.double()) / l.double()
    dP = A.double() @ dY.double().T + w.double()[:, None] * dq.double()[None, :]
    g2 = (P * (dP - r.double())) ** 2
    want = (g2.sum(dim=1), g2.sum(dim=0))
    kernel = fs._gsq(*args, r, 0.0, 0.0, with_dh=False)
    twin = fs._gsq_plain(*args, r, 0.0, 0.0, with_dh=False)
    rounded = fs.gsq_tf32_plain(*args, r, 0.0, 0.0, with_dh=False, terms=1)
    for got, plain, tf32, ref in zip(kernel, twin, rounded, want):
        margin = WITNESS[0] * float((plain.double() - ref).abs().max())
        assert float((got.double() - ref).abs().max()) <= margin
        assert float((tf32 - got).abs().max()) > WITNESS[1] * margin


@pytest.mark.parametrize("dtype,s,offset,load_bytes", [
    (torch.float32, 9_852, 0, 16), (torch.float32, 9_850, 0, 8),
    (torch.float32, 301, 0, 4), (torch.float32, 600, 1, 4),
    (torch.bfloat16, 600, 0, 16), (torch.bfloat16, 9_852, 0, 8),
    (torch.bfloat16, 9_850, 0, 4), (torch.bfloat16, 301, 0, 2),
    (torch.bfloat16, 600, 1, 2)])
def test_rowstats_load_paths_match_twins(dev, dtype, s, offset, load_bytes):
    """The row stats (with and without the norms) on rows that take each
    load width, one row all PAD (below PAD_GUARD: m = PAD, l = s, no norm)
    and a padding sentinel in another: within 1e-5 of the twins, the same
    bits on a repeat, one launch each."""
    c = 9
    rng = np.random.default_rng(s + offset)
    vals = rng.normal(0, 1, (c, s)).astype(np.float32)
    vals[2] = PAD
    vals[4, s // 2] = PAD
    buf = torch.zeros(c * s + offset + 16, dtype=dtype, device=dev)
    M = buf[offset:offset + c * s].view(c, s)
    M.copy_(torch.from_numpy(vals).to(dev).to(dtype))
    assert cc.rowstats_load_bytes(M) == load_bytes
    real = torch.arange(c, device=dev) != 2
    for kernel, twin, name in ((cc._rowstats, cc._rowstats_plain, "rowstats"),
                               (fs._rowstats_norms, fs._rowstats_norms_plain,
                                "rowstats_norms")):
        name += ".bf16" if dtype == torch.bfloat16 else ""
        before = cc.LAUNCHES[name]
        got = kernel(M)
        assert cc.LAUNCHES[name] == before + 1
        want = twin(M)
        for g, w in zip(got, want):
            assert_close(g[real], w[real], rtol=1e-5)
        m, l, u = got[:3]
        assert float(m[2]) == float(M[2, 0]) and float(l[2]) == s
        assert abs(float(u[2]) - float(want[2][2])) <= 1e-5 * abs(float(want[2][2]))
        for norm in got[3:]:
            assert float(norm[2]) == 0.0
        for a, b in zip(got, kernel(M)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_kernels_fit_with_norms_matches_cpu_reference(dev, optimizer):
    rng = np.random.default_rng(2)
    S = (rng.poisson(2.0, (60, 9)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (90, 9)) + 0.1).astype(np.float32)
    M0 = rng.normal(0, 1, (60, 90)).astype(np.float32)
    lw = LossWeights(lambda_g2=0.5, lambda_r=0.01, lambda_l1=1e-3, lambda_l2=1e-3)
    cc.reset_launches()
    M_k, h_k = fit_mapping(torch.from_numpy(M0).to(dev),
                           MapperData(torch.from_numpy(S).to(dev),
                                      torch.from_numpy(G).to(dev)),
                           lw, 25, impl="kernels", optimizer=optimizer)
    update = "dm_adam" if optimizer == "adam" else "dm_adafactor"
    assert cc.LAUNCHES["rowstats_norms"] == 1 and cc.LAUNCHES[update] == 25
    assert cc.LAUNCHES["gsq"] == (25 if optimizer == "adafactor" else 0)
    M_r, h_r = fit_mapping(torch.from_numpy(M0.copy()),
                           MapperData(torch.from_numpy(S), torch.from_numpy(G)),
                           lw, 25, impl="reference", optimizer=optimizer)
    tol = 3e-4 if optimizer == "adam" else 5e-3
    np.testing.assert_allclose(h_k["total_loss"].cpu().numpy(),
                               h_r["total_loss"].numpy(), rtol=tol, atol=tol / 10)
    np.testing.assert_allclose(M_k.cpu().numpy(), M_r.numpy(),
                               atol=3e-3 if optimizer == "adam" else 5e-3)


def test_kernels_fit_matches_cpu_reference(dev):
    rng = np.random.default_rng(1)
    S = (rng.poisson(2.0, (60, 9)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (90, 9)) + 0.1).astype(np.float32)
    d = rng.random(90).astype(np.float32)
    d /= d.sum()
    M0 = rng.normal(0, 1, (60, 90)).astype(np.float32)
    lw = LossWeights(lambda_d=1.0, lambda_g2=0.5, lambda_r=0.01)

    def data_on(device):
        return MapperData(*(torch.from_numpy(a).to(device) for a in (S, G)),
                          d=torch.from_numpy(d).to(device))

    cc.reset_launches()
    M_k, h_k = fit_mapping(torch.from_numpy(M0).to(dev), data_on(dev), lw, 25,
                           impl="kernels")
    assert cc.LAUNCHES == dict(dict.fromkeys(cc.LAUNCHES, 0), rowstats=1, project=25,
                               rbar=25, dm_adam=25)
    M_r, h_r = fit_mapping(torch.from_numpy(M0.copy()), data_on("cpu"), lw, 25,
                           impl="reference")
    np.testing.assert_allclose(h_k["total_loss"].cpu().numpy(),
                               h_r["total_loss"].numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(M_k.cpu().numpy(), M_r.numpy(), atol=3e-3)


# ---------------------------------------------------------------------------
# bf16 storage and stochastic rounding
# ---------------------------------------------------------------------------
#
# The kernels read bf16 M, mu, nu, A and dY, compute in f32 and store bf16
# as their twins do. Stored values: within 1 bf16 ulp of the twin's, and
# apart in at most 1e-3 of the entries (or one entry): the two round the
# same f32 value up to summation order, to nearest or with the same random
# bits. f32 outputs as above, except Y from a bf16 A and the next stats of
# an update. Y takes P rounded to bf16 first: an entry of P that the two
# sides' exp put a few f32 ulps apart near a bf16 rounding midpoint may
# round to either neighbour, so Y is held to Y_RTOL of max |twin| beyond
# the most such entries can move it (cc.project_rounding_slack), and a Y
# of the unrounded P must miss by more. The next stats (from the stored M)
# at 2**-7.

BF16_KEYS = ("M", "A", "dY", "mu", "nu")
Y_RTOL = 2e-5


def bf16_inputs(c, s, k, dev, pad=False):
    x = inputs(c, s, k, dev, pad=pad)
    return {key: v.to(torch.bfloat16) if key in BF16_KEYS else v for key, v in x.items()}


def assert_stored_close(got, want, rtol=1e-4):
    """Within 1 bf16 ulp beyond the f32 kernels' tolerance (rtol of the
    largest value: it matters where an update cancels, as mu near 0), and
    apart in at most 1e-3 of the entries or one."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    scale = float(w[w.abs() < -fs.PAD_GUARD].abs().max())
    diff = (g - w).abs()
    over = float(((diff - rtol * scale).clamp_min(0) / torch.exp2(e - 7)).max())
    apart = int((diff > 0).sum())
    assert over <= 1.0 and apart <= max(1, 1e-3 * w.numel()), (over, apart)


def assert_update_close(got, want, n_store):
    for g, w in zip(got[:n_store], want[:n_store]):
        assert_stored_close(g, w)
    for g, w in zip(got[n_store:], want[n_store:]):
        assert_close(g, w, rtol=2.0 ** -7)


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_bf16_forward_kernels_match_twins(dev, c, s, k):
    x = bf16_inputs(c, s, k, dev, pad=True)
    M = x["M"]
    cc.reset_launches()
    for g, w in zip(cc._rowstats(M), cc._rowstats_plain(M)):
        assert_close(g, w, rtol=1e-5)
    for g, w in zip(fs._rowstats_norms(M), fs._rowstats_norms_plain(M)):
        assert_close(g, w, rtol=1e-5)
    x = bf16_inputs(c, s, k, dev)
    M = x["M"]
    m, l, _ = cc._rowstats_plain(M)
    for A in (x["A"], x["A"].float()):
        Y, q = cc._project(M, A, x["w"], m, l)
        Yp, qp = cc._project_plain(M, A, x["w"], m, l)
        assert_close(q, qp)
        if A.dtype == torch.float32:
            assert_close(Y, Yp)
            continue
        # P rounded to bf16: within Y_RTOL beyond the rounding slack, and a
        # Y of the unrounded P misses by more
        slack = cc.project_rounding_slack(M, A, m, l)
        scale = float(Yp.abs().max())
        assert float(((Y - Yp).abs() - slack).max()) <= Y_RTOL * scale
        P = torch.exp(M.float() - m) * (1.0 / l)
        assert float(((P.T @ A.float() - Y).abs() - slack).max()) > Y_RTOL * scale
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == {
        "rowstats.bf16": 1, "rowstats_norms.bf16": 1, "project.bf16": 2}


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_bf16_backward_kernels_match_twins(dev, c, s, k, with_dh, rounding):
    """rbar, dm_adam (bf16 M, mu, nu; with and without norms), gsq and
    dm_adafactor on bf16 M, A and dY."""
    x = bf16_inputs(c, s, k, dev, pad=True)
    m, l, _ = cc._rowstats_plain(x["M"])
    args = (x["M"], x["A"], x["w"], m, l, x["dY"], x["dq"], x["dh"])
    r = cc._rbar_plain(*args, with_dh=with_dh)
    assert_close(fs._rbar(*args, with_dh=with_dh), r)
    sr = dict(rounding=rounding, step=5)
    for norm_kw in ({}, dict(lam_l1=NORMS[0], lam_l2=NORMS[1], with_norms=True)):
        k_state = [x["M"].clone(), x["mu"].clone(), x["nu"].clone()]
        p_state = [x["M"].clone(), x["mu"].clone(), x["nu"].clone()]
        got = fs._dm_adam(k_state[0], *args[1:], r, *k_state[1:], fs.adam_scalars(5, 0.1),
                          with_dh=with_dh, **norm_kw, **sr)
        want = fs._dm_adam_plain(p_state[0], *args[1:], r, *p_state[1:],
                                 fs.adam_scalars(5, 0.1), with_dh, **norm_kw, **sr)
        assert got[0] is k_state[0]
        assert_update_close(got, want, 3)
    for lam in ((0.0, 0.0), NORMS):
        vr_vc = fs._gsq_plain(*args, r, *lam, with_dh=with_dh)
        for g, w in zip(fs._gsq(*args, r, *lam, with_dh=with_dh), vr_vc):
            assert_close(g, w)
        c_, s_ = x["M"].shape
        _, _, rowf, colf = fs.factored_rms_vectors(
            0, torch.zeros_like(vr_vc[0]), torch.zeros_like(vr_vc[1]), *vr_vc, c_, s_)
        with_norms = lam != (0.0, 0.0)
        Mk, Mp = x["M"].clone(), x["M"].clone()
        got = fs._dm_adafactor(Mk, *args[1:], r, rowf, colf, 0.1, *lam,
                               with_norms=with_norms, with_dh=with_dh, **sr)
        want = fs._dm_adafactor_plain(Mp, *args[1:], r, rowf, colf, 0.1, *lam,
                                      with_norms, with_dh, **sr)
        assert_update_close(got, want, 1)


@pytest.mark.parametrize("m_dtype,mom_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.bfloat16),
                                               (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_stochastic_rounding_kernel_draws_the_twins_bits(dev, c, s, k, m_dtype,
                                                         mom_dtype):
    """With zero cotangents the Adam update is elementwise (g = 0), so the
    kernel and its twin form the same f32 values; stochastic rounding must
    then store the same bits in every array of bf16 storage."""
    x = inputs(c, s, k, dev)
    zero = dict(dY=torch.zeros_like(x["dY"]), dq=torch.zeros_like(x["dq"]),
                dh=torch.zeros_like(x["dh"]))
    M, mu, nu = x["M"].to(m_dtype), x["mu"].to(mom_dtype), x["nu"].to(mom_dtype)
    m, l, _ = cc._rowstats_plain(M)
    args = (x["A"], x["w"], m, l, zero["dY"], zero["dq"], zero["dh"],
            torch.zeros_like(m))
    kw = dict(with_dh=False, rounding="stochastic", step=7)
    got = fs._dm_adam(M.clone(), *args, mu.clone(), nu.clone(), fs.adam_scalars(7, 0.1),
                      **kw)
    want = fs._dm_adam_plain(M.clone(), *args, mu.clone(), nu.clone(),
                             fs.adam_scalars(7, 0.1), **kw)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_kernels_fit_bf16_matches_cpu_twins(dev, optimizer):
    """The fused loop at bf16 with stochastic rounding: the kernels against
    the twins on the CPU, 25 epochs at the JAX package's bf16 tolerance on
    the losses (3e-2), every launch a bf16 variant."""
    rng = np.random.default_rng(1)
    S = (rng.poisson(2.0, (60, 9)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (90, 9)) + 0.1).astype(np.float32)
    M0 = rng.normal(0, 1, (60, 90)).astype(np.float32)
    lw = LossWeights(lambda_g2=0.5, lambda_r=0.01)
    opts = dict(param_dtype="bfloat16", moment_dtype="bfloat16",
                compute_dtype="bfloat16", rounding="stochastic", optimizer=optimizer)
    cc.reset_launches()
    M_k, h_k = fit_mapping(torch.from_numpy(M0).to(dev),
                           MapperData(torch.from_numpy(S).to(dev),
                                      torch.from_numpy(G).to(dev)),
                           lw, 25, impl="kernels", **opts)
    update = "dm_adam" if optimizer == "adam" else "dm_adafactor"
    want = {"rowstats.bf16": 1, "project.bf16": 25, "rbar.bf16": 25, update + ".bf16": 25}
    if optimizer == "adafactor":
        want["gsq.bf16"] = 25
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == want
    assert M_k.dtype == torch.bfloat16
    M_r, h_r = fit_mapping(torch.from_numpy(M0.copy()),
                           MapperData(torch.from_numpy(S), torch.from_numpy(G)),
                           lw, 25, impl="fused", **opts)
    np.testing.assert_allclose(h_k["main_loss"].cpu().numpy(), h_r["main_loss"].numpy(),
                               rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# schedules, early stop, checkpoints, init draws and cross-validation on the
# card (chip_smoke.py's cv phase makes the same checks at full size)
# ---------------------------------------------------------------------------

def small_problem(dev, c=60, s=90, g=9, seed=1):
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = rng.random(s).astype(np.float32)
    data = MapperData(torch.from_numpy(S).to(dev), torch.from_numpy(G).to(dev),
                      d=torch.from_numpy(d / d.sum()).to(dev))
    return torch.from_numpy(rng.normal(0, 1, (c, s)).astype(np.float32)).to(dev), data


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_kernels_lr_vector_equals_chained_runs(dev, optimizer):
    """A cosine_lr vector sliced per epoch (``Mapper.train``'s chunking)
    against one-epoch constant fits chained with the state carried: the
    same bits on the kernels. The vector in one fit keeps the update
    kernel's row stats between steps where a new fit recomputes them with
    the rowstats kernel, in another order: with Adam that stays within
    1e-4 of the chained runs (Adafactor at lr 0.1 amplifies it; ROADMAP
    queue C)."""
    from tangram_tpu_torch.models.mapper import _train_chunked
    from tangram_tpu_torch.ops.schedules import cosine_lr

    M0, data = small_problem(dev)
    lw = LossWeights(lambda_d=1.0)
    lrs = cosine_lr(0.1, 8, end=0.01, warmup=2)
    kw = dict(impl="kernels", optimizer=optimizer)

    def run_chunk(M, state, chunk, lr_chunk, epoch):
        return fit_mapping(M, data, lw, chunk, lr_chunk, opt_state=state,
                           return_opt_state=True, **kw)

    M_sliced, _ = _train_chunked(run_chunk, M0.clone(), 8, lrs, 1, None)
    M, state = M0.clone(), None
    for t in range(8):
        M, state, _ = fit_mapping(M, data, lw, 1, float(lrs[t]), opt_state=state,
                                  return_opt_state=True, **kw)
    assert torch.equal(M_sliced, M)
    if optimizer == "adam":
        M_vec, _ = fit_mapping(M0.clone(), data, lw, 8, lrs, **kw)
        assert float((M_vec - M).abs().max()) <= 1e-4


def test_kernels_checkpoint_resume_is_bit_exact(dev, tmp_path):
    from tangram_tpu_torch import checkpoint

    M0, data = small_problem(dev)
    lw = LossWeights(lambda_d=1.0)
    kw = dict(checkpoint_every=5, impl="kernels")
    whole, h_whole = checkpoint.train_checkpointed(M0.clone(), data, lw, 15, 0.1,
                                                   tmp_path / "whole", **kw)
    checkpoint.train_checkpointed(M0.clone(), data, lw, 10, 0.1, tmp_path / "cut", **kw)
    resumed, h_res = checkpoint.train_checkpointed(M0.clone(), data, lw, 15, 0.1,
                                                   tmp_path / "cut", **kw)
    assert resumed.is_cuda and torch.equal(whole, resumed)
    for key in h_whole:
        np.testing.assert_array_equal(h_res[key], h_whole[key])


def test_kernels_early_stop_prefix(dev):
    from tangram_tpu_torch.models.mapper import Mapper

    rng = np.random.default_rng(2)
    S = (rng.poisson(2.0, (20, 8)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (12, 8)) + 0.5).astype(np.float32)
    _, hist = Mapper(S, G, device=dev, random_state=3).train(
        2000, print_each=None, early_stop_tol=1e-4, early_stop_window=50)
    n_run = len(hist["main_loss"])
    assert 0 < n_run < 2000 and n_run % 50 == 0
    _, full = Mapper(S, G, device=dev, random_state=3).train(n_run, print_each=50)
    np.testing.assert_array_equal(hist["main_loss"], full["main_loss"])


def test_device_init_draw_on_the_card(dev):
    from tangram_tpu_torch.models.mapper import init_constrained_logits, init_logits

    M = init_logits(1000, 1000, 7, "jax", device=dev)
    assert M.is_cuda and abs(float(M.mean())) < 1e-2 and abs(float(M.std()) - 1) < 1e-2
    assert torch.equal(M, init_logits(1000, 1000, 7, "jax", device=dev))
    assert not torch.equal(M, init_logits(1000, 1000, 8, "jax", device=dev))
    M_c, F_c = init_constrained_logits(30, 40, 7, "jax", device=dev)
    assert M_c.is_cuda and F_c.is_cuda and F_c.shape == (30,)


@pytest.mark.parametrize("mode", ["cells", "clusters", "constrained"])
def test_cross_val_on_the_card_matches_cpu(dev, mode):
    """The batched and loop CV on the card against the batched CV on the
    CPU, at tests/test_torch_cross_val.py's fixture and JAX's own
    batched-vs-loop bounds (train 2e-3, test 2e-2, 5e-2 constrained)."""
    import pandas as pd

    import tangram_tpu_torch as tgt

    def adatas():  # test_torch_cross_val.py's fixture (which imports jax)
        rng = np.random.default_rng(0)
        centers = rng.normal(0, 1, (3, 12)) * 2
        labels = rng.integers(0, 3, 30)
        S = rng.poisson(np.exp(centers[labels] * 0.5) + 0.5).astype(np.float32)
        G = rng.poisson(np.exp(centers[rng.integers(0, 3, 20)] * 0.5) + 0.5)
        genes = pd.DataFrame(index=[f"g{i}" for i in range(12)])
        ad_sc = tgt.AnnData(X=S, var=genes.copy(), obs=pd.DataFrame(
            {"subclass_label": pd.Categorical([f"c{lab}" for lab in labels])},
            index=[f"cell{i}" for i in range(30)]))
        ad_sp = tgt.AnnData(X=G.astype(np.float32), var=genes.copy(),
                            obs=pd.DataFrame(index=[f"s{i}" for i in range(20)]))
        tgt.pp_adatas(ad_sc, ad_sp)
        return ad_sc, ad_sp

    extra = {"cells": {}, "clusters": {"cluster_label": "subclass_label"},
             "constrained": {"target_count": 15, "density_prior": "uniform"}}[mode]
    kw = dict(mode=mode, cv_mode="10fold", num_epochs=40, random_state=42,
              verbose=False, **extra)
    want = tgt.cross_val(*adatas(), device="cpu", **kw)
    tol = 5e-2 if mode == "constrained" else 2e-2
    for batched in (True, False):
        got = tgt.cross_val(*adatas(), device=dev, batched=batched, **kw)
        assert got["avg_train_score"] == pytest.approx(want["avg_train_score"], abs=2e-3)
        assert got["avg_test_score"] == pytest.approx(want["avg_test_score"], abs=tol)


# ---------------------------------------------------------------------------
# the graph terms (spot graphs on the card)
# ---------------------------------------------------------------------------


def spot_graph(s, seed=2):
    """A k-NN spot graph of random coordinates, dense and structured."""
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch import spatial as sw

    ad = tgt.AnnData(X=np.ones((s, 1), np.float32))
    ad.obsm["spatial"] = np.random.default_rng(seed).random((s, 2))
    sw.spatial_neighbors(ad)
    return (torch.from_numpy(sw.spatial_weights(ad, True, True).astype(np.float32)),
            sw.neighbor_graph(ad, True, True))


@pytest.mark.parametrize("kind", ["dense", "knn"])
def test_graph_matmul_on_the_card_matches_cpu_and_repeats(dev, kind):
    """W @ X and its gradient on the card against the CPU (rtol 1e-5: f32
    sums in another order; TF32 off), and the same bits on a second run:
    the k-NN backward gathers through the transpose, no atomics."""
    from tangram_tpu_torch.ops.core import graph_matmul

    dense, graph = spot_graph(3_000)
    W = dense if kind == "dense" else graph
    W_dev = W.to(dev) if kind == "dense" else graph.to(dev)
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.normal(0, 1, (3_000, 64)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(0, 1, (3_000, 64)).astype(np.float32))

    def run(W, device):
        Xv = X.to(device).requires_grad_()
        out = graph_matmul(W, Xv)
        (dX,) = torch.autograd.grad(out, (Xv,), ct.to(device))
        return out.detach(), dX

    want = run(W, "cpu")
    got = run(W_dev, dev)
    again = run(W_dev, dev)
    for g, a, w in zip(got, again, want):
        assert g.device.type == dev.type
        assert_close(g.cpu(), w, rtol=1e-5)
        assert torch.equal(g, a)


@pytest.mark.parametrize("c,s,g,n_types", [(300, 600, 249, 22), (70, 301, 250, 10)])
def test_kernels_at_an_islands_width_match_twins(dev, c, s, g, n_types):
    """project, rbar and dm_adam with A = [S | one-hot cell types], k + 1 >
    256 (two project column panels, the A panel reloaded per tile in the
    dP tile), against their twins."""
    rng = np.random.default_rng(5)
    x = inputs(c, s, g, dev)
    onehot = np.eye(n_types, dtype=np.float32)[rng.integers(0, n_types, c)]
    A = torch.cat([x["A"], torch.from_numpy(onehot).to(dev)], dim=1)
    k = g + n_types
    dY = torch.from_numpy(rng.normal(0, 0.1, (s, k)).astype(np.float32)).to(dev)
    M, w, dq, dh = x["M"], x["w"], x["dq"], x["dh"]
    m, l, _ = cc._rowstats_plain(M)
    for got, want in zip(cc._project(M, A, w, m, l), cc._project_plain(M, A, w, m, l)):
        assert_close(got, want)
    args = (M, A, w, m, l, dY, dq, dh)
    r = fs._rbar(*args, with_dh=False)
    r_p = cc._rbar_plain(*args, with_dh=False)
    assert_close(r, r_p)
    scalars = fs.adam_scalars(3, 0.1)
    out = fs._dm_adam(M.clone(), A, w, m, l, dY, dq, dh, r_p, x["mu"].clone(),
                      x["nu"].clone(), scalars, with_dh=False)
    want = fs._dm_adam_plain(M.clone(), A, w, m, l, dY, dq, dh, r_p, x["mu"].clone(),
                             x["nu"].clone(), scalars, False)
    for got, ref in zip(out, want):
        assert_close(got, ref)


def test_map_cells_to_space_knn_graph_terms_on_the_card(dev):
    """The five graph terms on k-NN graphs through the kernels against the
    CPU reference loop on the same spot graph: each step through rowstats
    once, then project, rbar and dm_adam, at the losses' and the mapping's
    tolerances of tests/test_torch_mapping.py."""
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch.datasets import synthetic_mapping_pair

    ad_sc, ad_sp = synthetic_mapping_pair(200, 150, 30, n_types=5, random_state=4)
    tgt.pp_adatas(ad_sc, ad_sp)
    kw = dict(num_epochs=20, random_state=7, verbose=False, graph_format="knn",
              cluster_label="subclass_label", lambda_neighborhood_g1=0.5,
              lambda_ct_islands=0.3, lambda_getis_ord=0.3, lambda_moran=0.3,
              lambda_geary=0.3)
    cc.reset_launches()
    got = tgt.map_cells_to_space(ad_sc, ad_sp, device=dev, **kw)
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == dict(
        rowstats=1, project=20, rbar=20, dm_adam=20)
    want = tgt.map_cells_to_space(ad_sc, ad_sp, device="cpu", **kw)
    np.testing.assert_allclose(got.X, want.X, rtol=3e-3, atol=1e-7)
    for key in ("total_loss", "main_loss", "kl_reg"):
        np.testing.assert_allclose(got.uns["training_history"][key],
                                   want.uns["training_history"][key], rtol=3e-4,
                                   atol=3e-5)


def test_island_term_where_it_bites_on_the_card(dev):
    """The cell-type-island term with a standardized neighbourhood filter
    (each spot's neighbours' mean, as the CPU tests use: with the
    reference's binary filter max(·, 0) is off on every entry) on a k-NN
    graph: 10 epochs of the kernels against the reference loop on the CPU,
    at the losses' and the mapping's tolerances of the plain comparison
    (tests/test_torch_mapping.py), the penalty non-zero throughout."""
    import tangram_tpu_torch as tgt
    from tangram_tpu_torch import spatial as sw

    rng = np.random.default_rng(12)
    c, s, g, n_types = 300, 600, 40, 6
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    ct = np.eye(n_types, dtype=np.float32)[rng.integers(0, n_types, c)]
    ad = tgt.AnnData(X=np.ones((s, 1), np.float32))
    ad.obsm["spatial"] = rng.random((s, 2))
    sw.spatial_neighbors(ad)
    graph = sw.neighbor_graph(ad, True, False)
    M0 = rng.normal(0, 1, (c, s)).astype(np.float32)
    lw = LossWeights(lambda_ct_islands=0.3)

    def run(device, impl):
        data = MapperData(S=torch.from_numpy(S).to(device), G=torch.from_numpy(G).to(device),
                          ct_encode=torch.from_numpy(ct).to(device),
                          neighborhood_filter=graph.to(device))
        return fit_mapping(torch.from_numpy(M0.copy()).to(device), data, lw, 10, impl=impl)

    cc.reset_launches()
    M_k, h_k = run(dev, "kernels")
    assert {n: v for n, v in cc.LAUNCHES.items() if v} == dict(
        rowstats=1, project=10, rbar=10, dm_adam=10)
    M_r, h_r = run("cpu", "reference")
    penalty = h_k["ct_island_penalty"].cpu().numpy()
    assert (penalty > 0).all()
    for key in ("total_loss", "main_loss", "ct_island_penalty"):
        np.testing.assert_allclose(h_k[key].cpu().numpy(), h_r[key].numpy(), rtol=3e-4,
                                   atol=3e-5, err_msg=key)
    np.testing.assert_allclose(M_k.cpu().numpy(), M_r.numpy(), atol=3e-3)


def test_projected_expression_on_the_card_matches_float64(dev):
    """backend="device" on the card, in one spot chunk and in chunks that
    end mid-array, against a float64 product at 1e-5 of its largest entry,
    with TF32 off for the call although the process turned it on (restored
    after); on centered expression a TF32 product misses by more than 10x.
    backend="auto" keeps this 1.5e7-entry product on the host."""
    from tangram_tpu_torch.evaluation import _projects_on_device, projected_expression

    rng = np.random.default_rng(13)
    M = rng.dirichlet(np.full(5_000, 0.1), size=3_000).astype(np.float32)
    X = rng.poisson(2.0, (3_000, 300)).astype(np.float32)
    Xc = (X - X.mean(axis=0)).astype(np.float32)

    def rel(got, ref):
        return float(np.abs(got - ref).max() / np.abs(ref).max())

    M_dev = torch.from_numpy(M).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for Xv in (X, Xc):
            ref = (M_dev.double().T @ torch.from_numpy(Xv).to(dev).double()).cpu().numpy()
            for chunk in (16_384, 1_024, 999):
                got = projected_expression(M, Xv, backend="device", spot_chunk=chunk)
                assert got.shape == (5_000, 300) and got.dtype == np.float32
                assert rel(got, ref) <= 1e-5
                assert torch.backends.cuda.matmul.allow_tf32
        tf32 = (M_dev.T @ torch.from_numpy(Xc).to(dev)).cpu().numpy()
        assert rel(tf32, ref) > 10 * 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not _projects_on_device("auto", M.size, None)
    assert _projects_on_device("auto", 2**28, None)


# ---------------------------------------------------------------------------
# the hyperparameter tuner (no kernel: the materialized core on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("search,seed", [("sobol", 3), ("halving", 5)])
def test_tuner_on_the_card_matches_cpu(dev, search, seed):
    """A Sobol and a halving sweep on the card against the same sweeps with
    device="cpu", at tests/test_torch_tuning.py's fixture and search space
    (30 × 24 × 12, the three graph terms): the same configs and survivors,
    each metric within 1e-4 (f32 in two devices' summation orders over 30
    Adam epochs; seed 5's halving rung has a 7.0e-3 margin), and no kernel
    launched."""
    import pandas as pd

    import tangram_tpu_torch as tgt
    from tangram_tpu_torch import tuning

    def adatas():  # test_torch_tuning.py's fixture (which imports jax)
        rng = np.random.default_rng(0)
        S = (rng.poisson(2.0, (30, 12)) + 1).astype(np.float32)
        G = (rng.poisson(2.0, (24, 12)) + 1).astype(np.float32)
        genes = pd.DataFrame(index=[f"g{i}" for i in range(12)])
        ad_sc = tgt.AnnData(X=S, var=genes.copy(), obs=pd.DataFrame(
            {"subclass_label": pd.Categorical(rng.choice(["a", "b", "c"], 30))},
            index=[f"c{i}" for i in range(30)]))
        ad_sp = tgt.AnnData(X=G, var=genes.copy(),
                            obs=pd.DataFrame(index=[f"s{i}" for i in range(24)]))
        ad_sp.obsm["spatial"] = rng.random((24, 2))
        tgt.pp_adatas(ad_sc, ad_sp)
        return ad_sc, ad_sp

    space = {"learning_rate": tuning.loguniform(0.02, 0.5),
             "lambda_d": tuning.uniform(0.0, 1.0), "lambda_r": tuning.loguniform(1e-6, 1e-2),
             "lambda_neighborhood_g1": tuning.uniform(0.0, 1.0),
             "lambda_ct_islands": tuning.uniform(0.0, 1.0),
             "lambda_getis_ord": tuning.uniform(0.0, 1.0), "num_epochs": 30}
    kw = dict(metric=["gene_expr_correctness"], config=space, tuner_num_samples=8,
              cluster_label="subclass_label", random_state=seed, population_batch_size=4,
              search=search)
    frames = []
    for device in ("cpu", dev):
        np.random.seed(8)
        cc.reset_launches()
        frames.append(tgt.mapping_hyperparameter_tuning(*adatas(), device=device, **kw)
                      .get_results().get_dataframe())
        assert not any(cc.LAUNCHES.values())
    want, got = frames
    config_cols = [c for c in want.columns if c.startswith("config/")]
    pd.testing.assert_frame_equal(got[config_cols], want[config_cols], check_exact=True)
    np.testing.assert_allclose(got[tuning.METRIC_KEYS].to_numpy(),
                               want[tuning.METRIC_KEYS].to_numpy(), rtol=0, atol=1e-4)
    if search == "halving":
        np.testing.assert_array_equal(got["trained_epochs"], want["trained_epochs"])


# ---------------------------------------------------------------------------
# one mapping over a mesh (tangram_tpu_torch.parallel) and the bf16 autograd
# loop on the card (chip_smoke.py's mesh phase makes the same checks at
# full size)
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one(dev, tmp_path):
    """A process group of this process alone, on NCCL."""
    import torch.distributed as dist

    from tangram_tpu_torch import parallel as par

    par.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0)
    yield par
    dist.destroy_process_group()


@pytest.mark.parametrize("lam", [dict(lambda_d=1.0),
                                 dict(lambda_d=1.0, lambda_l1=0.01, lambda_l2=0.005)])
def test_mesh_of_one_stores_the_bits_of_one_device(dev, world_of_one, lam):
    """World size 1 on NCCL: the fused sharded fit on make_mesh(1, 1) and
    on a ("cell",) mesh, against the single-device fused loop from the same
    logits: the same bits, through the same kernels."""
    from torch.distributed.device_mesh import DeviceMesh

    par = world_of_one
    M0, data = small_problem(dev)
    lw = LossWeights(**lam)
    want = fit_mapping(M0.clone(), data, lw, 6, impl="kernels")[0].cpu()
    norms = lam.get("lambda_l1", 0) != 0
    first = "rowstats_norms" if norms else "rowstats"
    for mesh in (par.make_mesh(1, 1), DeviceMesh("cuda", torch.arange(1),
                                                  mesh_dim_names=("cell",))):
        cc.reset_launches()
        got, hist = par.fit_mapping_fused_sharded(M0.cpu(), data, lw, 6, 0.1, mesh=mesh)
        assert {k: v for k, v in cc.LAUNCHES.items() if v} == {
            first: 1, "project": 6, "rbar": 6, "dm_adam": 6}
        assert torch.equal(got, want)
        assert hist["total_loss"].is_cuda and bool(torch.isfinite(hist["total_loss"]).all())


def test_mapper_on_a_mesh_of_one_matches_one_device(dev, world_of_one):
    """``Mapper(mesh=make_mesh(1, 1)).train`` against the mapper on one
    device: the same bits of the trained logits (the mesh mapper's on the
    host), the mappings within 1e-6 (two softmaxes, the card's and the
    host's)."""
    from tangram_tpu_torch.models.mapper import Mapper

    rng = np.random.default_rng(3)
    S = (rng.poisson(2.0, (50, 9)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (70, 9)) + 0.5).astype(np.float32)
    mappers = [Mapper(S, G, random_state=5, device=dev, mesh=mesh)
               for mesh in (None, world_of_one.make_mesh(1, 1))]
    probs = [m.train(8, print_each=None)[0] for m in mappers]
    assert torch.equal(mappers[1].M, mappers[0].M.cpu())
    np.testing.assert_allclose(probs[1], probs[0], atol=1e-6)


def unit_ulps(got, want):
    """|got − want| in bf16 ulps of max(|want|, 1)."""
    got, want = got.double().cpu(), want.double().cpu()
    return (got - want).abs() / 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=1.0))) - 7)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_bf16_autograd_loop_on_the_card_matches_cpu(dev, optimizer):
    """fit_mapping(fused=False) on a bf16 M: MapperCore's bf16 kernels and
    optax's update in bf16. Step 1 within 1 bf16 ulp (of max(|M|, 1)) of
    the same loop on the CPU twins; five free-running steps in 2-norm
    within 4 times the CPU loop's own distance from itself started 1 bf16
    ulp away (tests/test_torch_bf16.py's rule)."""
    M0, data = small_problem(dev)
    M0 = M0.bfloat16()
    lw = LossWeights(lambda_d=1.0)
    cpu = MapperData(*(None if x is None else x.cpu() for x in data))

    def fit(M, d, impl, n):
        return fit_mapping(M.clone(), d, lw, n, impl=impl, fused=False, optimizer=optimizer)[0]

    cc.reset_launches()
    one = fit(M0, data, "kernels", 1)
    assert one.dtype == torch.bfloat16
    assert {k: v for k, v in cc.LAUNCHES.items() if v} == {
        "rowstats.bf16": 1, "project.bf16": 1, "backward_rbar.bf16": 1, "dm_backward.bf16": 1}
    assert float(unit_ulps(one, fit(M0.cpu(), cpu, "fused", 1)).max()) <= 1.0
    M_cpu = fit(M0.cpu(), cpu, "fused", 5)
    gen = torch.Generator().manual_seed(0)
    away = torch.where(torch.rand(M0.shape, generator=gen) < 0.5, torch.tensor(np.inf),
                       torch.tensor(-np.inf)).bfloat16()
    witness = float((fit(torch.nextafter(M0.cpu(), away), cpu, "fused", 5) - M_cpu)
                    .double().norm())
    dist = float((fit(M0, data, "kernels", 5).cpu() - M_cpu).double().norm())
    assert 0 < witness and dist <= 4.0 * witness, (dist, witness)
