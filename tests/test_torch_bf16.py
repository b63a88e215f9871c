"""bf16 storage and stochastic rounding in the PyTorch port, against the
JAX package.

The JAX package's low-precision options (``param_dtype``,
``moment_dtype``, ``compute_dtype`` and ``rounding``) act on its fused
Pallas path; the port runs the same arithmetic in its kernels' plain twins
on the CPU (and in the kernels on the card: ``tests/test_torch_cuda.py``,
``chip_smoke.py``). The JAX functions run their Pallas kernels in
interpret mode, as the JAX package's own tests do.

Tolerances:

* the counter hash and the per-row stochastic cast: bit for bit (integer
  arithmetic on the same inputs);
* each twin against its JAX kernel at round to nearest: stored bf16 values
  within 1 bf16 ulp (both compute the same f32 value up to summation
  order, so they round to the same bf16 except where that value lies
  within a few f32 ulps of a rounding midpoint); f32 outputs computed from
  identical bf16 inputs at rtol = atol = 1e-5 as in
  ``tests/test_torch_kernels.py``; Y with a bf16 A (P rounded to bf16
  before the product) within 1e-5 of its largest entry beyond what the
  entries of P near a bf16 rounding midpoint, which an exp a few f32 ulps
  apart may round to the other neighbour, can move it
  (``cuda_core.project_rounding_slack``), while a Y of the unrounded P
  must miss by more; the next stats of an update (formed from the
  stored M) at rtol 2**-7 (one stored logit a bf16 ulp apart moves m by
  at most that ulp and l, u by the same relative amount of one term);
* with stochastic rounding, JAX draws its bits per TPU tile and the port
  per cell row (``fused_step._stored``), so the two cast the same value
  with different bits: every stored value within 1 bf16 ulp of JAX's, and
  the mean difference within 0.05 ulp of 0 (both are unbiased; over the
  64 × 64 inputs the mean of the ±1-ulp differences has a standard
  deviation of about 0.01 ulp);
* ``fit_mapping``: the JAX package's own tolerances of its dtype tests
  (``tests/test_fused_step.py:113-232, :272-298``), there between bf16 and
  f32 and here between the port and JAX with the same options; and at
  nearest rounding over 10 epochs a tighter one: losses at rtol 1e-5 and
  at most 2 % of the stored logits apart, each by at most one bf16 ulp
  (of a unit logit where the logit is smaller) (measured on this problem
  on the CPU: 1.6e-6, 0.5 %, and 2**-7 at a logit of 1.2; each side
  rounds the same f32 value, up to summation order, so they part only at
  rounding midpoints).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu.models import mapper as jm
from tangram_tpu.ops import fused_step as jfs
from tangram_tpu.ops import pallas_core as jpc
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu_torch.convert import mapper_data_from_jax, state_from_jax
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import cuda_core as cc
from tangram_tpu_torch.ops import fused_step as tfs
from tangram_tpu_torch.ops.losses import LossWeights

from test_torch_mapping import pairs

BF16 = dict(param_dtype="bfloat16", moment_dtype="bfloat16", compute_dtype="bfloat16")
SHAPES = [(37, 53, 7), (64, 64, 16)]
PAD = -1e25  # a padding sentinel: below PAD_GUARD, so it takes no norm


def f32(x):
    """A JAX array or a tensor of any float type as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ulps(got, want):
    """|got − want| in bf16 ulps at ``want`` (8 significant bits)."""
    got, want = f32(got), f32(want)
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return np.abs(got - want) / 2.0 ** (e - 7)


def signed_ulps(got, want):
    got, want = f32(got), f32(want)
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return (got - want) / 2.0 ** (e - 7)


def close(got, want, rtol=1e-5):
    np.testing.assert_allclose(f32(got), f32(want), rtol=rtol, atol=rtol)


# ---------------------------------------------------------------------------
# the counter hash and the stochastic cast
# ---------------------------------------------------------------------------


def test_wang_hash_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 61, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 1],
                    dtype=np.uint64)
    x = np.concatenate([edge, rng.integers(0, 2**32, 65536 - edge.size,
                                           dtype=np.uint64)]).astype(np.uint32)
    want = np.asarray(jfs._wang_hash(jnp.asarray(x, jnp.uint32)))
    got = tfs._wang_hash(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_sr_cast_rows_match_jax_bit_for_bit(seed):
    """The port's per-row cast of each row against JAX's ``_sr_cast`` of
    that row as a (1, n) tile with the same seed."""
    rng = np.random.default_rng(seed % 1000)
    rows = (rng.standard_normal((4, 300)) * 10.0 ** rng.integers(-6, 6, (4, 1)))
    rows = rows.astype(np.float32)
    rows[0, :6] = [0.0, -0.0, 1e-30, -1e30, 3.0, -PAD]
    seeds = np.array([seed, seed ^ 1, 12345, 2**31 + 7], dtype=np.uint32)
    got = tfs._sr_cast(torch.from_numpy(rows), torch.bfloat16,
                       torch.from_numpy(seeds.astype(np.int64))[:, None])
    assert got.dtype == torch.bfloat16
    for i in range(4):
        want = jfs._sr_cast(jnp.asarray(rows[i][None, :]), jnp.bfloat16,
                            jnp.uint32(seeds[i]))
        np.testing.assert_array_equal(got[i].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want)[0].view(np.uint16))
    x = torch.from_numpy(rows)
    assert tfs._sr_cast(x, torch.float32, 3) is x  # the identity for f32


def test_sr_stores_unbiased_and_deterministic():
    """As ``tests/test_fused_step.py::test_sr_cast_unbiased_and_deterministic``,
    through the stores of the update twins (``_stored``): a value halfway
    between two bf16 lands on one of them, about half the time on each; the
    same step gives the same bits, another step others; f32 is kept."""
    one = torch.tensor(1.0, dtype=torch.bfloat16)
    nxt = float(torch.nextafter(one, torch.tensor(2.0, dtype=torch.bfloat16)))
    val = torch.full((64, 256), (1.0 + nxt) / 2.0)
    out = tfs._stored(val, torch.bfloat16, "stochastic", 7, 1).float()
    assert set(out.unique().tolist()) <= {1.0, nxt}
    assert 0.4 < float((out == nxt).float().mean()) < 0.6
    assert torch.equal(out, tfs._stored(val, torch.bfloat16, "stochastic", 7, 1).float())
    assert not torch.equal(out, tfs._stored(val, torch.bfloat16, "stochastic", 8, 1).float())
    assert not torch.equal(out, tfs._stored(val, torch.bfloat16, "stochastic", 7, 2).float())
    assert tfs._stored(val, torch.float32, "stochastic", 7, 1) is val
    near = tfs._stored(val, torch.bfloat16, "nearest", 7, 1)
    assert torch.equal(near, val.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# each twin against its JAX kernel
# ---------------------------------------------------------------------------


def make_inputs(c, s, k, seed=0, pad=False):
    """Seeded inputs as ``tests/test_torch_kernels.py`` makes them, with M,
    A, dY, mu and nu rounded to bf16 once, so both sides read the same."""
    rng = np.random.default_rng(seed)
    M = rng.normal(0, 1, (c, s)).astype(np.float32)
    if pad:
        M[0, 1 % s] = PAD
    x = dict(M=M, A=rng.poisson(1.5, (c, k)).astype(np.float32),
             w=(rng.random(c) / c).astype(np.float32),
             dY=rng.normal(0, 0.1, (s, k)).astype(np.float32),
             dq=rng.normal(0, 1, s).astype(np.float32),
             dh=rng.normal(0, 0.1, c).astype(np.float32),
             mu=rng.normal(0, 1e-3, (c, s)).astype(np.float32),
             nu=(rng.random((c, s)) * 1e-6).astype(np.float32))
    for key in ("M", "A", "dY", "mu", "nu"):
        x[key] = f32(jnp.asarray(x[key]).astype(jnp.bfloat16))
    return x


def J(x, bf16=False):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def T(x, bf16=False):
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t.to(torch.bfloat16) if bf16 else t


def jax_args(x, m, l):
    return (J(x["M"], True), jpc._pad_k(J(x["A"])).astype(jnp.bfloat16), J(x["w"]),
            J(m), J(l), jpc._pad_k(J(x["dY"])).astype(jnp.bfloat16), J(x["dq"]),
            J(x["dh"]))


def torch_args(x, m, l):
    return (T(x["M"], True), T(x["A"], True), T(x["w"]), T(m), T(l),
            T(x["dY"], True), T(x["dq"]), T(x["dh"]))


def jax_stats(x):
    return [np.asarray(v) for v in jpc._rowstats(J(x["M"], True))]


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rowstats_twins_match_jax_on_bf16(c, s, k):
    """Rows 1 and 5: the stats (and norms) of a bf16 M, f32 out."""
    x = make_inputs(c, s, k, pad=True)
    M = T(x["M"], True)
    for got, want in ((cc._rowstats(M), jax_stats(x)),
                      (tfs._rowstats_norms(M), jfs._rowstats_norms(J(x["M"], True)))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == (c, 1)
            close(g, w)


@pytest.mark.parametrize("a_bf16", [True, False])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_project_twin_matches_jax_on_bf16(c, s, k, a_bf16):
    """Row 2 with a bf16 M: a bf16 A (the fused steps: Y takes P rounded to
    bf16, q the f32 P) and an f32 A (the validation metrics)."""
    x = make_inputs(c, s, k)
    m, l, _ = jax_stats(x)
    A_j = jpc._pad_k(J(x["A"]))
    Yj, qj = jpc._project(J(x["M"], True), A_j.astype(jnp.bfloat16) if a_bf16 else A_j,
                          J(x["w"]), J(m), J(l))
    M, A = T(x["M"], True), T(x["A"], a_bf16)
    Y, q = cc._project(M, A, T(x["w"]), T(m), T(l))
    assert Y.dtype == q.dtype == torch.float32
    close(q, qj)
    Yj = T(np.asarray(Yj)[:, :k])
    if not a_bf16:
        close(Y, Yj)
        return
    # beyond the entries of P that another exp may round to the other bf16
    # neighbour, Y within 1e-5 of max |Y|; a Y of the f32 P misses by more
    slack = cc.project_rounding_slack(M, A, T(m), T(l))
    scale = float(Yj.abs().max())
    assert float(((Y - Yj).abs() - slack).max()) <= 1e-5 * scale
    P = torch.exp(M.float() - T(m)) * (1.0 / T(l))
    assert float(((P.T @ A.float() - Yj).abs() - slack).max()) > 1e-5 * scale


def test_project_bf16_a_takes_one_exact_pass_and_q_the_f32_p():
    """What the tensor-core kernel forms with a bf16 A: Y is bf16(P)ᵀ A with
    exact products and f32 sums (one bf16 pass: within 1e-6 of the float64
    product of the same rounded operands), q = wP from the f32 P (within
    1e-6 of float64; a q of bf16(P) misses by more than 1e-4), and its X
    operand is A's bf16 rows padded to 8 entries, w apart."""
    x = make_inputs(300, 50, 13)
    M, A, w = T(x["M"], True), T(x["A"], True), T(x["w"])
    m, l, _ = cc._rowstats_plain(M)
    Y, q = cc._project(M, A, w, m, l)
    P = torch.exp(M.double() - m.double()) / l.double()
    Pb = (torch.exp(M.float() - m) * (1.0 / l)).to(torch.bfloat16).double()
    for got, want in ((Y, Pb.T @ A.double()), (q, w.double() @ P)):
        assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    q_rounded = w.double() @ Pb
    assert float((q_rounded - w.double() @ P).abs().max()) > 1e-4 * float(q.abs().max())
    X, lda = cc.project_operand(A, w)
    assert X.dtype == torch.bfloat16 and lda == 16 and torch.equal(X[:, :13], A)


def jax_rbar(x, m, l, with_dh):
    return np.asarray(jfs._rbar(*jax_args(x, m, l), with_dh=with_dh))


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_rbar_twin_matches_jax_on_bf16(c, s, k, with_dh):
    """Row 3: bf16 M, A and dY; w, dq, dh f32."""
    x = make_inputs(c, s, k)
    m, l, _ = jax_stats(x)
    r = tfs._rbar(*torch_args(x, m, l), with_dh=with_dh)
    close(r, jax_rbar(x, m, l, with_dh))


def check_update(got, want, n_store, sr):
    """Stored (c, s) outputs within 1 bf16 ulp (and for stochastic rounding
    with a mean difference within 0.05 ulp of 0); the next stats at rtol
    2**-7 of JAX's at nearest rounding, and with stochastic rounding (where
    the two store differently drawn neighbours) at 1e-6 of the stats of the
    port's own stored M."""
    assert len(got) == len(want)
    for g, w in zip(got[:n_store], want[:n_store]):
        assert g.dtype == torch.bfloat16
        assert ulps(g, w).max() <= 1.0
        if sr:
            d = signed_ulps(g, w)
            assert 0.05 < (d != 0).mean() and abs(d.mean()) <= 0.05
    if sr:
        stats = (tfs._rowstats_norms_plain if len(got) - n_store == 5
                 else cc._rowstats_plain)(got[0])
        want = list(want[:n_store]) + list(stats)
    for g, w in zip(got[n_store:], want[n_store:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-6 if sr else 2.0 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("with_dh,norms", [(True, False), (False, True)])
def test_dm_adam_twin_matches_jax_on_bf16(with_dh, norms, rounding):
    """Row 4: bf16 M, mu, nu (in place), A and dY, with and without the
    L1/L2 terms, stored to nearest or stochastically."""
    c, s, k = SHAPES[1]
    x = make_inputs(c, s, k, pad=norms)
    m, l, _ = jax_stats(x)
    r = jax_rbar(x, m, l, with_dh)
    step = 3
    lr, bc1, bc2 = tfs.adam_scalars(step, 0.1)
    lam = (0.01, 0.02) if norms else (0.0, 0.0)
    want = jfs._dm_adam(*jax_args(x, m, l), J(r), J(x["mu"], True), J(x["nu"], True),
                        jnp.asarray([[lr, bc1, bc2, float(step)]], jnp.float32), *lam,
                        with_norms=norms, sr=rounding == "stochastic", with_dh=with_dh)
    M, mu, nu = T(x["M"], True), T(x["mu"], True), T(x["nu"], True)
    got = tfs._dm_adam(M, *torch_args(x, m, l)[1:], T(r), mu, nu, (lr, bc1, bc2),
                       with_dh=with_dh, lam_l1=lam[0], lam_l2=lam[1], with_norms=norms,
                       rounding=rounding, step=step)
    assert got[0] is M and got[1] is mu and got[2] is nu
    check_update(got, want, 3, rounding == "stochastic")


@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.01, 0.02)])
def test_gsq_twin_matches_jax_on_bf16(lam):
    """Row 8: Adafactor's statistics from bf16 M, A and dY (f32 out), held
    to 1e-5 of their largest entry as in ``tests/test_torch_kernels.py``."""
    c, s, k = SHAPES[0]
    x = make_inputs(c, s, k, pad=lam != (0.0, 0.0))
    m, l, _ = jax_stats(x)
    r = jax_rbar(x, m, l, True)
    want = jfs._gsq(*jax_args(x, m, l), J(r), *lam)
    got = tfs._gsq(*torch_args(x, m, l), T(r), *lam)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(f32(g), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("lam", [(0.0, 0.0), (0.01, 0.02)])
@pytest.mark.parametrize("c,s,k", SHAPES)
def test_gsq_with_prebuilt_operands_matches_jax_on_bf16(c, s, k, lam):
    """Row 8b as the fused Adafactor step calls it: on the step's operands
    of bf16 A and dY (one exact product), equal to the call without them
    bit for bit and to the JAX kernel at 1e-5 of the largest entry; f32
    operands of the same shape are taken too (the split product)."""
    x = make_inputs(c, s, k, pad=lam != (0.0, 0.0))
    m, l, _ = jax_stats(x)
    r = jax_rbar(x, m, l, True)
    args = torch_args(x, m, l)
    ops = cc.dp_operands(args[1], args[5])
    assert not ops.split
    got = tfs._gsq(*args, T(r), *lam, operands=ops)
    for g, own in zip(got, tfs._gsq(*args, T(r), *lam)):
        assert torch.equal(g, own)
    want = jfs._gsq(*jax_args(x, m, l), J(r), *lam)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(f32(g), w, rtol=0, atol=1e-5 * np.abs(w).max())
    assert cc.dp_operands(args[1].float(), args[5].float()).split


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("norms", [False, True])
def test_dm_adafactor_twin_matches_jax_on_bf16(norms, rounding):
    """Row 9: M −= lr·g·rowf⊗colf on a bf16 M, stored to nearest or
    stochastically, at the factors of this step's own statistics."""
    c, s, k = SHAPES[1]
    lam = (0.01, 0.02) if norms else (0.0, 0.0)
    x = make_inputs(c, s, k, pad=norms)
    m, l, _ = jax_stats(x)
    r = jax_rbar(x, m, l, True)
    vr_sum, vc_sum = jfs._gsq(*jax_args(x, m, l), J(r), *lam)
    _, _, rowf, colf = jfs.factored_rms_vectors(
        jnp.zeros((), jnp.int32), jnp.zeros((c,)), jnp.zeros((s,)), vr_sum, vc_sum, c, s)
    want = jfs._dm_adafactor(*jax_args(x, m, l), J(r), rowf, colf,
                             jnp.asarray([[0.1, 1.0]], jnp.float32), *lam,
                             with_norms=norms, sr=rounding == "stochastic")
    M = T(x["M"], True)
    got = tfs._dm_adafactor(M, *torch_args(x, m, l)[1:], T(r), T(rowf), T(colf), 0.1,
                            *lam, with_norms=norms, rounding=rounding, step=1)
    assert got[0] is M
    check_update(got, want, 1, rounding == "stochastic")


@pytest.mark.parametrize("c,s,k", SHAPES)
def test_mapper_core_on_bf16_m_matches_jax(c, s, k):
    """Rows 6-7 with a bf16 M: ``MapperCore`` forward and backward (the
    twins on the CPU) against ``jax.vjp`` of ``mapper_core_pallas`` on the
    same bf16 M, f32 A and w and seeded cotangents: Y, q, h, dA and dw in
    f32 at rtol = atol = 1e-5, dM stored in bf16 by both, within one bf16
    ulp beyond 1e-5 of its largest entry."""
    import jax

    x = make_inputs(c, s, k)
    rng = np.random.default_rng(9)
    cts = [rng.normal(0, 1, shape).astype(np.float32) for shape in ((s, k), (s,), (c,))]
    out_j, vjp = jax.vjp(jpc.mapper_core_pallas, J(x["M"], True), J(x["A"]), J(x["w"]))
    grads_j = vjp(tuple(J(g) for g in cts))
    assert grads_j[0].dtype == jnp.bfloat16
    with torch.enable_grad():
        leaves = [T(x["M"], True).requires_grad_(), T(x["A"]).requires_grad_(),
                  T(x["w"]).requires_grad_()]
        outs = cc.MapperCore.apply(*leaves)
        loss = sum((o * T(g)).sum() for o, g in zip(outs, cts))
        grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(outs, out_j):
        assert g.dtype == torch.float32
        close(g.detach(), w)
    dM, dA, dw = grads
    assert dM.dtype == torch.bfloat16 and dA.dtype == dw.dtype == torch.float32
    want = f32(grads_j[0])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    excess = np.abs(f32(dM) - want) - 1e-5 * np.abs(want).max()
    assert (excess / ulp).max() <= 1.0
    close(dA, grads_j[1])
    close(dw, grads_j[2])


def test_update_stats_come_from_the_stored_values():
    """The next stats are those of the stored bf16 M, not of the f32 values
    before rounding: recomputed from the stored M they agree at f32
    precision."""
    x = make_inputs(*SHAPES[1])
    m, l, _ = jax_stats(x)
    args = torch_args(x, m, l)
    r = tfs._rbar(*args)
    M, mu, nu = args[0].clone(), T(x["mu"], True), T(x["nu"], True)
    out = tfs._dm_adam(M, *args[1:], r, mu, nu, tfs.adam_scalars(1, 0.1),
                       rounding="stochastic", step=1)
    for g, w in zip(out[3:], cc._rowstats_plain(M)):
        close(g, w, rtol=1e-6)


def test_wrappers_take_bf16_only_where_jax_does():
    x = make_inputs(8, 12, 3)
    m, l, _ = jax_stats(x)
    args = torch_args(x, m, l)
    r = tfs._rbar(*args)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cc._rowstats(T(x["M"]).half())
    with pytest.raises(TypeError, match="w must be float32"):
        cc._project(args[0], args[1], args[2].to(torch.bfloat16), args[3], args[4])
    # the unfused backward takes a bf16 M (MapperCore's gradient) with the
    # f32 A and cotangent dY that MapperCore hands it
    with pytest.raises(TypeError, match="A must be float32"):
        cc._dm_backward(*args, r)
    with pytest.raises(TypeError, match="A must be float32"):
        cc._backward(*args)
    with pytest.raises(TypeError, match="dY must be float32"):
        cc._backward(args[0], args[1].float(), *args[2:])
    with pytest.raises(ValueError, match="rounding"):
        tfs._dm_adam(args[0].clone(), *args[1:], r, T(x["mu"]), T(x["nu"]),
                     tfs.adam_scalars(1, 0.1), rounding="Stochastic")
    assert tfs.init_fused_opt_state(args[0], torch.bfloat16)[1].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# fit_mapping against the JAX fused path
# ---------------------------------------------------------------------------


def make_problem(rng, c=40, s=72, g=9):
    """``tests/test_fused_step.py::make_problem``."""
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = rng.random(s).astype(np.float32)
    d /= d.sum()
    data = JMapperData(S=jnp.asarray(S), G=jnp.asarray(G), d=jnp.asarray(d))
    return np.asarray(jm.init_logits(c, s, 3, "numpy")), data


def fit_both(M0, jdata, lam, epochs, **opts):
    p_j, h_j = jm.fit_mapping(jnp.asarray(M0), jdata, JLossWeights(**lam), epochs, 0.1,
                              impl="pallas", fused=True, **opts)
    p_t, h_t = tm.fit_mapping(torch.from_numpy(M0.copy()), mapper_data_from_jax(jdata),
                              LossWeights(**lam), epochs, 0.1, impl="fused", **opts)
    return p_j, {k: np.asarray(v) for k, v in h_j.items()}, p_t, {
        k: v.numpy() for k, v in h_t.items()}


def softmax(M):
    return torch.softmax(torch.from_numpy(f32(M)), dim=1).numpy()


# (options, epochs, history key, loss rtol = atol, logits atol, softmax atol):
# the JAX package's tolerances of tests/test_fused_step.py:113-209
JAX_DTYPE_CASES = [
    (dict(moment_dtype="bfloat16"), 30, "total_loss", 5e-3, 2e-2, None),
    (dict(compute_dtype="bfloat16", moment_dtype="bfloat16"), 30, "main_loss", 2e-2,
     None, None),
    (BF16, 30, "main_loss", 3e-2, None, 5e-2),
]


@pytest.mark.parametrize("opts,epochs,key,loss_tol,m_tol,p_tol", JAX_DTYPE_CASES)
def test_fused_fit_with_jax_dtype_cases_matches_jax(rng, opts, epochs, key, loss_tol,
                                                    m_tol, p_tol):
    M0, jdata = make_problem(rng)
    p_j, h_j, p_t, h_t = fit_both(M0, jdata, dict(lambda_g1=1.0, lambda_d=1.0), epochs,
                                  **opts)
    want = torch.bfloat16 if opts.get("param_dtype") == "bfloat16" else torch.float32
    assert p_t.dtype == want and p_j.dtype == (jnp.bfloat16 if want == torch.bfloat16
                                               else jnp.float32)
    np.testing.assert_allclose(h_t[key], h_j[key], rtol=loss_tol, atol=loss_tol)
    if m_tol:
        np.testing.assert_allclose(f32(p_t), f32(p_j), atol=m_tol)
    if p_tol:
        np.testing.assert_allclose(softmax(p_t), softmax(p_j), atol=p_tol)


def test_bf16_nearest_fit_tracks_jax_closely(rng):
    """All three dtypes bf16, round to nearest, 10 epochs: the tighter
    tolerance of the module docstring."""
    M0, jdata = make_problem(rng)
    p_j, h_j, p_t, h_t = fit_both(M0, jdata, dict(lambda_g1=1.0, lambda_d=1.0), 10,
                                  **BF16)
    for key in ("total_loss", "main_loss", "kl_reg"):
        np.testing.assert_allclose(h_t[key], h_j[key], rtol=1e-5, atol=1e-7)
    # one bf16 ulp of the logit, or of a unit logit where it is smaller (a
    # logit that parted at rounding stays parted by about the ulp it parted
    # by while Adam moves it toward 0)
    d = np.abs(f32(p_t) - f32(p_j))
    assert (d <= 2.0 ** -7 * np.maximum(np.abs(f32(p_j)), 1.0)).all()
    assert (d > 0).mean() <= 0.02


def test_bf16_params_with_validation_matches_jax(rng):
    """``tests/test_fused_step.py::test_bf16_params_with_validation``: the
    validation metrics of a bf16 M (f32 w, f32 S) every 4 epochs, finite
    and within its 3e-2 of JAX's."""
    M0, jdata = make_problem(rng)
    val_j = JMapperData(S=jdata.S[:, :4], G=jdata.G[:, :4])
    lam = dict(lambda_g1=1.0, lambda_d=1.0)
    _, h_j = jm.fit_mapping(jnp.asarray(M0), jdata, JLossWeights(**lam), 12, 0.1,
                            impl="pallas", fused=True, param_dtype="bfloat16",
                            with_val=True, val_data=val_j, val_each=4)
    p_t, h_t = tm.fit_mapping(torch.from_numpy(M0.copy()), mapper_data_from_jax(jdata),
                              LossWeights(**lam), 12, 0.1, impl="fused",
                              param_dtype="bfloat16", with_val=True,
                              val_data=mapper_data_from_jax(val_j), val_each=4)
    assert p_t.dtype == torch.bfloat16
    vg = h_t["val_gene_sim"].numpy()
    assert np.isfinite(vg[::4]).all() and np.isnan(vg[1::4]).all()
    np.testing.assert_allclose(vg[::4], np.asarray(h_j["val_gene_sim"])[::4], atol=3e-2)


def test_sr_fit_tracks_jax_and_repeats_bit_for_bit(rng):
    """``tests/test_fused_step.py::test_sr_training_tracks_f32``: bf16
    params and moments with stochastic rounding for 60 epochs, the final
    score within its 2e-2 of JAX's stochastic run (whose bits differ); two
    runs of the port from the same start are identical, bit for bit."""
    c, s, g = 48, 40, 12
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = rng.random(s).astype(np.float32)
    d /= d.sum()
    jdata = JMapperData(S=jnp.asarray(S), G=jnp.asarray(G), d=jnp.asarray(d))
    M0 = np.asarray(jm.init_logits(c, s, 3, "numpy"))
    opts = dict(param_dtype="bfloat16", moment_dtype="bfloat16", rounding="stochastic")
    _, h_j, p_t, h_t = fit_both(M0, jdata, dict(lambda_g1=1.0, lambda_d=1.0), 60, **opts)
    assert np.isfinite(h_t["main_loss"]).all()
    np.testing.assert_allclose(h_t["main_loss"][-1], h_j["main_loss"][-1], atol=2e-2)
    p_2, _, h_2 = tm.fit_mapping(torch.from_numpy(M0.copy()), mapper_data_from_jax(jdata),
                                 LossWeights(lambda_g1=1.0, lambda_d=1.0), 60, 0.1,
                                 impl="fused", return_opt_state=True, **opts)
    assert torch.equal(p_2.view(torch.int16), p_t.view(torch.int16))
    np.testing.assert_array_equal(h_2["main_loss"].numpy(), h_t["main_loss"])


def test_one_sr_step_from_converted_bf16_state_matches_jax(rng):
    """Three JAX steps in bf16 with stochastic rounding, the bf16 state
    carried across by ``state_from_jax`` (bit for bit), then one step in
    each package: stored values within 1 bf16 ulp, losses at 1e-5."""
    M0, jdata = make_problem(rng)
    jlw = JLossWeights(lambda_g1=1.0, lambda_d=1.0, lambda_r=0.05)
    M = jnp.asarray(M0).astype(jnp.bfloat16)
    count, mu, nu = jfs.init_fused_opt_state(M, jnp.bfloat16)
    stats = jfs.initial_stats(M, jlw)
    kw = dict(compute_dtype=jnp.bfloat16, rounding="stochastic")
    for _ in range(3):
        M, count, mu, nu, stats, _ = jfs.fused_unconstrained_step(
            M, count, mu, nu, stats, jdata, jlw, 0.1, **kw)
    state = state_from_jax(M, count, mu, nu, stats)
    assert state[0].dtype == state[2].dtype == torch.bfloat16
    np.testing.assert_array_equal(state[0].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(M).view(np.uint16))
    want = jfs.fused_unconstrained_step(M, count, mu, nu, stats, jdata, jlw, 0.1, **kw)
    got = tfs.fused_unconstrained_step(
        *state, mapper_data_from_jax(jdata),
        LossWeights(lambda_g1=1.0, lambda_d=1.0, lambda_r=0.05), 0.1,
        compute_dtype=torch.bfloat16, rounding="stochastic")
    assert got[1] == 4
    for g, w in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        assert g.dtype == torch.bfloat16 and ulps(g, w).max() <= 1.0
    for key in ("total_loss", "main_loss", "kl_reg", "entropy_reg"):
        assert float(got[5][key]) == pytest.approx(float(want[5][key]), rel=1e-5)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_constrained_bf16_fit_matches_jax(rng, rounding):
    """The fused constrained step with bf16 M, moments and compute (F and
    its moments f32), 25 epochs: the losses at bf16's 3e-2 and the filters
    at 5e-2; at nearest rounding also the mappings at 5e-2 (with stochastic
    rounding the two packages draw different bits, and as in the JAX
    package's own stochastic tests only the scores are compared)."""
    M0, jdata = make_problem(rng)
    jdata = jdata._replace(target_count=jnp.float32(25.0))
    F0 = np.random.default_rng(7).normal(size=M0.shape[0]).astype(np.float32)
    lam = dict(lambda_g1=1.0, lambda_d=1.0, lambda_r=0.01, lambda_count=1.0,
               lambda_f_reg=1.0)
    opts = dict(BF16, rounding=rounding)
    p_j, h_j = jm.fit_mapping((jnp.asarray(M0), jnp.asarray(F0)), jdata,
                              JLossWeights(**lam), 25, 0.1, constrained=True,
                              impl="pallas", fused=True, **opts)
    (M_t, F_t), opt_t, h_t = tm.fit_mapping(
        (torch.from_numpy(M0.copy()), torch.from_numpy(F0.copy())),
        mapper_data_from_jax(jdata), LossWeights(**lam), 25, 0.1, constrained=True,
        impl="fused", return_opt_state=True, **opts)
    assert M_t.dtype == torch.bfloat16 and F_t.dtype == torch.float32
    assert opt_t[1][0].dtype == torch.bfloat16 and opt_t[1][1].dtype == torch.float32
    for key in ("total_loss", "main_loss", "count_reg"):
        np.testing.assert_allclose(h_t[key].numpy(), np.asarray(h_j[key]), rtol=3e-2,
                                   atol=3e-2)
    if rounding == "nearest":
        np.testing.assert_allclose(softmax(M_t), softmax(p_j[0]), atol=5e-2)
    np.testing.assert_allclose(torch.sigmoid(F_t).numpy(),
                               np.asarray(1 / (1 + np.exp(-f32(p_j[1])))), atol=5e-2)


def test_adafactor_bf16_fit_matches_jax(rng):
    """The fused Adafactor step on a bf16 M (factors f32) with bf16 compute,
    8 epochs at the Adafactor tolerances of ``tests/test_adafactor.py``
    (losses rtol = atol = 5e-3), stochastically and to nearest."""
    M0, jdata = make_problem(rng)
    for rounding in ("nearest", "stochastic"):
        p_j, h_j, p_t, h_t = fit_both(M0, jdata, dict(lambda_g1=1.0, lambda_d=1.0), 8,
                                      optimizer="adafactor", rounding=rounding, **BF16)
        assert p_t.dtype == torch.bfloat16
        for key in ("total_loss", "main_loss"):
            np.testing.assert_allclose(h_t[key], h_j[key], rtol=5e-3, atol=5e-3)


def test_rounding_validation_matches_jax(rng):
    """``tests/test_fused_step.py::test_rounding_validation`` without its
    mesh cases, each error raised by both packages."""
    M0, jdata = make_problem(rng, c=24, s=20, g=8)
    S, G = np.asarray(jdata.S), np.asarray(jdata.G)
    data, lw = mapper_data_from_jax(jdata), LossWeights(lambda_g1=1.0)
    jlw = JLossWeights(lambda_g1=1.0)
    M = torch.from_numpy(M0.copy())
    cases = [
        ("rounding", lambda: jm.Mapper(S=S, G=G, rounding="Stochastic"),
         lambda: tm.Mapper(S=S, G=G, rounding="Stochastic", device="cpu")),
        ("rounding", lambda: jm.MapperConstrained(S=S, G=G, d=None, rounding="up"),
         lambda: tm.MapperConstrained(S=S, G=G, d=None, rounding="up", device="cpu")),
        ("stochastic", lambda: jm.fit_mapping(jnp.asarray(M0), jdata, jlw, 5, 0.1,
                                              impl="xla", param_dtype="bfloat16",
                                              rounding="stochastic"),
         lambda: tm.fit_mapping(M, data, lw, 5, 0.1, impl="reference",
                                param_dtype="bfloat16", rounding="stochastic")),
        ("stochastic", lambda: jm.fit_mapping(jnp.asarray(M0), jdata, jlw, 5, 0.1,
                                              impl="pallas", fused=False,
                                              rounding="stochastic"),
         lambda: tm.fit_mapping(M, data, lw, 5, 0.1, impl="fused", fused=False,
                                rounding="stochastic")),
        ("float32/bfloat16", lambda: jm.fit_mapping(
            jnp.asarray(M0), jdata, jlw, 5, 0.1, impl="pallas", fused=True,
            param_dtype="float16", rounding="stochastic"),
         lambda: tm.fit_mapping(M, data, lw, 5, 0.1, impl="fused",
                                param_dtype="float16", rounding="stochastic")),
        ("float32/bfloat16", lambda: jm.Mapper(S=S, G=G, param_dtype="float16",
                                               rounding="stochastic"),
         lambda: tm.Mapper(S=S, G=G, param_dtype="float16", rounding="stochastic",
                           device="cpu")),
        ("float32/bfloat16", lambda: jm.Mapper(S=S, G=G, moment_dtype="float16",
                                               rounding="stochastic"),
         lambda: tm.Mapper(S=S, G=G, moment_dtype="float16", rounding="stochastic",
                           device="cpu")),
    ]
    for match, jax_call, torch_call in cases:
        for call in (jax_call, torch_call):
            with pytest.raises(ValueError, match=match):
                call()
    # constrained Adafactor trains on the generic path in both
    jdc = jdata._replace(target_count=jnp.float32(10.0))
    F0 = np.zeros(M0.shape[0], np.float32)
    with pytest.raises(ValueError, match="stochastic"):
        jm.fit_mapping((jnp.asarray(M0), jnp.asarray(F0)), jdc, jlw, 2, 0.1,
                       constrained=True, optimizer="adafactor", impl="pallas",
                       fused=True, rounding="stochastic")
    with pytest.raises(ValueError, match="stochastic"):
        tm.fit_mapping((M, torch.from_numpy(F0)), mapper_data_from_jax(jdc), lw, 2, 0.1,
                       constrained=True, optimizer="adafactor", impl="fused",
                       rounding="stochastic")
    # the port's own: a bf16 M cannot train on the autograd loop yet
    with pytest.raises(NotImplementedError, match="ROADMAP queue A4"):
        tm.fit_mapping(M.to(torch.bfloat16), data, lw, 1, impl="fused", fused=False)
    with pytest.raises(ValueError, match="compute_dtype must be float32 or bfloat16"):
        tm.fit_mapping(M, data, lw, 1, impl="fused", compute_dtype="float16")


# ---------------------------------------------------------------------------
# the public entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cells", "clusters", "constrained"])
def test_map_cells_to_space_bf16_returns_an_f32_mapping(mode):
    """bf16 storage with stochastic rounding through ``map_cells_to_space``
    in every mode (the fused loops on the twins): an f32 mapping whose rows
    sum to 1, a bf16 M behind it, and the train-gene report of it."""
    _, (sc_t, sp_t) = pairs()
    kw = dict(mode=mode, num_epochs=12, random_state=7, verbose=False,
              density_prior="rna_count_based", device="cpu", impl="fused",
              rounding="stochastic", **BF16)
    if mode == "clusters":
        kw["cluster_label"] = "subclass_label"
    if mode == "constrained":
        kw["target_count"] = 50
    ad_map = tgt.map_cells_to_space(sc_t, sp_t, **kw)
    X = np.asarray(ad_map.X)
    assert X.dtype == np.float32 and np.isfinite(X).all()
    np.testing.assert_allclose(X.sum(axis=1), 1.0, atol=1e-5)
    assert np.isfinite(ad_map.uns["train_genes_df"]["train_score"]).all()
    assert len(ad_map.uns["training_history"]["main_loss"]) == 12
    if mode == "constrained":
        F = ad_map.obs["F_out"].to_numpy()
        assert F.dtype == np.float32 and ((F > 0) & (F < 1)).all()


# The low-precision cases that ROADMAP queue A4 used to reject: on the CPU
# with impl="auto" both packages train on their generic loop, which stores
# f32 whatever the dtypes say and rejects stochastic rounding.
@pytest.mark.parametrize("kwargs,raises", [
    (dict(param_dtype="bfloat16"), None),
    (dict(moment_dtype="bfloat16"), None),
    (dict(rounding="stochastic"), "stochastic"),
    (dict(mode="constrained", target_count=10, param_dtype="bfloat16"), None),
    (dict(optimizer="adafactor", rounding="stochastic"), "stochastic"),
])
def test_low_precision_options_off_the_fused_path_match_jax(kwargs, raises):
    (sc_j, sp_j), (sc_t, sp_t) = pairs()
    kw = dict(num_epochs=2, random_state=7, verbose=False, **kwargs)
    if raises:
        for api, ads, extra in ((tg, (sc_j, sp_j), {}), (tgt, (sc_t, sp_t),
                                                         dict(device="cpu"))):
            with pytest.raises(ValueError, match=raises):
                api.map_cells_to_space(*ads, **kw, **extra)
        return
    map_j = tg.map_cells_to_space(sc_j, sp_j, **kw)
    map_t = tgt.map_cells_to_space(sc_t, sp_t, device="cpu", **kw)
    assert np.asarray(map_t.X).dtype == np.float32
    np.testing.assert_allclose(map_t.X, map_j.X, rtol=3e-3, atol=1e-7)
