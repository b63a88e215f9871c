"""The port's optimizer factories against the JAX package's optax ones.

``tangram_tpu_torch.models.mapper.make_adam`` / ``make_adafactor`` /
``make_optimizer`` (``ops/optim.py``) are held to
``tangram_tpu.models.mapper``'s on the same numpy-seeded parameters and
gradients, step by step. Tolerances, each for its reason:

* f32: within ``F32_ULPS`` f32 ulps of max(|p|, 1). optax scales the
  normalized update by −lr after the division and adds it; the port
  subtracts lr·m̂/(√v̂ + ε) (JAX's fused steps' order), and Adafactor's
  means sum in another order, so a step may round an entry 1 ulp apart and
  the next step carries that on (measured: at most 2 ulps over 5 steps).
* bf16 Adam: bit for bit. Both run optax's update op by op in bf16 with the
  same constants rounded to bf16 (``tests/test_torch_bf16.py`` measured 0
  ulps on the autograd loop).
* bf16 Adafactor: step 1 within 1 bf16 ulp of max(|p|, 1), as
  ``tests/test_torch_bf16.py`` holds it (the row and column means of g²
  are summed in f32 in another order before they are stored in bf16), and
  later steps within 2: a 1-ulp difference carried into the next step can
  round once more (measured: 2 ulps at the third step).
* the carried moments and statistics: rtol 1e-5 in f32 (their sums in
  another order), 1 bf16 ulp (2^-7 relative) in bf16.

``init`` makes the carry the port's loops, checkpoints and ``convert``
use; a fit started from it stores the bits of one started from
``opt_state=None``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from tangram_tpu.models import mapper as jm
from tangram_tpu_torch import checkpoint
from tangram_tpu_torch.convert import (
    adafactor_state_from_jax,
    constrained_adafactor_state_from_jax,
)
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import optim
from tangram_tpu_torch.ops.losses import LossWeights, MapperData

F32_ULPS = 4
LR = 0.1


def _ulps_apart(got, want, dtype):
    """|got − want| in ulps of max(|want|, 1) in ``dtype``."""
    want = np.asarray(want, dtype=np.float64)
    mantissa = 7 if dtype == torch.bfloat16 else 23
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - mantissa)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / ulp))


def _jax(x, dtype):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dtype == torch.bfloat16 else a


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def run_both(name, shapes, dtype, steps, seed):
    """``steps`` updates of the JAX package's and the port's ``name``
    optimizer on parameters of ``shapes`` (one shape: M alone; two: the
    constrained pair) from the same numpy draws; yields both parameter
    tuples after each step, and both states after the last."""
    rng = np.random.default_rng(seed)
    P0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    pair = len(shapes) > 1
    p_j = tuple(_jax(p, dtype) for p in P0)
    p_t = tuple(torch.from_numpy(p).to(dtype) for p in P0)
    opt_j = jm.make_optimizer(name, LR)
    opt_t = tm.make_adam(LR) if name == "adam" else tm.make_adafactor(LR)
    s_j = opt_j.init(p_j if pair else p_j[0])
    s_t = opt_t.init(p_t if pair else p_t[0])
    for _ in range(steps):
        G = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
        g_j = tuple(_jax(g, dtype) for g in G)
        u, s_j = opt_j.update(g_j if pair else g_j[0], s_j, p_j if pair else p_j[0])
        p_j = optax.apply_updates(p_j, u if pair else (u,))
        g_t = tuple(torch.from_numpy(g).to(dtype) for g in G)
        s_new = opt_t.update(g_t if pair else g_t[0], s_t, p_t if pair else p_t[0])
        assert s_new[0] == s_t[0] + 1
        s_t = s_new
        yield p_j, p_t, s_j, s_t


@pytest.mark.parametrize("shapes", [[(13, 21)], [(13, 21), (13,)]], ids=["M", "M,F"])
def test_make_adam_f32_matches_optax(shapes):
    """Five f32 Adam steps on (c, s), alone and as the constrained pair."""
    for p_j, p_t, s_j, s_t in run_both("adam", shapes, torch.float32, 5, seed=1):
        for a, b in zip(p_j, p_t):
            assert b.dtype == torch.float32
            assert _ulps_apart(b.numpy(), _numpy(a), torch.float32) <= F32_ULPS
    pair = len(shapes) > 1
    moments = (s_t[1], s_t[2]) if pair else ((s_t[1],), (s_t[2],))
    wanted = (s_j[0].mu, s_j[0].nu) if pair else ((s_j[0].mu,), (s_j[0].nu,))
    for got, want in zip(moments, wanted):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _numpy(w), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("shapes", [[(13, 21)], [(13, 21), (13,)]], ids=["M", "M,F"])
def test_make_adam_bf16_matches_optax_bit_for_bit(shapes):
    """Five Adam steps on bf16 parameters against optax on bf16 ones:
    parameters and moments bf16 and equal bit for bit."""
    for p_j, p_t, s_j, s_t in run_both("adam", shapes, torch.bfloat16, 5, seed=2):
        for a, b in zip(p_j, p_t):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.float().numpy(), _numpy(a))
    pair = len(shapes) > 1
    moments = (s_t[1], s_t[2]) if pair else ((s_t[1],), (s_t[2],))
    wanted = (s_j[0].mu, s_j[0].nu) if pair else ((s_j[0].mu,), (s_j[0].nu,))
    for got, want in zip(moments, wanted):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), _numpy(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shapes", [[(13, 21)], [(21, 13)], [(13, 21), (13,)],
                                    [(21, 13), (21,)]],
                         ids=["s>=c", "s<c", "s>=c,F", "s<c,F"])
def test_make_adafactor_matches_optax(shapes, dtype):
    """Three Adafactor steps: M factored in both orientations (the
    statistic on the smaller axis divided by its mean), and the 1-D F of
    the constrained pair unfactored; the carried statistics are optax's,
    as ``convert`` maps them."""
    for step, (p_j, p_t, s_j, s_t) in enumerate(run_both("adafactor", shapes, dtype, 3,
                                                         seed=3)):
        tol = F32_ULPS if dtype == torch.float32 else min(step + 1, 2)
        for a, b in zip(p_j, p_t):
            assert b.dtype == dtype
            assert _ulps_apart(b.float().numpy(), _numpy(a), dtype) <= tol
    c, s = shapes[0]
    fs = s_j[0]
    if len(shapes) > 1:
        want = constrained_adafactor_state_from_jax(fs.count, fs.v_row, fs.v_col, fs.v, c, s)
    else:
        want = adafactor_state_from_jax(fs.count, fs.v_row, fs.v_col, c, s)
    assert len(s_t) == len(want) and s_t[0] == want[0] == 3
    for got, w in zip(s_t[1:], want[1:]):
        assert got.dtype == w.dtype and got.shape == w.shape
        rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(got.float().numpy(), w.float().numpy(), rtol=rtol)


@pytest.mark.parametrize("name", ["adam", "adafactor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pair", [False, True], ids=["M", "M,F"])
def test_init_is_the_carry_of_optax_init(name, dtype, pair):
    """``init`` gives the port's carry: Adam ``(0, mu, nu)`` (pairs for
    (M, F)), Adafactor ``(0, vr (c,), vc (s,)[, vF (c,)])``, zeros in each
    parameter's type, shaped as ``convert`` maps optax's ``init``."""
    c, s = 7, 11
    M = torch.ones((c, s), dtype=dtype)
    F = torch.ones((c,))
    params = (M, F) if pair else M
    state = tm.make_adam(LR).init(params) if name == "adam" else \
        tm.make_adafactor(LR).init(params)
    assert state[0] == 0 and isinstance(state[0], int)
    if name == "adam":
        for moment in state[1:]:
            leaves = moment if pair else (moment,)
            assert isinstance(moment, tuple) == pair
            for m, p in zip(leaves, (M, F)):
                assert m.dtype == p.dtype and m.shape == p.shape and not m.any()
        return
    fs = jm.make_adafactor(LR).init((jnp.ones((c, s)), jnp.ones((c,))) if pair
                                    else jnp.ones((c, s)))[0]
    want = (constrained_adafactor_state_from_jax(fs.count, fs.v_row, fs.v_col, fs.v, c, s)
            if pair else adafactor_state_from_jax(fs.count, fs.v_row, fs.v_col, c, s))
    assert len(state) == len(want)
    for got, w, p in zip(state[1:], want[1:], (M, M, F)):
        assert got.shape == w.shape and got.dtype == p.dtype and not got.any()


def test_make_optimizer_resolves_names_as_jax():
    assert isinstance(tm.make_optimizer("adam", LR), optim.Adam)
    assert isinstance(tm.make_optimizer("adafactor", LR), optim.Adafactor)
    with pytest.raises(ValueError) as want:
        jm.make_optimizer("bogus", LR)
    with pytest.raises(ValueError) as got:
        tm.make_optimizer("bogus", LR)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="bogus"):
        tm.Mapper(np.ones((3, 4), np.float32), np.ones((5, 4), np.float32),
                  device="cpu", optimizer="bogus")


def _problem(c=12, s=20, g=9, seed=0, constrained=False):
    rng = np.random.default_rng(seed)
    data = MapperData(
        S=torch.from_numpy(rng.gamma(1.0, 1.0, (c, g)).astype(np.float32)),
        G=torch.from_numpy(rng.gamma(1.0, 1.0, (s, g)).astype(np.float32)),
        d=torch.from_numpy(rng.dirichlet(np.ones(s)).astype(np.float32)),
        target_count=torch.tensor(float(s)) if constrained else None)
    M = torch.from_numpy(rng.normal(0, 1, (c, s)).astype(np.float32))
    F = torch.from_numpy(rng.normal(0, 1, c).astype(np.float32))
    return ((M, F) if constrained else M), data


def _clone(params):
    return tuple(p.clone() for p in params) if isinstance(params, tuple) else params.clone()


def _bits(x):
    """A tensor's bits, so that equal NaNs compare equal."""
    return x.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    return [torch.tensor(tree)]


def test_restore_places_the_state_by_an_init_template(tmp_path):
    """``checkpoint.restore(opt_state_template=make_adam(lr).init(params))``
    gives back the saved carry, each tensor on its template's device, and
    training resumed from it stores the bits of training on unbroken."""
    params, data = _problem(constrained=True)
    lw = LossWeights(lambda_d=1.0, lambda_r=0.01)
    p, st, _ = tm.fit_mapping(_clone(params), data, lw, 3, LR, fused=False,
                              constrained=True, return_opt_state=True)
    checkpoint.save(tmp_path, 3, p, st)
    template = tm.make_adam(LR).init(params)
    epoch, p2, st2, _ = checkpoint.restore(tmp_path, opt_state_template=template)
    assert epoch == 3 and st2[0] == st[0] == 3
    for got, want, t in zip(_flat(st2)[1:], _flat(st)[1:], _flat(template)[1:]):
        assert got.device == t.device and torch.equal(got, want)
    a, _ = tm.fit_mapping(tuple(p2), data, lw, 2, LR, fused=False, constrained=True,
                          opt_state=st2)
    b, _ = tm.fit_mapping(p, data, lw, 2, LR, fused=False, constrained=True, opt_state=st)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
@pytest.mark.parametrize("constrained", [False, True], ids=["cells", "constrained"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fit_from_an_init_state_stores_the_bits_of_a_fresh_one(optimizer, constrained,
                                                               dtype):
    """``fit_mapping(fused=False)`` from ``make_optimizer(...).init(params)``
    and from ``opt_state=None``: the same parameters and carry, bit for
    bit."""
    params, data = _problem(constrained=constrained, seed=4)
    params = ((params[0].to(dtype), params[1]) if constrained else params.to(dtype))
    lw = LossWeights(lambda_d=1.0, lambda_g2=0.5, lambda_r=0.01)
    kw = dict(fused=False, optimizer=optimizer, constrained=constrained,
              return_opt_state=True)
    state0 = tm.make_optimizer(optimizer, LR).init(params)
    a, sa, ha = tm.fit_mapping(_clone(params), data, lw, 4, LR, opt_state=state0, **kw)
    b, sb, hb = tm.fit_mapping(_clone(params), data, lw, 4, LR, opt_state=None, **kw)
    for x, y in zip(_flat(a) + _flat(sa), _flat(b) + _flat(sb)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for k in ha:  # the terms a run does not weigh are NaN in both
        assert torch.equal(_bits(ha[k]), _bits(hb[k])), k
