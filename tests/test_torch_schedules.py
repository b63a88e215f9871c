"""Schedules, early stopping, init draws and checkpoints of the PyTorch port
against the JAX package's, on the CPU.

Tolerances. ``cosine_lr``/``resolve_lr`` are the same numpy arithmetic:
exact. A per-epoch lr vector against chained constant-lr runs with the
optimizer state carried is one arithmetic: bit for bit. The port against
JAX ``fit_mapping`` on the same vector takes the tolerances of
``tests/test_torch_mapper.py``: Adam losses rtol 3e-4 / atol 3e-5 and M
atol 3e-3 (f32 rounding amplified by Adam's normalized steps), Adafactor
losses and M rtol/atol 5e-3 (its update passes rounding on undamped).
Early stopping stops at JAX's epoch, and its history is a bit-exact
prefix of the unstopped run, as ``tests/test_lr_schedule.py:198-216``
holds JAX's. The on-device draw (``init_method="jax"``) cannot reproduce
JAX's ``PRNGKey`` bits: its mean and standard deviation are held within
1e-2 of N(0, 1) over 10⁶ draws (six standard errors are 6e-3), the same
seed repeats its bits and another seed does not. The expression init is
one f32 matmul of normalized rows: within 1e-6 of JAX's. A checkpointed
run stopped and resumed equals an unbroken one bit for bit.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu import checkpoint as jckpt
from tangram_tpu.models import mapper as jm
from tangram_tpu.ops import schedules as jsched
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu_torch import checkpoint as tckpt
from tangram_tpu_torch.convert import mapper_data_from_jax
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops import schedules as tsched
from tangram_tpu_torch.ops.losses import LossWeights


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fixtures are tiny: one intra-op thread keeps these tests from
    contending for every core with the suite's other workers (the loop
    path ran 8× slower with the default threads under such load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_problem(rng, c=24, s=40, g=8, target_count=None):
    S = (rng.poisson(2.0, (c, g)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.1).astype(np.float32)
    d = rng.random(s).astype(np.float32)
    d /= d.sum()
    jdata = JMapperData(S=jnp.asarray(S), G=jnp.asarray(G), d=jnp.asarray(d),
                        target_count=None if target_count is None
                        else jnp.float32(target_count))
    return S, G, jdata


# ---------------------------------------------------------------------------
# cosine_lr and resolve_lr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (1.0, 100, 0.1, 10), (0.5, 37, 0.0, 0), (0.3, 1, 0.0, 1), (2.0, 12, 0.5, 12),
])
def test_cosine_lr_matches_jax(args):
    peak, n, end, warmup = args
    got = tsched.cosine_lr(peak, n, end=end, warmup=warmup)
    want = jsched.cosine_lr(peak, n, end=end, warmup=warmup)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    t = np.arange(n, dtype=np.float64)
    np.testing.assert_array_equal(tsched.cosine_value(t, peak, end, n),
                                  jsched.cosine_value(t, peak, end, n))


@pytest.mark.parametrize("lr", [
    0.1, np.float32(0.05), [0.1] * 5, np.linspace(0.1, 0.5, 5),
    lambda t: 0.2 * (t + 1),             # vectorized callable
    lambda t: 0.1 if int(t) < 2 else 0.01,  # per-epoch callable
])
def test_resolve_lr_matches_jax(lr):
    got, want = tsched.resolve_lr(lr, 5), jsched.resolve_lr(lr, 5)
    if np.ndim(want) == 0:
        assert isinstance(got, float) and got == want
    else:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


def test_schedule_errors_match_jax():
    for api in (tsched, jsched):
        with pytest.raises(ValueError, match="learning_rate vector has shape"):
            api.resolve_lr([0.1] * 4, 5)
        with pytest.raises(ValueError, match="warmup must be within"):
            api.cosine_lr(1.0, 10, warmup=11)


# ---------------------------------------------------------------------------
# lr vectors on the three loops
# ---------------------------------------------------------------------------

LOOPS = {
    # name: (port fit_mapping options, JAX fit_mapping options, lambdas, constrained)
    "reference adam": (dict(impl="reference"), dict(impl="xla"),
                       dict(lambda_d=1.0, lambda_r=0.01), False),
    "fused adam": (dict(impl="fused"), dict(impl="pallas", fused=True),
                   dict(lambda_d=1.0, lambda_r=0.01), False),
    "fused adafactor": (dict(impl="fused", optimizer="adafactor"),
                        dict(impl="pallas", fused=True, optimizer="adafactor"),
                        dict(lambda_d=1.0, lambda_l1=1e-3, lambda_l2=1e-3), False),
    "autograd adam": (dict(impl="fused", fused=False), dict(impl="pallas", fused=False),
                      dict(lambda_d=1.0), False),
    "constrained fused adam": (dict(impl="fused"), dict(impl="pallas", fused=True),
                               dict(lambda_d=1.0, lambda_g2=1.0), True),
    "constrained adafactor": (dict(impl="fused", optimizer="adafactor"),
                              dict(impl="pallas", optimizer="adafactor"),
                              dict(lambda_d=1.0, lambda_g2=1.0), True),
}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_vector_lr_equals_chained_constant_runs(rng, loop):
    """A two-phase lr vector equals two constant runs chained with the
    optimizer state carried, bit for bit, and JAX's run on the same vector
    within the Adam or Adafactor tolerances."""
    port_kw, jax_kw, lam, constrained = LOOPS[loop]
    S, G, jdata = make_problem(rng, target_count=20.0 if constrained else None)
    data = mapper_data_from_jax(jdata)
    lw, jlw = LossWeights(**lam), JLossWeights(**lam)
    c, s = S.shape[0], G.shape[0]
    if constrained:
        start = [np.asarray(x) for x in jm.init_constrained_logits(c, s, 9, "numpy")]
    else:
        start = [np.asarray(jm.init_logits(c, s, 9, "numpy"))]

    def params():
        p = tuple(torch.from_numpy(x.copy()) for x in start)
        return p if constrained else p[0]

    lrs = np.asarray([0.1] * 6 + [0.02] * 6, np.float32)
    kw = dict(constrained=constrained, **port_kw)
    p_vec, h_vec = tm.fit_mapping(params(), data, lw, 12, lrs, **kw)
    p_a, state, h_a = tm.fit_mapping(params(), data, lw, 6, 0.1, return_opt_state=True,
                                     **kw)
    p_b, h_b = tm.fit_mapping(p_a, data, lw, 6, 0.02, opt_state=state, step_offset=6,
                              **kw)
    leaves = lambda p: p if constrained else (p,)  # noqa: E731
    for got, want in zip(leaves(p_vec), leaves(p_b)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(h_vec["total_loss"],
                               torch.cat([h_a["total_loss"], h_b["total_loss"]]),
                               rtol=0, atol=0)

    jstart = tuple(jnp.asarray(x) for x in start)
    p_j, h_j = jm.fit_mapping(jstart if constrained else jstart[0], jdata, jlw, 12, lrs,
                              constrained=constrained, **jax_kw)
    tol = 5e-3 if port_kw.get("optimizer") == "adafactor" else None
    np.testing.assert_allclose(h_vec["total_loss"].numpy(), np.asarray(h_j["total_loss"]),
                               rtol=tol or 3e-4, atol=tol or 3e-5)
    for got, want in zip(leaves(p_vec), leaves(p_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol or 3e-3,
                                   rtol=tol or 0)


def test_mapper_train_callable_schedule_in_chunks(rng):
    """A callable schedule through ``Mapper.train`` in print chunks of 7
    equals one unchunked run, and JAX's ``Mapper`` within the Adam
    tolerances; ``MapperConstrained.train`` slices its vector alike."""
    S, G, _ = make_problem(rng)

    def sched(t):
        return 0.05 + 0.1 * np.cos(np.asarray(t) / 10.0) ** 2

    kw = dict(lambda_d=0.0, random_state=5)
    _, h_chunks = tm.Mapper(S, G, device="cpu", impl="fused", **kw).train(
        20, learning_rate=sched, print_each=7)
    _, h_one = tm.Mapper(S, G, device="cpu", impl="fused", **kw).train(
        20, learning_rate=sched, print_each=None)
    _, h_j = jm.Mapper(S, G, impl="pallas", **kw).train(20, learning_rate=sched,
                                                         print_each=None)
    np.testing.assert_array_equal(h_chunks["total_loss"], h_one["total_loss"])
    np.testing.assert_allclose(h_one["total_loss"], h_j["total_loss"], rtol=3e-4,
                               atol=3e-5)

    lrs = tsched.cosine_lr(0.2, 15, end=0.01)
    ckw = dict(d=None, target_count=20, random_state=4)
    outs = [tm.MapperConstrained(S, G, device="cpu", impl="fused", **ckw).train(
        15, learning_rate=lrs, print_each=pe) for pe in (4, None)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------

def early_stop_problem(rng, c=20, s=12, g=8):
    S = (rng.poisson(2.0, (c, g)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.5).astype(np.float32)
    return S, G


@pytest.mark.parametrize("impl,jimpl,lr", [
    ("fused", "pallas", 0.1),
    ("reference", "xla", 0.1),
    ("fused", "pallas", "cosine"),
])
def test_early_stop_matches_jax(rng, impl, jimpl, lr):
    """The same stop epoch as JAX's ``Mapper.train``, a history that is a
    bit-exact prefix of the unstopped run, and the val lists kept every
    ``val_each`` epochs across windows."""
    S, G = early_stop_problem(rng)
    lr = tsched.cosine_lr(0.5, 1500, end=0.01) if lr == "cosine" else lr
    stop = dict(early_stop_tol=1e-4, early_stop_window=50)
    _, hist = tm.Mapper(S, G, device="cpu", impl=impl, random_state=3).train(
        1500, learning_rate=lr, print_each=None, val_each=7, **stop)
    _, hist_j = jm.Mapper(S, G, impl=jimpl, random_state=3).train(
        1500, learning_rate=lr, print_each=None, val_each=7, **stop)
    n_run = len(hist["main_loss"])
    assert 0 < n_run < 1500 and n_run % 50 == 0
    assert n_run == len(hist_j["main_loss"])
    np.testing.assert_allclose(hist["main_loss"], hist_j["main_loss"], rtol=3e-4,
                               atol=3e-5)
    assert len(hist["val_gene_sim"]) == len(range(0, n_run, 7))
    # stopped because a window improved the best score by less than tol
    assert max(hist["main_loss"][-50:]) - max(hist["main_loss"][:-50]) < 1e-4

    lr_prefix = lr if np.ndim(lr) == 0 else lr[:n_run]
    _, full = tm.Mapper(S, G, device="cpu", impl=impl, random_state=3).train(
        n_run, learning_rate=lr_prefix, print_each=50, val_each=7)
    for key in ("main_loss", "total_loss", "val_gene_sim"):
        np.testing.assert_array_equal(hist[key], full[key])


def test_early_stop_edges(rng):
    """A non-finite score stops after the first window; an improving run
    takes its whole budget; a window ≤ 0 raises. (Constrained mode's
    refusal, with JAX's message: ``tests/test_torch_mapping.py::
    test_mapping_argument_errors_match_jax``.)"""
    S, G = early_stop_problem(rng)
    S_nan = S.copy()
    S_nan[0, 0] = np.nan
    with np.errstate(invalid="ignore"):
        _, hist = tm.Mapper(S_nan, G, device="cpu", random_state=3).train(
            500, print_each=None, early_stop_tol=1e-4, early_stop_window=50)
    assert len(hist["main_loss"]) == 50 and not np.isfinite(hist["main_loss"][-1])
    _, hist = tm.Mapper(S, G, device="cpu", random_state=3).train(
        60, print_each=None, early_stop_tol=1e-12, early_stop_window=30)
    assert len(hist["main_loss"]) == 60
    with pytest.raises(ValueError, match="early_stop_window must be positive"):
        tm.Mapper(S, G, device="cpu").train(10, early_stop_tol=1e-3,
                                            early_stop_window=0)


# ---------------------------------------------------------------------------
# init draws
# ---------------------------------------------------------------------------

def test_device_draw_moments_and_determinism():
    M = tm.init_logits(1000, 1000, 7, method="jax")
    assert M.dtype == torch.float32 and M.shape == (1000, 1000)
    assert abs(float(M.mean())) < 1e-2 and abs(float(M.std()) - 1.0) < 1e-2
    torch.testing.assert_close(tm.init_logits(1000, 1000, 7, method="jax"), M,
                               rtol=0, atol=0)
    assert not torch.equal(tm.init_logits(1000, 1000, 8, method="jax"), M)
    # None seeds like JAX's PRNGKey(0)
    torch.testing.assert_close(tm.init_logits(30, 40, None, method="jax"),
                               tm.init_logits(30, 40, 0, method="jax"), rtol=0, atol=0)
    # constrained: M, then F, from one generator
    M_c, F_c = tm.init_constrained_logits(30, 40, 7, method="jax")
    gen = torch.Generator().manual_seed(7)
    torch.testing.assert_close(M_c, torch.randn((30, 40), generator=gen), rtol=0, atol=0)
    torch.testing.assert_close(F_c, torch.randn((30,), generator=gen), rtol=0, atol=0)
    assert tm.init_logits(3, 4, 1, method="jax", dtype=torch.bfloat16).dtype == \
        torch.bfloat16


def test_auto_draws_on_device_above_threshold(monkeypatch):
    """``"auto"`` takes the numpy stream below DEVICE_DRAW_ENTRIES and the
    device draw at and above it, as JAX's 2^30 switch (threshold
    monkeypatched, nothing large allocated)."""
    assert tm.DEVICE_DRAW_ENTRIES == 1 << 30
    monkeypatch.setattr(tm, "DEVICE_DRAW_ENTRIES", 12 * 20)
    np.testing.assert_array_equal(tm.init_logits(11, 20, 5, "auto").numpy(),
                                  np.asarray(jm.init_logits(11, 20, 5, "numpy")))
    torch.testing.assert_close(tm.init_logits(12, 20, 5, "auto"),
                               tm.init_logits(12, 20, 5, "jax"), rtol=0, atol=0)
    for got, want in zip(tm.init_constrained_logits(12, 20, 5, "auto"),
                         tm.init_constrained_logits(12, 20, 5, "jax")):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    mapper = tm.Mapper(np.ones((12, 3), np.float32), np.ones((20, 3), np.float32),
                       device="cpu", random_state=5)
    torch.testing.assert_close(mapper.M, tm.init_logits(12, 20, 5, "jax"), rtol=0, atol=0)


def test_expression_init_matches_jax(rng):
    S = (rng.poisson(2.0, (30, 9)) + 0.1).astype(np.float32)
    G = (rng.poisson(3.0, (25, 9))).astype(np.float32)
    G[3] = 0.0  # an all-zero spot: the 1e-8 clamp
    np.testing.assert_allclose(
        tm.expression_init_logits(torch.from_numpy(S), torch.from_numpy(G)).numpy(),
        np.asarray(jm.expression_init_logits(S, G)), atol=1e-6, rtol=1e-6)
    kw = dict(train_genes_idx=[0, 2, 4, 6, 8], init_method="expression")
    np.testing.assert_allclose(tm.Mapper(S, G, device="cpu", **kw).M.numpy(),
                               np.asarray(jm.Mapper(S, G, **kw).M), atol=1e-6, rtol=1e-6)


def test_init_signatures_match_jax():
    """init_logits takes JAX's parameters in JAX's order, with JAX's
    defaults (dtypes compared by name); ``device`` is the port's own last."""
    got = inspect.signature(tm.init_logits).parameters
    want = inspect.signature(jm.init_logits).parameters
    assert list(got)[:len(want)] == list(want) and list(got)[len(want):] == ["device"]
    for name, p in want.items():
        d_got, d_want = got[name].default, p.default
        if name == "dtype":
            d_got, d_want = tm._dtype_name(d_got), np.dtype(d_want).name
        assert d_got == d_want, name


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

CKPT_CASES = {
    "adam": (False, 0.1),
    "constrained": (True, 0.1),
    "schedule": (False, "cosine"),
}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_checkpoint_resume_is_bit_exact(rng, tmp_path, case):
    """30 epochs in chunks of 10, stopped after 20 and resumed, equal an
    unbroken checkpointed run and one fit_mapping run bit for bit (M, F,
    the Adam moments' step count and the cumulative history), and JAX's
    run of those 30 epochs within the Adam tolerances."""
    constrained, lr = CKPT_CASES[case]
    S, G, jdata = make_problem(rng, target_count=20.0 if constrained else None)
    data = mapper_data_from_jax(jdata)
    lam = dict(lambda_d=1.0)
    lw, jlw = LossWeights(**lam), JLossWeights(**lam)
    lr = tsched.cosine_lr(0.3, 30, end=0.01) if lr == "cosine" else lr
    c, s = S.shape[0], G.shape[0]
    start = ([np.asarray(x) for x in jm.init_constrained_logits(c, s, 9, "numpy")]
             if constrained else [np.asarray(jm.init_logits(c, s, 9, "numpy"))])

    def params():
        p = tuple(torch.from_numpy(x.copy()) for x in start)
        return p if constrained else p[0]

    kw = dict(checkpoint_every=10, constrained=constrained, impl="fused")
    p_whole, h_whole = tckpt.train_checkpointed(params(), data, lw, 30, lr,
                                                tmp_path / "whole", **kw)
    # a run stopped at epoch 20 (its 20-epoch budget), then resumed to 30
    lr20 = lr if np.ndim(lr) == 0 else lr[:20]
    tckpt.train_checkpointed(params(), data, lw, 20, lr20, tmp_path / "cut", **kw)
    assert tckpt.latest_epoch(tmp_path / "cut") == 20
    p_res, h_res = tckpt.train_checkpointed(params(), data, lw, 30, lr,
                                            tmp_path / "cut", **kw)
    leaves = lambda p: p if constrained else (p,)  # noqa: E731
    for got, want in zip(leaves(p_res), leaves(p_whole)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(h_res) == set(h_whole)
    for key in h_whole:
        assert len(h_res[key]) == 30
        np.testing.assert_array_equal(h_res[key], h_whole[key])
    epoch, _, state, hist = tckpt.restore(tmp_path / "cut")
    assert epoch == 30 and state[0] == 30 and len(hist["total_loss"]) == 30
    epoch, _, placed, _ = tckpt.restore(tmp_path / "cut", 20, opt_state_template=state)
    assert epoch == 20 and placed[0] == 20
    assert [type(x) for x in placed] == [type(x) for x in state]

    p_one, _ = tm.fit_mapping(params(), data, lw, 30, lr, constrained=constrained,
                              impl="fused")
    for got, want in zip(leaves(p_whole), leaves(p_one)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    # JAX's train_checkpointed equals its one-call fit_mapping (its own
    # tests/test_checkpoint_and_extras.py), which is cheaper to run here
    jstart = tuple(jnp.asarray(x) for x in start)
    p_j, h_j = jm.fit_mapping(jstart if constrained else jstart[0], jdata, jlw, 30, lr,
                              constrained=constrained, impl="pallas")
    np.testing.assert_allclose(h_whole["total_loss"], np.asarray(h_j["total_loss"]),
                               rtol=3e-4, atol=3e-5)
    for got, want in zip(leaves(p_whole), leaves(p_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-3)


def test_restore_errors_and_signatures(tmp_path):
    for api in (tckpt, jckpt):
        with pytest.raises(FileNotFoundError):
            api.restore(tmp_path / "none")
        assert api.latest_epoch(tmp_path / "none") is None
    for name in ("save", "restore", "latest_epoch", "train_checkpointed"):
        got = inspect.signature(getattr(tckpt, name)).parameters
        want = inspect.signature(getattr(jckpt, name)).parameters
        assert list(got) == list(want), name
        assert [p.default for p in got.values()] == [p.default for p in want.values()]
    with pytest.raises(TypeError, match="DeviceMesh"):
        tckpt.train_checkpointed(torch.zeros(2, 3), None, LossWeights(), 1, 0.1,
                                 tmp_path, mesh=object())


def test_map_cells_to_space_schedule_early_stop_and_init_match_jax(rng):
    """The AnnData entry point passes a schedule, early stopping and
    ``init_method`` through, as JAX's does."""
    import pandas as pd

    c, s, g = 40, 30, 10
    S = (rng.poisson(2.0, (c, g)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (s, g)) + 0.5).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(g)])

    def adatas(api):
        sc = api.AnnData(X=S.copy(), var=genes.copy())
        sp = api.AnnData(X=G.copy(), var=genes.copy())
        api.pp_adatas(sc, sp)
        return sc, sp

    kw = dict(num_epochs=600, learning_rate=tsched.cosine_lr(0.3, 600, end=0.01),
              random_state=2, verbose=False, early_stop_tol=1e-4, early_stop_window=40,
              density_prior="uniform", init_method="expression")
    ad_t = tgt.map_cells_to_space(*adatas(tgt), device="cpu", impl="fused", **kw)
    ad_j = tg.map_cells_to_space(*adatas(tg), impl="pallas", **kw)
    h_t, h_j = ad_t.uns["training_history"], ad_j.uns["training_history"]
    assert len(h_t["main_loss"]) == len(h_j["main_loss"]) < 600
    np.testing.assert_allclose(h_t["main_loss"], h_j["main_loss"], rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(np.asarray(ad_t.X), np.asarray(ad_j.X), rtol=3e-3,
                               atol=1e-6)
