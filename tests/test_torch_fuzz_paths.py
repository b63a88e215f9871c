"""The port's path fuzzer (``tangram_tpu_torch/scripts/fuzz_paths.py``)
against ``scripts/fuzz_paths.py``, on the CPU.

* The port draws the JAX tool's trials: for seeds 0-2, the JAX tool's
  ``run(seed, 3)`` with its two fits replaced by recorders hands them
  exactly the arrays, weights, epochs, learning rates, meshes and chunk
  cuts that :func:`draw_trial` draws (``np.array_equal``).
* On those trials the port's reference loop and fused loop (the kernels'
  plain twins on the CPU) match the JAX package's XLA loop at
  ``tests/test_torch_mapper.py``'s tolerances: loss rtol 3e-4 / atol
  3e-5, logits atol 3e-3.
* A planted fault (the fused Adam twin without its L2 term) makes ``run``
  report failures on a seed whose trials carry lambda_l2 > 0, and the same
  run without the fault reports none.
* The sharded pairs pass on 4 gloo ranks over 1-D ("cell",) = 4 and 2-D
  ("cell", "spot") = 2 x 2 meshes (``tests/_parallel_worker.py``, suite
  ``"fuzz_paths"``); without a process group the tool says it skipped them.
* The command line exits 0 with ``--device cpu`` and raises without it on
  a host with no GPU.
* The tool's two rules of f32 scale (``LOSS_ULPS``, ``KINK_SHARE``) admit
  nothing at the JAX tool's ranges, and past them only near-zero logits in
  the stated share.
"""

import dataclasses
import importlib.util
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _parallel_worker as pw
from tangram_tpu.models import mapper as jm
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu_torch.ops import fused_step as tfs
from tangram_tpu_torch.scripts import fuzz_paths as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS, TRIALS = (0, 1, 2), 3
#: a seed whose trials carry lambda_l2 > 0 (trials 0 and 3) and draw both
#: meshes, constrained and not, a learning-rate vector and chunk cuts
PLANTED_SEED, PLANTED_TRIALS = 0, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_paths", os.path.join(REPO, "scripts", "fuzz_paths.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recorded_calls(monkeypatch, seed):
    """The JAX tool's ``run(seed, TRIALS)`` with its fits recorded, not run:
    (fit_mapping calls, fit_mapping_fused_sharded calls), each a dict of the
    arguments as numpy values."""
    tool = load_jax_tool()
    fits, sharded = [], []

    def arrays(params):
        return [np.asarray(leaf) for leaf in jax.tree.leaves(params)]

    def data_fields(data):
        return {k: None if getattr(data, k) is None else np.asarray(getattr(data, k))
                for k in ("S", "G", "d", "gene_mask", "target_count")}

    def fit_mapping(params, data, lw, epochs, lr, impl, constrained, fused=False):
        fits.append(dict(params=arrays(params), lw=lw, epochs=epochs, lr=lr, impl=impl,
                         constrained=constrained, **data_fields(data)))
        return params, {"total_loss": np.zeros(epochs, np.float32)}

    def fit_mapping_fused_sharded(params, data, lw, epochs, lr, mesh, opt_state=None,
                                  return_opt_state=False, step_offset=0):
        sharded.append(dict(params=arrays(params), epochs=epochs, lr=lr,
                            axes=tuple(mesh.axis_names), step_offset=step_offset,
                            chunked=return_opt_state, **data_fields(data)))
        hist = {"total_loss": np.zeros(epochs, np.float32)}
        return (params, None, hist) if return_opt_state else (params, hist)

    monkeypatch.setattr(tool, "fit_mapping", fit_mapping)
    monkeypatch.setattr(tool, "fit_mapping_fused_sharded", fit_mapping_fused_sharded)
    assert tool.run(seed, TRIALS) == 0
    return fits, sharded


def port_trials(seed, n=TRIALS):
    rng = np.random.default_rng(seed)
    return [fp.draw_trial(rng) for _ in range(n)]


def same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_port_draws_jax_trials(monkeypatch, seed):
    fits, sharded = recorded_calls(monkeypatch, seed)
    trials = port_trials(seed)
    assert [f["impl"] for f in fits] == ["xla", "pallas"] * TRIALS
    calls = iter(sharded)
    for i, t in enumerate(trials):
        start = [t.M0, t.F0] if t.constrained else [t.M0]
        d = t.d if (t.constrained or t.lw.lambda_d) else None
        target = None if t.target_count is None else np.float32(t.target_count)
        for f in fits[2 * i:2 * i + 2]:
            assert f["constrained"] == t.constrained and f["epochs"] == t.epochs
            assert len(f["params"]) == len(start)
            assert all(np.array_equal(a, b) for a, b in zip(f["params"], start))
            for key, want in (("S", t.S), ("G", t.G), ("d", d), ("gene_mask", t.gene_mask),
                              ("target_count", target), ("lr", t.lr)):
                assert same(f[key], want), (i, key)
            assert dataclasses.asdict(f["lw"]) == dataclasses.asdict(t.lw)
        axes = {"1d": ("cell",), "2d": ("cell", "spot")}[t.mesh]
        whole = next(calls)
        assert not whole["chunked"] and whole["axes"] == axes
        assert whole["epochs"] == t.epochs and same(whole["lr"], t.lr)
        assert all(np.array_equal(a, b) for a, b in zip(whole["params"], start))
        bounds = [0, *t.cuts.tolist(), t.epochs]
        for lo, hi in zip(bounds, bounds[1:]):
            chunk = next(calls)
            assert chunk["chunked"] and chunk["axes"] == axes
            assert (chunk["step_offset"], chunk["epochs"]) == (lo, hi - lo)
            assert same(chunk["lr"], t.lr[lo:hi] if np.ndim(t.lr) else t.lr)
    assert next(calls, None) is None


def jax_fit(t):
    data = JMapperData(
        S=jnp.asarray(t.S), G=jnp.asarray(t.G),
        d=jnp.asarray(t.d) if (t.constrained or t.lw.lambda_d) else None,
        gene_mask=None if t.gene_mask is None else jnp.asarray(t.gene_mask),
        target_count=None if t.target_count is None else jnp.float32(t.target_count))
    params = (jnp.asarray(t.M0), jnp.asarray(t.F0)) if t.constrained else jnp.asarray(t.M0)
    lw = JLossWeights(**dataclasses.asdict(t.lw))
    out, hist = jm.fit_mapping(params, data, lw, t.epochs, t.lr, impl="xla",
                               constrained=t.constrained)
    leaves = [np.asarray(x) for x in jax.tree.leaves(out)]
    return leaves, np.asarray(hist["total_loss"])


@pytest.mark.parametrize("seed", SEEDS)
def test_port_loops_match_jax_xla_loop(seed):
    cpu = torch.device("cpu")
    for t in port_trials(seed):
        want, want_loss = jax_fit(t)
        for impl in ("reference", "fused"):
            out, hist = fp.fit_mapping(fp._start(t, cpu), fp._data(t, cpu), t.lw, t.epochs,
                                       t.lr, impl=impl, constrained=t.constrained)
            np.testing.assert_allclose(fp._losses(hist), want_loss, rtol=3e-4, atol=3e-5,
                                       err_msg=f"{impl} c={t.c} s={t.s}")
            for got, ref in zip(fp._leaves(out), want):
                np.testing.assert_allclose(got, ref, atol=3e-3,
                                           err_msg=f"{impl} c={t.c} s={t.s}")


def test_planted_fault_is_caught(monkeypatch, capsys):
    assert any(t.lw.lambda_l2 > 0 for t in port_trials(PLANTED_SEED, PLANTED_TRIALS))
    assert fp.run(PLANTED_SEED, PLANTED_TRIALS, device="cpu") == 0
    original = tfs._dm_adam_plain
    signature = inspect.signature(original)

    def without_l2(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.arguments["lam_l2"] = 0.0
        return original(*bound.args, **bound.kwargs)

    monkeypatch.setattr(tfs, "_dm_adam_plain", without_l2)
    capsys.readouterr()
    assert fp.run(PLANTED_SEED, PLANTED_TRIALS, device="cpu") > 0
    out = capsys.readouterr().out
    assert "fused-vs-reference" in out
    assert f"{PLANTED_TRIALS} trials, 0 failures" not in out


def test_sharded_pairs_on_gloo_ranks(tmp_path):
    ranks = pw.run(str(tmp_path), suite="fuzz_paths")
    trials = port_trials(pw.FUZZ_SEED, pw.FUZZ_TRIALS)
    assert {t.mesh for t in trials} == {"1d", "2d"}
    assert {t.constrained for t in trials} == {True, False}
    for rank, results in enumerate(ranks):
        assert "error" not in results["fuzz"], results["fuzz"].get("error")
        assert results["fuzz"]["fails"] == 0
        assert results["fuzz"]["meshes"] == {"1d": {"cell": 4}, "2d": {"cell": 2, "spot": 2}}
        # rank 0 prints, the others stay silent
        assert results["fuzz"]["lines"] == (
            [f"{pw.FUZZ_TRIALS} trials, 0 failures"] if rank == 0 else [])


def test_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    module = "tangram_tpu_torch.scripts.fuzz_paths"
    proc = subprocess.run([sys.executable, "-m", module, "0", "3", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("sharded pairs skipped")
    assert lines[-1] == "3 trials, 0 failures"
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", module, "0", "1"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def test_scale_rules_are_void_at_jax_ranges():
    """The two rules of f32 scale admit nothing the JAX tool's bounds refuse
    at its ranges: at most 69 x 49 logits leave no kink to admit, and a loss
    below 4,096 keeps the bound at 1e-3; past them they admit only what
    they state."""
    most = (fp.C_RANGE[1] - 1) * (fp.S_RANGE[1] - 1)
    assert int(fp.KINK_SHARE * most) == 0
    assert fp.loss_tol(np.array([-4095.0, 10.0], np.float32)) == 1e-3
    assert fp.loss_tol(np.array([2.05e4], np.float32)) == 4 * float(np.spacing(np.float32(2.05e4)))
    b = np.linspace(-2.0, 2.0, 200_001).astype(np.float32)
    near = np.abs(b) < 0.1
    a = b.copy()
    a[np.flatnonzero(near)[:2]] += 0.5  # two logits near 0 apart: admitted
    assert fp.kinks(a, b, 0.01, 0.3) == (2, 2)
    a[np.flatnonzero(near)[2]] += 0.5  # a third: more than 1e-5 of the logits
    assert fp.kinks(a, b, 0.01, 0.3) == (0, 2)
    a = b.copy()
    a[0] += 0.5  # one logit far from 0
    assert fp.kinks(a, b, 0.01, 0.3) == (0, 2)
    for t in (trial for seed in SEEDS for trial in port_trials(seed)):
        assert t.c * t.s <= most
