"""The port's tuner fuzzer (``tangram_tpu_torch/scripts/fuzz_tuner.py``)
against ``scripts/fuzz_tuner.py``, on the CPU.

* The port draws the JAX tool's trials: for seeds 0-2, both tools'
  ``run(seed, 3)`` with the tuner replaced by a recorder (and the port
  handed stand-in meshes, so that it takes its mesh branch where the JAX
  tool does) make the same calls in the same order: the same pair (the
  expression, the labels, the spot coordinates), the same arguments and
  search space, the same mesh kind and the same forced-down budget.
* On the first two trials of seed 0 the port's frames match the JAX
  package's at ``tests/test_torch_tuning.py``'s tolerance: the sampled
  configs identical, every metric within 2e-5 (the port's pair given JAX's
  spot graph, since the two neighbor searches may break ties apart).
* A planted fault in the restart path (restarted halving rungs train one
  epoch short) makes ``run`` report the halving trial as failed.
* The trial-mesh branch passes on 4 gloo ranks over ("trial",) = 4 and
  ("trial", "cell") = 2 x 2 (``tests/_parallel_worker.py``, suite
  ``"fuzz_tuner"``).
* The command line exits 0 for seed 0, 3 trials, with ``--device cpu``.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import tangram_tpu
import tangram_tpu.utils
from tangram_tpu import tuning as jt
import _parallel_worker as pw
import tangram_tpu_torch.utils
from tangram_tpu_torch import tuning as tt
from tangram_tpu_torch.scripts import fuzz_tuner as ft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS, TRIALS = (0, 1, 2), 3
METRIC_ATOL = 2e-5  # tests/test_torch_tuning.py
#: seed 0's first two trials (adaptive) for the frames against JAX; its
#: third is a halving trial, the planted fault's
FRAME_SEED, FRAME_TRIALS = 0, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_tuner", os.path.join(REPO, "scripts", "fuzz_tuner.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def domain(value):
    if dataclasses.is_dataclass(value):
        return type(value).__name__, dataclasses.asdict(value)
    return value


class Result:
    """What a recorder hands back: a frame that passes every check."""

    def __init__(self, n, halving):
        self.frame = pd.DataFrame({m: np.ones(n) for m in jt.METRIC_KEYS})
        if halving:
            self.frame["trained_epochs"] = np.full(n, 16)

    def get_results(self):
        return self

    def get_dataframe(self):
        return self.frame.copy()


def recorder(calls, utils_module):
    original_budget = utils_module.device_memory_budget

    def tune(ad_sc, ad_sp, metric, config, tuner_num_samples, cluster_label, search,
             population_batch_size, random_state, device=None, mesh=None):
        calls.append(dict(
            X_sc=np.asarray(ad_sc.X), labels=list(ad_sc.obs["subclass_label"]),
            X_sp=np.asarray(ad_sp.X), spatial=np.asarray(ad_sp.obsm["spatial"]),
            metric=list(metric), config={k: domain(v) for k, v in config.items()},
            n=tuner_num_samples, label=cluster_label, search=search,
            batch=population_batch_size, seed=random_state,
            mesh=None if mesh is None else tuple(
                getattr(mesh, "axis_names", None) or mesh.mesh_dim_names),
            restart=utils_module.device_memory_budget is not original_budget,
            numpy_seed=np.random.get_state()[1][0]))
        return Result(tuner_num_samples, "halving" in search)

    return tune


class StandIn:
    """A mesh the recorder only reads the axis names of."""

    def __init__(self, names):
        self.mesh_dim_names = names


def recorded(monkeypatch, seed):
    jax_calls, port_calls = [], []
    tool = load_jax_tool()
    monkeypatch.setattr(tangram_tpu, "mapping_hyperparameter_tuning",
                        recorder(jax_calls, tangram_tpu.utils))
    assert tool.run(seed, TRIALS) == 0
    monkeypatch.setattr(tt, "mapping_hyperparameter_tuning",
                        recorder(port_calls, tangram_tpu_torch.utils))
    monkeypatch.setattr(ft, "trial_meshes", lambda device: {
        "1d": StandIn(("trial",)), "2d": StandIn(("trial", "cell"))})
    assert ft.run(seed, TRIALS, device="cpu") == 0
    return jax_calls, port_calls


@pytest.mark.parametrize("seed", SEEDS)
def test_port_draws_jax_trials(monkeypatch, seed):
    jax_calls, port_calls = recorded(monkeypatch, seed)
    assert len(jax_calls) == len(port_calls) >= 2 * TRIALS
    # the JAX tool's ("trial",) over 4 virtual devices, ("trial", "cell") 2 x 3
    for j, p in zip(jax_calls, port_calls):
        assert j.keys() == p.keys()
        for key in j:
            if isinstance(j[key], np.ndarray):
                assert np.array_equal(j[key], p[key]), key
            else:
                assert j[key] == p[key], key


def test_port_frames_match_jax():
    tool = load_jax_tool()
    port_rng = np.random.default_rng(FRAME_SEED)
    jax_rng = np.random.default_rng(FRAME_SEED)
    for _ in range(FRAME_TRIALS):
        trial = ft.draw_trial(port_rng)
        # the same draws through the JAX tool's functions, up to its pair
        for lo, hi in ((12, 40), (6, 24), (6, 16), (2, 5)):
            jax_rng.integers(lo, hi)
        jax_rng.choice(["sobol", "adaptive", "halving", "adaptive+halving"])
        jax_rng.integers(3, 9)
        jax_rng.integers(2, 5)
        jax_rng.choice(jt.METRIC_KEYS, size=int(jax_rng.integers(1, 3)), replace=False)
        config = tool.random_space(jax_rng)
        if "halving" in trial.search:
            config["num_epochs"] = 16
        assert int(jax_rng.integers(0, 2**31)) == trial.seed
        jsc, jsp = tool.make_adatas(jax_rng, trial.c, trial.s, trial.g, trial.n_types)
        ft.draw_mesh(port_rng)
        ft.draw_mesh(jax_rng)
        assert {k: domain(v) for k, v in config.items()} == {
            k: domain(v) for k, v in trial.config.items()}
        for key in ("spatial_connectivities", "spatial_distances"):
            trial.ad_sp.obsp[key] = jsp.obsp[key].copy()
        kw = {k: v for k, v in trial.kwargs(None).items() if k not in ("device", "config")}
        np.random.seed(trial.seed % (2**31))
        want = jt.mapping_hyperparameter_tuning(
            jsc, jsp, config=config, **kw).get_results().get_dataframe()
        got = ft.frame(trial, "cpu")
        assert list(got.columns) == list(want.columns)
        for col in want.columns:
            if col in jt.METRIC_KEYS:
                np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                           atol=METRIC_ATOL, err_msg=col)
            else:
                assert np.array_equal(got[col].to_numpy(), want[col].to_numpy()), col


def test_planted_fault_in_restart_path(monkeypatch, capsys):
    original = tt._PopulationSetup.fit_halving

    def short_restarts(self, num_epochs, active=None):
        """Halving rungs that restart from the start (start 0, past the first
        rung's epochs) train one epoch short."""
        fn = original(self, num_epochs, active)
        first = []

        def faulty(lam_mat, lr_peaks, lr_ends, M, count, mu, nu, start, steps):
            first.append(steps)
            if start == 0 and steps > first[0]:
                steps -= 1
            return fn(lam_mat, lr_peaks, lr_ends, M, count, mu, nu, start, steps)

        return faulty

    monkeypatch.setattr(tt._PopulationSetup, "fit_halving", short_restarts)
    assert ft.run(FRAME_SEED, TRIALS, device="cpu") == 1
    out = capsys.readouterr().out.splitlines()
    failed = [line for line in out if ": FAIL " in line]
    assert len(failed) == 1 and failed[0].startswith("[2] halving")
    assert out[-1] == f"{TRIALS} trials, 1 failures"


def test_trial_mesh_on_gloo_ranks(tmp_path):
    ranks = pw.run(str(tmp_path), suite="fuzz_tuner")
    for rank, results in enumerate(ranks):
        assert "error" not in results["fuzz"], results["fuzz"].get("error")
        assert results["fuzz"]["fails"] == 0
        assert results["fuzz"]["meshes"] == {"1d": {"trial": 4},
                                             "2d": {"trial": 2, "cell": 2}}
        lines = results["fuzz"]["lines"]
        if rank:
            assert lines == []
        else:
            assert len(lines) == pw.FUZZ_TUNER_TRIALS + 1
            assert lines[-1] == f"{pw.FUZZ_TUNER_TRIALS} trials, 0 failures"


def test_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "tangram_tpu_torch.scripts.fuzz_tuner", "0", "3", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("trial-mesh checks skipped")
    assert [line.endswith(": ok") for line in lines[1:-1]] == [True] * 3
    assert lines[-1] == "3 trials, 0 failures"
