"""The port's north-star entry point (``tangram_tpu_torch/north_star.py``)
against ``scripts/north_star.py``, on the CPU.

* ``--tiny --device cpu`` prints one JSON line with the JAX script's keys
  (the checks of ``tests/test_north_star_script.py:15-28``); the default
  device without a GPU raises.
* ``make_problem`` draws the JAX script's three arrays bit for bit
  (``scripts/north_star.py:62-66``).
* ``train`` in one process against ``fit_mapping_fused_sharded`` on the
  8-device CPU mesh, both from one numpy start at the tiny shape, 20
  epochs: in f32 the losses within rtol 1e-4 / atol 1e-5 and the logits
  within atol 2e-4 (``test_torch_parallel.py``'s 1-D rule, from
  ``tests/test_fused_sharded.py``); in the script's mix (bf16 moments and
  contraction inputs) ``main_loss`` within rtol = atol = 2e-2, the JAX
  package's own bound for that mix (``tests/test_fused_step.py``, the
  ``compute_dtype`` + ``moment_dtype`` case of ``test_torch_bf16.py``).
* The torchrun branch on four gloo ranks (``tests/_parallel_worker.py``,
  suite ``"north_star"``), 1-D ``("cell",)`` = 4 and 2-D 2 × 2: ``main``
  prints one line, on rank 0, naming the world; ``train`` on each mesh
  against one process at the same tolerances.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _parallel_worker as pw
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu.parallel.fused_sharded import fit_mapping_fused_sharded
from tangram_tpu_torch import north_star as ns

#: (losses: key, rtol, atol; logits atol or None) for each dtype mix
TOLERANCES = {"f32": (("total_loss", "main_loss"), 1e-4, 1e-5, 2e-4),
              "bf16": (("main_loss",), 2e-2, 2e-2, None)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_args(dtypes):
    args = ns.parse_args(["--tiny", "--device", "cpu"] + pw.NORTH_STAR_DTYPES[dtypes])
    args.epochs = pw.NORTH_STAR_EPOCHS
    return args


def port_fit(args):
    S, G, d = ns.make_problem(args)
    M, hist = ns.train(torch.from_numpy(pw.north_star_start(args)),
                       ns.mapper_data(S, G, d, "cpu"), args)
    return M.float().numpy(), {k: v.numpy() for k, v in hist.items()}


def jax_fit(args):
    """The JAX script's fit at ``args`` on the 8-device CPU mesh."""
    S, G, d = ns.make_problem(args)
    data = JMapperData(S=jnp.asarray(S), G=jnp.asarray(G), d=jnp.asarray(d))
    mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("cell",))
    params, history = fit_mapping_fused_sharded(
        jnp.asarray(pw.north_star_start(args)), data, JLossWeights(**ns.LOSS_WEIGHTS),
        args.epochs, args.lr, mesh=mesh, moment_dtype=jnp.dtype(args.moment_dtype),
        compute_dtype=jnp.dtype(args.compute_dtype))
    return (np.asarray(params.astype(jnp.float32)),
            {k: np.asarray(v) for k, v in history.items()})


def assert_close(got, want, dtypes):
    (M_g, h_g), (M_w, h_w) = got, want
    keys, rtol, atol, m_atol = TOLERANCES[dtypes]
    for key in keys:
        np.testing.assert_allclose(h_g[key], h_w[key], rtol=rtol, atol=atol)
    if m_atol is not None:
        np.testing.assert_allclose(M_g, M_w, atol=m_atol)


def test_tiny_run_prints_one_json_line(capsys):
    assert ns.main(["--tiny", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["metric"] == "north_star_96x40x12_5_epochs"
    assert out["value"] > 0 and out["unit"] == "seconds"
    assert out["parity_epoch"] <= 5
    assert math.isfinite(out["final_train_score"])
    assert out["mesh"] == "1d over 1 cpu devices"
    assert out["backend"] == "cpu" and out["data"] == "synthetic-poisson"
    assert out["peak_gib"] is None
    assert set(out) == {"metric", "value", "unit", "seconds_to_loss_parity", "parity_epoch",
                        "ms_per_step", "final_train_score", "mesh", "data", "backend",
                        "device_name", "peak_gib"}


def test_default_device_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ns.main(["--tiny"])


def test_defaults_are_the_jax_scripts():
    args = ns.parse_args([])
    assert (args.cells, args.spots, args.genes, args.epochs) == (100_000, 50_000, 249, 1000)
    assert (args.lr, args.mesh, args.moment_dtype, args.compute_dtype) == (
        0.1, "1d", "bfloat16", "bfloat16")
    assert (args.parity_tol, args.seed, args.device) == (1e-4, 0, "cuda")


@pytest.mark.parametrize("seed", [0, 3])
def test_make_problem_is_the_jax_scripts_draw(seed):
    args = ns.parse_args(["--tiny", "--seed", str(seed)])
    # scripts/north_star.py:62-66, as the script runs them
    rng = np.random.default_rng(args.seed)
    S = jnp.asarray(rng.poisson(1.0, (args.cells, args.genes)), jnp.float32)
    G = jnp.asarray(rng.poisson(2.0, (args.spots, args.genes)), jnp.float32)
    d = rng.random(args.spots).astype(np.float32)
    want = (np.asarray(S), np.asarray(G), np.asarray(jnp.asarray(d / d.sum())))
    for got, ref in zip(ns.make_problem(args), want):
        assert got.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_fit_matches_jax_fused_sharded(dtypes):
    args = tiny_args(dtypes)
    assert_close(port_fit(args), jax_fit(args), dtypes)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Every rank's results of the north-star suite on four gloo ranks."""
    return pw.run(str(tmp_path_factory.mktemp("gloo_north_star")), suite="north_star")


def rank_result(gloo, rank, name):
    out = gloo[rank][name]
    assert "error" not in out, out.get("error")
    return out


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_torchrun_branch_prints_on_rank_zero(gloo, mesh):
    lines = rank_result(gloo, 0, f"main {mesh}")["lines"]
    out = json.loads(lines[-1])
    assert out["mesh"] == f"{mesh} over {pw.WORLD} cpu devices"
    assert out["metric"] == "north_star_96x40x12_5_epochs" and out["parity_epoch"] <= 5
    assert math.isfinite(out["final_train_score"])
    for rank in range(1, pw.WORLD):
        assert rank_result(gloo, rank, f"main {mesh}")["lines"] == []


@pytest.mark.parametrize("mesh", ["1d", "2d"])
@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_torchrun_branch_matches_one_process(gloo, mesh, dtypes):
    one = port_fit(tiny_args(dtypes))
    for rank in range(pw.WORLD):
        got = rank_result(gloo, rank, f"fit {mesh} {dtypes}")
        assert_close((got["M"], got["hist"]), one, dtypes)
