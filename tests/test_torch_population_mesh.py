"""Data parallelism over whole problems: the port's ``cross_val(mesh=)``
and ``mapping_hyperparameter_tuning(mesh=)`` against the JAX package's, on
the CPU.

The port runs in six ``gloo`` processes (``tests/_population_mesh_worker.py``,
spawned once for the module) on ``("fold",)`` = 6, ``("fold", "cell")`` =
2 × 3, ``("batch", "cell")`` = 2 × 3 (no fold axis: the first one carries
the folds), ``("trial",)`` = 6 and ``("trial", "cell")`` = 2 × 3 meshes;
the JAX package on the same shapes over six devices of the 8-device CPU
mesh of ``tests/conftest.py``, from the same numpy inputs; the port
without a mesh in this process. The tolerances are those of the JAX test
each case mirrors: cross-validation scores 1e-5
(``tests/test_cross_val.py::test_cross_val_fold_mesh``,
``..._hierarchical_mesh``), tuner metrics 2e-3 and halving's trained
epochs equal (``tests/test_tuning.py::test_tuner_trial_mesh``,
``..._hierarchical_mesh``, ``..._halving_mesh``,
``tests/test_adaptive_search.py::test_adaptive_search_over_trial_mesh``);
a resumed sweep equals the unbroken one exactly (``tests/test_cross_val.py
::test_cross_val_resume``); ``_device_metrics`` on cell blocks the whole
cube's within 1e-6 (f32 sums in another order).

Each case also checks the split that took place (the (members, cells)
that every rank's fold or population trainer was handed) and that it
logged JAX's replication warnings, word for word.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

import jax
from jax.sharding import Mesh

import _population_mesh_worker as pw
import tangram_tpu as tg
import tangram_tpu.utils as jutils
import tangram_tpu_torch as tgt
import tangram_tpu_torch.utils as tutils
from tangram_tpu_torch import evaluation as tev
from tangram_tpu_torch.parallel.mesh import BatchLayout

CV_TOL = 1e-5
TUNER_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results of every case."""
    return pw.run(str(tmp_path_factory.mktemp("gloo")))


def result(port, name):
    out = port[0][name]
    assert "error" not in out, out.get("error")
    return out


def jax_mesh(name):
    shape, names = pw.MESHES[name]
    return Mesh(np.asarray(jax.devices()[:pw.WORLD]).reshape(shape), axis_names=names)


def replication_warnings(caplog):
    return [r.getMessage() for r in caplog.records if "REPLICATION" in r.getMessage()]


# ---------------------------------------------------------------------------
# cross-validation
# ---------------------------------------------------------------------------

#: the (folds, cells) each rank's fold trainer was handed, batch by batch
CV_SPLITS = {
    "cv fold": [(1, 30), (4, 30)],              # 6 on the fold axis, 4 whole
    "cv fold cell": [(4, 10), (1, 10)],
    "cv fold cell constrained": [(4, 10), (1, 10)],
    "cv first axis clusters": [(2, 1), (2, 1), (1, 1)],
    "cv replicated": [(4, 32), (1, 32)],        # 32 cells on 3 ranks: whole
}


@pytest.mark.parametrize("name", list(pw.CV_CASES))
def test_cross_val_on_a_mesh_matches_jax_and_one_process(port, name, caplog):
    got = result(port, name)
    mesh, n_cells, kw = pw.CV_CASES[name]
    with caplog.at_level(logging.WARNING):
        want = tg.cross_val(*pw.cv_adatas(tg, n_cells), verbose=False, mesh=jax_mesh(mesh),
                            **kw)
    assert got["warnings"] == replication_warnings(caplog)
    one = tgt.cross_val(*pw.cv_adatas(tgt, n_cells), verbose=False, device="cpu", **kw)
    for key in ("avg_test_score", "avg_train_score"):
        assert got["cv"][key] == pytest.approx(want[key], abs=CV_TOL)
        assert got["cv"][key] == pytest.approx(one[key], abs=CV_TOL)
    assert got["calls"] == CV_SPLITS[name]


def test_cross_val_resume_on_a_mesh(port):
    """The lead rank alone journals (one line a fold); cut to the first
    batch and resumed, the sweep repeats the unbroken one, held-out
    predictions included; both equal the run without a mesh."""
    out = result(port, "cv resume")
    assert out["lines"] == 1 + 12
    assert out["resumed"] == out["full"]
    np.testing.assert_array_equal(out["resumed_X"], out["full_X"])
    pd.testing.assert_frame_equal(out["resumed_df"], out["full_df"])
    # 12 LOO folds in batches of 4 over the fold axis of 2, cells over 3;
    # the resumed sweep trains the last two batches only
    assert out["calls"] == [(2, 10)] * 5
    one, one_ge, _ = tgt.cross_val(*pw.cv_adatas(tgt), verbose=False, device="cpu",
                                   **pw.CV_RESUME)
    for key in one:
        assert out["full"][key] == pytest.approx(one[key], abs=CV_TOL)
    np.testing.assert_allclose(out["full_X"], np.asarray(one_ge.X), atol=CV_TOL)


def test_auto_fold_batch_on_a_mesh(monkeypatch):
    """``fold_batch_size="auto"`` divides the (cells × spots) bytes by the
    cell shards and rounds down to a multiple of the fold axis, at least
    one fold a rank (JAX's rule); without a mesh nothing is split."""
    per_fold = tev._fold_bytes(30, 20, 12, cell_shards=3)
    assert per_fold == 40 * 30 * 20 // 3 + 24 * 20 * 12 + 16 * 30 * 12
    assert tev.auto_fold_batch_size(30, 20, 12, "cpu", cell_shards=3, fold_shards=4) == 256
    assert tev.auto_fold_batch_size(30, 20, 12, "cpu", fold_shards=6) == 252
    monkeypatch.setattr(tutils, "device_memory_budget", lambda device: 7 * per_fold + 1)
    assert tev.auto_fold_batch_size(30, 20, 12, "cpu", cell_shards=3, fold_shards=2) == 6
    assert tev.auto_fold_batch_size(30, 20, 12, "cpu", cell_shards=3, fold_shards=8) == 8
    layout = BatchLayout(None, "fold", 30, "per-fold")
    assert layout.rows == slice(0, 30) and layout.part(7) == slice(0, 7) and layout.lead
    x = torch.arange(7)
    assert layout.gather(x, 7) is x


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

#: the (configs, cells) each rank's population trainer was handed
TUNER_SPLITS = {
    "tuner trial": [(1, 30), (2, 30)],          # 6 on the trial axis, 2 whole
    "tuner trial cell": [(2, 10)],
    "halving carried": [(3, 10), (1, 10)],      # rungs of 6 and 2 alive
    "halving restarted": [(3, 10), (3, 10), (1, 10)],  # chunks of 3 whole
    "adaptive": [(1, 30), (2, 30)],
    "adaptive+halving": [(2, 10), (1, 10), (2, 10), (1, 10)],
    "tuner replicated": [(2, 28)],              # 28 cells on 3 ranks: whole
}


def tuner_frame(api, name, **extra):
    mesh, n_cells, space, kw = pw.TUNER_CASES[name]
    np.random.seed(pw.TUNER_SEED)
    return api.mapping_hyperparameter_tuning(
        *pw.tuner_adatas(api, n_cells), config=pw.tuner_space(api.tuning, space),
        **pw.TUNER_BASE, **kw, **extra).get_results().get_dataframe()


@pytest.mark.parametrize("name", list(pw.TUNER_CASES))
def test_tuner_on_a_mesh_matches_jax_and_one_process(port, name, monkeypatch, caplog):
    got = result(port, name)["df"]
    if name == "halving restarted":
        monkeypatch.setattr(jutils, "device_memory_budget", lambda *a, **k: 1.0)
        monkeypatch.setattr(tutils, "device_memory_budget", lambda *a, **k: 1.0)
    with caplog.at_level(logging.WARNING):
        want = tuner_frame(tg, name, mesh=jax_mesh(pw.TUNER_CASES[name][0]))
    # JAX warns once per population call, the port once per sweep
    assert result(port, name)["warnings"] == replication_warnings(caplog)[:1]
    one = tuner_frame(tgt, name, device="cpu")
    assert list(got.columns) == list(one.columns)
    configs = [c for c in got.columns if c.startswith("config/")]
    pd.testing.assert_frame_equal(got[configs], one[configs])
    for key in ("gene_expr_correctness", "cell_map_consistency", "gene_expr_consistency"):
        np.testing.assert_allclose(got[key], want[key], atol=TUNER_TOL, err_msg=key)
        np.testing.assert_allclose(got[key], one[key], atol=TUNER_TOL, err_msg=key)
    if "halving" in name:
        np.testing.assert_array_equal(got["trained_epochs"], want["trained_epochs"])
        np.testing.assert_array_equal(got["trained_epochs"], one["trained_epochs"])
    assert result(port, name)["calls"] == TUNER_SPLITS[name]


def test_tuner_resume_on_a_mesh(port):
    out = result(port, "tuner resume")
    assert out["lines"] == 1 + 8
    pd.testing.assert_frame_equal(out["resumed"], out["full"])
    assert out["calls"] == [(2, 10)] * 3


def test_device_metrics_on_cell_blocks_match_the_whole_cube(port):
    for rank in port:
        out = rank["device metrics"]
        assert out["rows"][1] - out["rows"][0] == 10
        for key, whole in out["whole"].items():
            np.testing.assert_allclose(out["part"][key], whole, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# every case
# ---------------------------------------------------------------------------


def test_replicated_cells_warn_only_where_they_do_not_divide(port):
    for case, out in port[0].items():
        assert bool(out["warnings"]) == case.endswith("replicated"), case
    for case in ("cv replicated", "tuner replicated"):
        message = result(port, case)["warnings"][0]
        assert "3-way" in message and "axes ('cell',)" in message and "Pad to" in message


def assert_same(a, b, where):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for key in a:
            assert_same(a[key], b[key], f"{where}/{key}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_every_rank_returns_the_same_result(port):
    """Every result each rank returned, to the bit (the cell blocks that
    ``_device_metrics`` was handed aside)."""
    for name, out in port[0].items():
        for other in port[1:]:
            assert_same({k: v for k, v in out.items() if k != "rows"},
                        {k: v for k, v in other[name].items() if k != "rows"}, name)
