"""The training loop's printed and warned contract: the port's ``Mapper`` and
``MapperConstrained`` against ``tests/test_printing.py`` and against the
JAX package's own output on the same problem.

Every case of ``tests/test_printing.py`` runs on the port: the
single-device ones on the reference loop and on the fused loop
(``impl="fused"``, whose kernels run their plain twins on the CPU), the
four mesh cases on a 1-D ``("cell",)`` mesh of four ``gloo`` processes
(``tests/_parallel_worker.py``, spawned once for this file). Beyond the
JAX test's own assertions, each printed score line and each divergence
warning is compared with the JAX package's, byte for byte, from the same
problem and seed: the lines print three decimals of values that the two
packages compute to ~1e-6. Numeric comparisons keep the JAX test's
tolerances: a chunked run against one run 1e-6; a mesh against one device
2e-5 on the mapping and F, 2e-4 on the losses and validation scores.
"""

import logging
import re
from functools import lru_cache

import numpy as np
import pytest
import torch

import _parallel_worker as pw
from tangram_tpu.models import mapper as jm
from tangram_tpu_torch.models import mapper as tm
from tangram_tpu_torch.ops.losses import val_metrics

IMPLS = ["reference", "fused"]
LINE = r"Gene-voxel score: -?\d+\.\d{3}, Cell densities reg: -?\d+\.\d{3}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many fits of a 12 × 9 problem: one intra-op thread keeps them from
    contending for every core with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    return pw.printing_problem()


def lines_of(capsys):
    return [line for line in capsys.readouterr().out.splitlines() if line.strip()]


@lru_cache(maxsize=None)
def jax_lines(case):
    """What the JAX package prints for ``case`` (see ``CASES``)."""
    return pw.printed(lambda: CASES[case](jm, {}))[1]


def _problem_kw():
    S, G, d = pw.printing_problem()
    return dict(S=S, G=G, d=d)


CASES = {
    "cadence": lambda m, kw: m.Mapper(**_problem_kw(), lambda_d=1.0, random_state=1,
                                      **kw).train(num_epochs=25, learning_rate=0.1,
                                                  print_each=10),
    "constrained": lambda m, kw: m.MapperConstrained(
        **_problem_kw(), target_count=5, random_state=1, **kw).train(
            num_epochs=5, learning_rate=0.1, print_each=5),
    "val": lambda m, kw: m.Mapper(**dict(_problem_kw(), d=None), random_state=2, **kw).train(
        num_epochs=20, learning_rate=0.1, print_each=10, val_each=4),
    "constrained chunks": lambda m, kw: m.MapperConstrained(
        **_problem_kw(), target_count=6, random_state=2, **kw).train(
            num_epochs=20, learning_rate=0.1, print_each=10),
}


def port(case, impl):
    """The port's result of ``case`` and the lines it printed."""
    return pw.printed(lambda: CASES[case](tm, dict(device="cpu", impl=impl)))


@pytest.mark.parametrize("impl", IMPLS)
def test_print_lines_format_and_cadence(impl):
    _, lines = port("cadence", impl)
    assert len(lines) == 3  # epochs 0, 10, 20
    for line in lines:
        assert re.fullmatch(LINE, line), line
    assert lines == jax_lines("cadence")


@pytest.mark.parametrize("impl", IMPLS)
def test_constrained_print_format(impl):
    _, lines = port("constrained", impl)
    out = "\n".join(lines)
    assert "Score:" in out and "Count reg:" in out and "Lambda f reg:" in out
    assert lines == jax_lines("constrained")


@pytest.mark.parametrize("impl", IMPLS)
def test_print_and_val_combined(impl):
    """print_each chunking + val_each cadence work together."""
    (_, hist), lines = port("val", impl)
    assert len(lines) == 2
    assert len(hist["val_gene_sim"]) == 5  # epochs 0, 4, 8, 12, 16
    assert len(hist["total_loss"]) == 20
    assert lines == jax_lines("val")


@pytest.mark.parametrize("impl", IMPLS)
def test_print_each_zero_means_no_printing(problem, capsys, impl):
    S, G, d = problem
    _, hist = tm.Mapper(S=S, G=G, random_state=2, device="cpu", impl=impl).train(
        num_epochs=5, learning_rate=0.1, print_each=0)
    assert capsys.readouterr().out == ""
    assert len(hist["total_loss"]) == 5

    mc = tm.MapperConstrained(S=S, G=G, d=d, target_count=6, random_state=2, device="cpu",
                              impl=impl)
    _, _, hist_c = mc.train(num_epochs=3, learning_rate=0.1, print_each=0)
    assert capsys.readouterr().out == ""
    assert len(hist_c["total_loss"]) == 3


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_epochs_does_not_crash(problem, capsys, impl):
    S, G, _ = problem
    out, hist = tm.Mapper(S=S, G=G, random_state=2, device="cpu", impl=impl).train(
        num_epochs=0, learning_rate=0.1, print_each=10)
    assert hist["total_loss"] == []
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("impl", IMPLS)
def test_val_metrics_are_post_step(problem, impl):
    """Validation entries are evaluated after the optimizer step
    (reference ``mapping_optimizer.py:394-403``)."""
    S, G, _ = problem
    m = tm.Mapper(S=S, G=G, random_state=2, device="cpu", impl=impl)
    M0 = m.M.clone()
    _, hist = m.train(num_epochs=3, learning_rate=0.1, print_each=None, val_each=1)
    pre_step = float(val_metrics(M0, m.data.S, m.data.G)["val_gene_sim"])
    post_step = float(val_metrics(m.M, m.data.S, m.data.G)["val_gene_sim"])
    assert hist["val_gene_sim"][0] != pytest.approx(pre_step, abs=1e-9)
    assert hist["val_gene_sim"][-1] == pytest.approx(post_step, rel=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_sparse_val_cadence_entries_are_finite(problem, impl):
    S, G, _ = problem
    _, hist = tm.Mapper(S=S, G=G, random_state=2, device="cpu", impl=impl).train(
        num_epochs=20, learning_rate=0.1, print_each=None, val_each=7)
    assert len(hist["val_gene_sim"]) == 3  # epochs 0, 7, 14
    assert np.isfinite(hist["val_gene_sim"]).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_constrained_prints_stream_per_chunk(problem, impl):
    """Constrained score lines appear per print_each chunk, and chunking
    equals one run."""
    S, G, d = problem
    (out_c, F_c, hist_c), lines = port("constrained chunks", impl)
    assert len(lines) == 2  # epochs 0 and 10
    assert lines == jax_lines("constrained chunks")

    mc = tm.MapperConstrained(S=S, G=G, d=d, target_count=6, random_state=2, device="cpu",
                              impl=impl)
    out_1, F_1, hist_1 = mc.train(num_epochs=20, learning_rate=0.1, print_each=None)
    np.testing.assert_allclose(out_c, out_1, atol=1e-6)
    np.testing.assert_allclose(F_c, F_1, atol=1e-6)
    np.testing.assert_allclose(hist_c["total_loss"], hist_1["total_loss"], rtol=1e-6)


def warnings_of(caplog, mod, **kw):
    """The divergence warnings of an 8-epoch run of ``mod``'s Mapper."""
    S, G, d = pw.printing_problem()
    lr = kw.pop("learning_rate")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        mod.Mapper(S=S, G=G, d=d, lambda_d=1.0, random_state=0, **kw).train(
            num_epochs=8, learning_rate=lr, print_each=None)
    return [r.getMessage() for r in caplog.records if "diverged" in r.getMessage()]


@pytest.mark.parametrize("impl", IMPLS)
def test_divergence_warning(caplog, impl):
    """An absurd L2 weight overflows f32 at the first loss evaluation: the
    run warns with its first non-finite epoch, as the JAX package's does,
    word for word; a healthy run stays silent."""
    diverging = dict(lambda_l2=1e38, learning_rate=1e3)
    got = warnings_of(caplog, tm, device="cpu", impl=impl, **diverging)
    want = warnings_of(caplog, jm, **diverging)
    assert len(got) == 1 and got == want
    assert "non-finite at epoch 0 of 8" in got[0]

    assert warnings_of(caplog, tm, device="cpu", impl=impl, learning_rate=0.1) == []


# ---------------------------------------------------------------------------
# the mesh cases, on four gloo processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every rank's results of ``_parallel_worker.printing_jobs``."""
    return pw.run(str(tmp_path_factory.mktemp("gloo_printing")), suite="printing")


def mesh_result(mesh_runs, name):
    """Rank 0's result of ``name``, after checking that every rank printed
    the same lines."""
    out = mesh_runs[0][name]
    assert "error" not in out, out.get("error")
    for rank in mesh_runs[1:]:
        assert rank[name]["lines"] == out["lines"]
    return out


def test_mesh_prints_stream_and_match_single_device(mesh_runs, problem, capsys):
    got = mesh_result(mesh_runs, "stream")
    assert len(got["lines"]) == 2  # epochs 0 and 10
    assert got["lines"][0].startswith("Gene-voxel score:")

    S, G, d = problem
    out_1, hist_1 = jm.Mapper(S=S, G=G, d=d, lambda_d=1.0, random_state=2).train(
        num_epochs=20, learning_rate=0.1, print_each=10)
    assert got["lines"] == lines_of(capsys)
    out_t, hist_t = tm.Mapper(S=S, G=G, d=d, lambda_d=1.0, random_state=2,
                              device="cpu").train(num_epochs=20, learning_rate=0.1,
                                                  print_each=None)
    for out, hist in ((out_1, hist_1), (out_t, hist_t)):
        np.testing.assert_allclose(got["probs"], out, atol=2e-5)
        np.testing.assert_allclose(got["main_loss"], hist["main_loss"], atol=2e-4)


def test_mesh_val_cadence_survives_print_chunking(mesh_runs, problem):
    """val_each that does not divide print_each: validation at epochs 0,
    7, 14 across the chunk boundaries."""
    got = mesh_result(mesh_runs, "val cadence")
    assert len(got["val"]) == 3
    assert np.isfinite(got["val"]).all()
    S, G, _ = problem
    for mod, kw in ((jm, {}), (tm, dict(device="cpu"))):
        _, hist1 = mod.Mapper(S=S, G=G, random_state=2, **kw).train(
            num_epochs=20, learning_rate=0.1, print_each=None, val_each=7)
        np.testing.assert_allclose(got["val"], hist1["val_gene_sim"], atol=2e-4)


def test_mesh_early_stop_any_val_cadence(mesh_runs):
    """early_stop_window need not be a multiple of val_each on a mesh."""
    got = mesh_result(mesh_runs, "early stop")
    epochs_run = len(got["main_loss"])
    assert epochs_run <= 24
    assert len(got["val"]) == len(range(0, epochs_run, 3))
    assert np.isfinite(got["val"]).all()
    assert got["lines"] == []


def test_constrained_mesh_prints_stream(mesh_runs, problem, capsys):
    got = mesh_result(mesh_runs, "constrained")
    assert len(got["lines"]) == 2
    assert got["lines"][0].startswith("Score:")
    assert got["lines"] == jax_lines("constrained chunks")

    S, G, d = problem
    out_1, F_1, _ = tm.MapperConstrained(S=S, G=G, d=d, target_count=6, random_state=2,
                                         device="cpu").train(num_epochs=20,
                                                             learning_rate=0.1,
                                                             print_each=None)
    np.testing.assert_allclose(got["probs"], out_1, atol=2e-5)
    np.testing.assert_allclose(got["F"], F_1, atol=2e-5)
