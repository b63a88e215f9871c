"""The PyTorch port's profiling module against the JAX package's, and the
profiling cases of ``tests/test_checkpoint_and_extras.py``.

``record_phases`` must itemize a port ``map_cells_to_space`` under the JAX
package's phase names and the port's five finer ones (cells and
constrained modes, one small run each);
``benchmark_mapping`` returns the JAX package's keys; ``trace`` writes a
trace file with the annotated range in it.
"""

import glob
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu import profiling as jprof
from tangram_tpu_torch import profiling as tprof


def small_pair(pkg, seed=0):
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (24, 10)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (16, 10)) + 1).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(10)])
    ad_sc = pkg.AnnData(X=S, var=genes.copy(),
                        obs=pd.DataFrame(index=[f"c{i}" for i in range(24)]))
    ad_sp = pkg.AnnData(X=G, var=genes.copy(),
                        obs=pd.DataFrame(index=[f"s{i}" for i in range(16)]))
    pkg.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


@pytest.mark.parametrize("mode", ["cells", "constrained"])
def test_record_phases_names_match_jax(mode):
    phases = {}
    target = dict(target_count=16) if mode == "constrained" else {}
    for pkg, prof, kw in ((tg, jprof, {}), (tgt, tprof, dict(device="cpu"))):
        ad_sc, ad_sp = small_pair(pkg)
        with prof.record_phases() as rec:
            pkg.map_cells_to_space(ad_sc, ad_sp, mode=mode, num_epochs=5,
                                   random_state=1, verbose=False, **target, **kw)
        phases[pkg] = rec
    jax_names = {"preprocess", "mapper_init", "train_dispatch", "train_execute_history",
                 "mapping_fetch", "gene_report"}
    assert set(phases[tg]) == jax_names
    assert jax_names <= set(phases[tgt])
    assert set(phases[tgt]) == jax_names | {
        "inputs", "init_draw", "init_cast", "init_upload", "result_build"}
    assert all(v >= 0 for v in phases[tgt].values())


def test_record_phases_is_scoped_and_reentrant():
    assert getattr(tprof._PHASE_SINK, "sink", None) is None
    with tprof.phase("nothing recorded"):
        pass
    with tprof.record_phases() as outer:
        with tprof.phase("a"):
            pass
        with tprof.record_phases() as inner:
            with tprof.phase("b"):
                pass
        with tprof.phase("a"):
            pass
    assert set(outer) == {"a"} and set(inner) == {"b"}
    assert getattr(tprof._PHASE_SINK, "sink", None) is None


def test_chunked_training_marks_every_chunk(monkeypatch):
    """The port trains in print chunks whatever ``verbose`` says; each
    chunk adds to train_dispatch and train_execute_history."""
    ad_sc, ad_sp = small_pair(tgt)
    mapper = tgt.Mapper(ad_sc.X, ad_sp.X, device="cpu", random_state=1)
    calls, phase = [], tprof.phase

    def counting(name):
        calls.append(name)
        return phase(name)

    monkeypatch.setattr(tprof, "phase", counting)
    with tprof.record_phases() as rec:
        mapper.train(num_epochs=6, print_each=2)
    assert calls.count("train_dispatch") == calls.count("train_execute_history") == 3
    assert {"train_dispatch", "train_execute_history", "mapping_fetch"} <= set(rec)


def test_benchmark_mapping_runs():
    out = tprof.benchmark_mapping(32, 24, n_genes=8, num_epochs=5, device="cpu")
    want = jprof.benchmark_mapping(32, 24, n_genes=8, num_epochs=5)
    assert set(out) == set(want)
    assert out["backend"] == "cpu"
    assert out["seconds"] > 0 and out["epochs_per_s"] > 0
    assert out["ms_per_step"] == pytest.approx(out["seconds"] / 5 * 1e3)
    assert (out["n_cells"], out["n_spots"], out["n_genes"], out["num_epochs"]) == (
        32, 24, 8, 5)


def test_benchmark_mapping_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprof.benchmark_mapping(8, 8, n_genes=4, num_epochs=1)


def test_step_timer():
    timer = tprof.StepTimer()
    with timer("io"):
        pass
    with timer("io"):
        pass
    assert set(timer.summary()) == {"io"}
    assert timer.summary()["io"] >= 0


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    log_dir = str(tmp_path / "tb")
    x = torch.ones(64, 64)
    with tprof.trace(log_dir) as prof:
        with tprof.annotate("tangram_step"):
            (x @ x).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tangram_step" for e in events)
    assert any(e.key == "tangram_step" for e in prof.key_averages())
