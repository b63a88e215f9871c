"""Whole mappings of the port in bf16 storage with stochastic rounding,
held to the benchmark's stochastic-rounding reference
(``benchmark/reference/stochastic.py``) by the check of its cell
(``benchmark/drivers/job_sr.py``), on the CPU at 300 cells × 200 spots ×
40 genes.

The program (``impl="fused"`` on the kernels' plain twins) and the
reference round independently, so they agree in law and not bit for bit:
their gaps are those of the reference against itself with other rounding
bits. Tolerances, from readings of this problem at 200 epochs (the
reference against itself with three other bit streams; the program beside
them):

* ``map_row_l1_median`` 0.08: the other streams read 0.046-0.048, the
  program 0.050;
* ``map_rows_off`` 0 at a row threshold of 0.5: their widest rows read
  0.13-0.20, the program's 0.18;
* ``loss_max`` 3e-4: they read 0.9e-4-1.2e-4, the program 1.8e-4 (its
  kernels' twins also sum in another order), the worst step's loss gap
  over the history's mean |loss|;
* ``loss_tail`` 5e-5: they read 5e-6-1.1e-5, the program 1.0e-5; the gap
  of the mean of the last 100 losses averages the rounding noise away;
* ``score_max`` 4e-3: they read 1.1e-3-1.4e-3, the program 2.1e-3.

Rounding to nearest (nu stops decaying once 0.999·nu rounds back to nu)
and contraction operands at 3 mantissa bits read ``loss_tail`` 4.0e-4 and
2.7e-4 here, and ``loss_max`` 6.4e-4 and 4.0e-4, and fail. At 30 epochs
neither control yet departs from the noise, so these runs take 200.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse
import torch

import tangram_tpu_torch as tgt
from benchmark.drivers import job_sr
from benchmark.reference import generators, stochastic, tangram

CELLS, SPOTS, GENES, TYPES = 300, 200, 40, 5
EPOCHS = 200
RANDOM_STATE = 2**31 + 23
ROW_OFF = 0.5
TOLERANCE = {"map_row_l1_median": 0.08, "map_rows_off": 0.0, "loss_max": 3e-4,
             "loss_tail": 5e-5, "score_max": 4e-3}
BF16_SR = dict(param_dtype="bfloat16", moment_dtype="bfloat16", compute_dtype="bfloat16",
               rounding="stochastic")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return generators.tutorial_pair(CELLS, SPOTS, 400, 350, GENES + 4, GENES, TYPES,
                                    2**31 + 11, 0.09, 0.006)


def _reference(pair, epochs=EPOCHS, **kw):
    return stochastic.run_job(pair.markers, pair.genes_sc, pair.X_sc, None, pair.genes_sp,
                              pair.X_sp, "cells", "rna_count_based", epochs, 0.1, RANDOM_STATE,
                              "cpu", **kw)


@pytest.fixture(scope="module")
def reference(pair):
    torch.set_num_threads(1)
    return _reference(pair)


def _adatas(pair):
    def csr(X):
        return scipy.sparse.csr_matrix((X.data, X.indices, X.indptr), shape=X.shape)

    ad_sc = tgt.AnnData(X=csr(pair.X_sc), obs=pd.DataFrame(index=[f"c{i}" for i in range(CELLS)]),
                        var=pd.DataFrame(index=pair.genes_sc))
    ad_sp = tgt.AnnData(X=csr(pair.X_sp), obs=pd.DataFrame(index=[f"v{i}" for i in range(SPOTS)]),
                        var=pd.DataFrame(index=pair.genes_sp))
    tgt.pp_adatas(ad_sc, ad_sp, genes=pair.markers)
    return ad_sc, ad_sp


def _program(pair, **options):
    ad_sc, ad_sp = _adatas(pair)
    ad = tgt.map_cells_to_space(ad_sc, ad_sp, mode="cells", density_prior="rna_count_based",
                                num_epochs=EPOCHS, learning_rate=0.1, random_state=RANDOM_STATE,
                                device="cpu", impl="fused", verbose=False,
                                **dict(BF16_SR, **options))
    scores = ad.uns["train_genes_df"]["train_score"]
    return (np.asarray(ad.X, dtype=np.float32), dict(zip(scores.index, scores.to_numpy())),
            np.asarray(ad.uns["training_history"]["total_loss"], dtype=np.float64))


def _failed(numbers):
    return {k for k, limit in TOLERANCE.items() if not numbers[k] <= limit}


def test_the_program_in_bf16_with_stochastic_rounding_passes_the_check(pair, reference):
    numbers = job_sr.gaps(reference, _program(pair), torch.device("cpu"), ROW_OFF)
    assert not _failed(numbers), numbers


@pytest.mark.parametrize("control", ["rounding_nearest", "operands_e4m3"])
def test_a_control_fails_the_check(pair, reference, control):
    if control == "rounding_nearest":
        output = _program(pair, rounding="nearest")
    else:
        out = _reference(pair, operands="e4m3", bits=RANDOM_STATE + 1)
        output = (out.mapping.numpy(), out.scores, out.total_loss)
    numbers = job_sr.gaps(reference, output, torch.device("cpu"), ROW_OFF)
    assert "loss_tail" in _failed(numbers), numbers


def _bf16_ulp(x):
    """The spacing of bf16 values at each f32 value of ``x``."""
    return (x.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0 ** -7


def test_the_reference_sr_cast_is_unbiased_and_moves_a_value_less_than_one_ulp():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(64, generator=gen) * torch.logspace(-6, 3, 64)
    x[:4] = torch.tensor([1.0, -0.375, 2.0 ** -20, 96.0])  # bf16 values stay as they are
    n = 4096
    casts = torch.stack([stochastic.sr_bf16(x, gen).float() for _ in range(n)])
    ulp = _bf16_ulp(x)
    assert ((casts - x).abs() < ulp).all()
    assert (casts[:, :4] == x[:4]).all()
    lo = x.to(torch.bfloat16).float()  # either neighbour: which one lo is does not matter
    p = ((x - lo).abs() / ulp).clamp(0, 1)
    sigma = ulp * torch.sqrt(p * (1 - p) / n)
    # each mean within 5 σ of its value: a cast that rounds to nearest, or
    # truncates, misses by a quarter ulp on average, over 30 σ here
    assert ((casts.mean(0) - x).abs() <= 5 * sigma + 1e-12 * ulp).all()
    assert casts.std(0)[4:].gt(0).sum() >= 56  # almost every value rounds both ways


def test_e4m3_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.0625001, 1.1875, 1.999, -3.3, 1e-30, 1e30])
    out = stochastic.e4m3_round(x)
    assert out.tolist()[:5] == [1.0, 1.0, 1.125, 1.25, 2.0]  # 1/16 is a tie: to even
    assert out[5] == -3.25 and (out.view(torch.int32) & 0xFFFFF == 0).all()
    assert ((out[6:] - x[6:]).abs() <= x[6:].abs() / 16).all()


def test_at_nearest_rounding_the_reference_is_the_bf16_reference_bit_for_bit(pair):
    epochs = 30
    near = _reference(pair, epochs, rounding="nearest")
    plain = tangram.run_job(pair.markers, pair.genes_sc, pair.X_sc, None, pair.genes_sp,
                            pair.X_sp, "cells", "rna_count_based", epochs, 0.1, RANDOM_STATE,
                            "cpu", stochastic.BF16)
    assert torch.equal(near.mapping, plain.mapping)
    assert np.array_equal(near.total_loss, plain.total_loss)
    # the scores: the f32 softmax and S, as the program reports them
    _, S, G, _ = tangram.preprocess(pair.markers, pair.genes_sc, pair.X_sc, pair.genes_sp,
                                    pair.X_sp)
    f32 = tangram.gene_scores(plain.mapping, torch.tensor(S), torch.tensor(G), "float32")
    assert list(near.scores.values()) == list(f32)
    sr = _reference(pair, epochs)
    assert not torch.equal(sr.mapping, plain.mapping)


@pytest.mark.parametrize("mode", ["cells", "constrained"])
def test_the_epilogue_backward_runs_on_the_calling_thread(pair, mode, monkeypatch):
    """On a CUDA device the autograd engine's own thread may free its last
    buffers after the caller resumes, so a job's peak device memory would
    move from run to run; the fused steps take the epilogue's backward on
    their own thread."""
    from tangram_tpu_torch.ops import fused_step

    name = "unconstrained_epilogue" if mode == "cells" else "constrained_epilogue"
    epilogue, seen = getattr(fused_step, name), []

    def watched(*args, **kw):
        seen.append(torch.autograd.is_multithreading_enabled())
        return epilogue(*args, **kw)

    monkeypatch.setattr(fused_step, name, watched)
    ad_sc, ad_sp = _adatas(pair)
    extra = dict(target_count=SPOTS) if mode == "constrained" else {}
    tgt.map_cells_to_space(ad_sc, ad_sp, mode=mode, num_epochs=3, random_state=RANDOM_STATE,
                           device="cpu", impl="fused", verbose=False, **extra)
    assert seen == [False] * 3
    assert torch.autograd.is_multithreading_enabled()
