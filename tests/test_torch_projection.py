"""The port's ``projected_expression`` (``Mᵀ @ X`` behind ``project_genes``)
against the JAX package's: ``backend="auto"|"host"|"device"`` and
``spot_chunk`` with the JAX package's semantics
(``tangram_tpu/evaluation.py:40-104``).

On the CPU the chunked device path runs with ``device="cpu"``; the host
product is numpy's f32 ``M.T @ X`` in both packages, so the two agree bit
for bit, and the chunked path agrees with it to rtol 1e-5 (f32 sums in
another order), as ``tests/test_api.py`` holds the JAX package's.
``backend="device"`` without CUDA raises rather than running on the CPU.
The card's case is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import tangram_tpu as tg
import tangram_tpu_torch as tgt
from tangram_tpu import evaluation as jev
from tangram_tpu_torch import evaluation as tev


def operands(seed=0, c=37, s=53, g=11):
    rng = np.random.default_rng(seed)
    return rng.random((c, s)).astype(np.float32), rng.random((c, g)).astype(np.float32)


@pytest.mark.parametrize("spot_chunk", [1, 16, 52, 53, 16384])
def test_chunked_device_path_matches_host_at_chunk_edges(spot_chunk):
    M, X = operands()
    host = tev.projected_expression(M, X, backend="host")
    np.testing.assert_array_equal(host, jev.projected_expression(M, X, backend="host"))
    np.testing.assert_allclose(host, M.T @ X, rtol=1e-6)
    chunked = tev.projected_expression(M, X, backend="device", spot_chunk=spot_chunk,
                                       device="cpu")
    assert chunked.dtype == np.float32 and chunked.shape == (53, 11)
    np.testing.assert_allclose(chunked, host, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        chunked, jev.projected_expression(M, X, backend="device", spot_chunk=spot_chunk),
        rtol=1e-5, atol=1e-6)


def test_device_backend_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: backend='device' runs there")
    M, X = operands()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tev.projected_expression(M, X, backend="device")


def test_auto_takes_the_card_only_for_large_maps_with_cuda(monkeypatch):
    big = tev._DEVICE_MM_THRESHOLD
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tev._projects_on_device("auto", big, None)
    assert tev._projects_on_device("auto", big, "cuda:0")
    assert not tev._projects_on_device("auto", big - 1, None)
    assert not tev._projects_on_device("auto", big, "cpu")
    assert tev._projects_on_device("device", 1, "cpu")
    assert not tev._projects_on_device("host", big, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not tev._projects_on_device("auto", big, None)
    with pytest.raises(ValueError, match="backend must be"):
        tev.projected_expression(*operands(), backend="gpu")


def test_device_path_restores_the_tf32_flag():
    M, X = operands()
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tev.projected_expression(M, X, backend="device", device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_project_genes_projects_like_jax():
    """project_genes on one shared map: the same (spots × genes) matrix and
    the same is_training column."""
    rng = np.random.default_rng(1)
    S = (rng.poisson(2.0, (20, 14)) + 1).astype(np.float32)
    P = rng.dirichlet(np.ones(9), size=20).astype(np.float32)
    genes = [f"G{i}" for i in range(14)]
    out = []
    for pkg in (tg, tgt):
        ad_sc = pkg.AnnData(X=S.copy(), var=pd.DataFrame(index=genes),
                            obs=pd.DataFrame(index=[f"c{i}" for i in range(20)]))
        ad_map = pkg.AnnData(X=P.copy(), obs=ad_sc.obs.copy(),
                             var=pd.DataFrame(index=[f"s{i}" for i in range(9)]))
        ad_map.uns["train_genes_df"] = pd.DataFrame(index=["g1", "g4"])
        out.append(pkg.project_genes(ad_map, ad_sc))
    want, got = out
    np.testing.assert_array_equal(got.X, want.X)
    pd.testing.assert_frame_equal(got.var, want.var)
