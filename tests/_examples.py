"""What ``tests/test_torch_examples*.py`` share: each runs one tutorial of
``examples/`` (the JAX package) and its port in
``tangram_tpu_torch/examples/`` in the same test process and compares what
the two printed."""

from __future__ import annotations

import contextlib
import importlib
import io
import re
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

#: a number as the tutorials print it (ints, floats, nan)
NUMBER = re.compile(r"-?\d+\.?\d*(?:e-?\d+)?|nan")


def printed(fn) -> list[str]:
    """The non-blank lines ``fn()`` printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [line for line in buf.getvalue().splitlines() if line.strip()]


def numbers(line: str) -> list[float]:
    return [float(x) for x in NUMBER.findall(line)]


def masked(line: str) -> str:
    """``line`` with every number replaced by ``#``: what two runs that
    differ only in rounding print alike."""
    return NUMBER.sub("#", line)


def line_starting(lines, prefix: str) -> str:
    (line,) = [x for x in lines if x.startswith(prefix)]
    return line


def jax_tutorial(name: str):
    """The JAX package's tutorial module ``examples.<name>``."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module(f"examples.{name}")


def training_genes_in_requested_order(monkeypatch):
    """Make the JAX package's ``pp_adatas`` (as ``tangram_tpu.pp_adatas``,
    what the tutorials call) keep ``uns['training_genes']`` in the requested
    order, as the port does: JAX's ``list(set(...))`` order moves with
    PYTHONHASHSEED, and the tutorials split folds by that order."""
    import tangram_tpu

    original = tangram_tpu.pp_adatas

    def pp_adatas(adata_sc, adata_sp, genes=None, gene_to_lowercase=True):
        out = original(adata_sc, adata_sp, genes=genes, gene_to_lowercase=gene_to_lowercase)
        requested = list(adata_sc.var.index) if genes is None else [
            g.lower() if gene_to_lowercase else g for g in genes]
        kept = set(adata_sc.uns["training_genes"])
        order = [g for g in dict.fromkeys(requested) if g in kept]
        for adata in (adata_sc, adata_sp):
            adata.uns["training_genes"] = order
        return out

    monkeypatch.setattr(tangram_tpu, "pp_adatas", pp_adatas)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
