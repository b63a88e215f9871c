"""Small shared utilities (the counterpart of ``tangram_tpu/utils.py``).

``annotate_gene_sparsity`` is on the main mapping path; ``one_hot_encoding``
builds the cell-type-island term's encoding; ``_SweepJournal`` and
``device_memory_budget`` serve the batched cross-validation. The rest of
the reference's utility surface (annotation transfer, deconvolution)
belongs to later slices (ROADMAP queue A).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

__all__ = ["annotate_gene_sparsity", "device_memory_budget", "one_hot_encoding"]


def annotate_gene_sparsity(adata):
    """Write ``var['sparsity']`` = fraction of observations where each gene
    is zero (ref utils.py:46-61)."""
    X = adata.X
    nonzero_per_gene = (
        np.asarray((X != 0).sum(axis=0)).ravel()
        if sp.issparse(X)
        else np.count_nonzero(np.asarray(X), axis=0)
    )
    adata.var["sparsity"] = 1.0 - nonzero_per_gene / float(adata.n_obs)


def one_hot_encoding(l, keep_aggregate=False):
    """Indicator DataFrame of a categorical sequence (ref utils.py:105; the
    JAX package's ``deconv.one_hot_encoding``). Columns follow the values'
    first appearance; with ``keep_aggregate`` the raw labels lead as a
    ``"cl"`` column."""
    labels = l if isinstance(l, pd.Series) else pd.Series(l)
    columns = {"cl": labels} if keep_aggregate else {}
    for cat in labels.unique():
        columns[cat] = (labels == cat).astype(int)
    return pd.DataFrame(columns)


def _jsonable(v):
    """numpy scalars → native Python for json round-trips."""
    if isinstance(v, np.generic):
        return v.item()
    return v


class _SweepJournal:
    """Crash-tolerant JSONL record of a multi-unit sweep (the JAX package's
    ``utils._SweepJournal``): one meta line, then one line per completed
    unit (a CV fold), appended batch by batch, so that a killed run loses
    at most one batch in flight. Used by ``cross_val(resume_path=...)``."""

    def __init__(self, path, meta: dict):
        self.path = path
        self.meta = {k: _jsonable(v) for k, v in meta.items()}

    def load(self) -> list:
        """Stored records, in completion order. Raises if the file belongs
        to a different sweep (meta mismatch): resuming across sweeps would
        mix incomparable results."""
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write(json.dumps({"kind": "meta", **self.meta}) + "\n")
            return []
        records = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == "meta":
                    stored = {k: rec.get(k) for k in self.meta}
                    if stored != self.meta:
                        raise ValueError(
                            f"resume_path {self.path!r} records a different "
                            f"sweep: {stored} != {self.meta}"
                        )
                else:
                    records.append(rec)
        return records

    def append(self, rows: list) -> None:
        with open(self.path, "a") as f:
            for row in rows:
                f.write(json.dumps(row, default=_jsonable) + "\n")
            f.flush()


def device_memory_budget(device=None, fraction=0.5):
    """Bytes of device memory a batched workload may claim: ``fraction`` of
    the card's total memory (``torch.cuda.mem_get_info``) on a CUDA device,
    ``None`` meaning ``"cuda"``; 2e9 on the CPU, as the JAX package's
    fallback for a backend that reports no memory."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return 2e9
    _, total = torch.cuda.mem_get_info(device)
    return fraction * float(total)
