"""Small shared utilities, plus the compatibility surface of the
reference's ``tangram/utils.py`` (the counterpart of
``tangram_tpu/utils.py``).

The reference keeps preprocessing helpers, annotation transfer, the
deconvolution chain, cross-validation and the AUC metric in one module;
here they live in :mod:`tangram_tpu_torch.deconv` and
:mod:`tangram_tpu_torch.evaluation`, and this module re-exports them so
that ``tangram_tpu_torch.utils.<name>`` works for every name of the JAX
package's ``utils`` but its XLA compilation cache. ``_SweepJournal`` and
``device_memory_budget`` serve the batched cross-validation,
``warn_tp_replication`` it and the tuner on a mesh.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import pickle

import numpy as np
import scipy.sparse as sp
import torch

from .deconv import (  # noqa: F401
    cell_type_mapping,
    count_cell_annotations,
    create_segment_cell_df,
    deconvolve_cell_annotations,
    df_to_cell_types,
    one_hot_encoding,
    project_cell_annotations,
)
from .evaluation import (  # noqa: F401
    compare_spatial_geneexp,
    cross_val,
    cv_data_gen,
    eval_metric,
    project_genes,
)

__all__ = [
    "device_memory_budget",
    "read_pickle",
    "annotate_gene_sparsity",
    "get_matched_genes",
    "one_hot_encoding",
    "project_cell_annotations",
    "create_segment_cell_df",
    "count_cell_annotations",
    "deconvolve_cell_annotations",
    "project_genes",
    "compare_spatial_geneexp",
    "cv_data_gen",
    "cross_val",
    "eval_metric",
    "transfer_annotations_prob",
    "transfer_annotations_prob_filter",
    "df_to_cell_types",
    "cell_type_mapping",
]


def read_pickle(filename):
    """Unpickle a file, transparently handling gzip compression
    (ref utils.py:26-43). Unpickling runs code: read only trusted files."""
    try:
        with gzip.open(filename, "rb") as f:
            return pickle.load(f)
    except OSError:
        with open(filename, "rb") as f:
            return pickle.load(f)


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


def get_matched_genes(prior_genes_names, sn_genes_names, excluded_genes=None):
    """Match two gene-name lists (ref utils.py:64-102).

    Returns (indices into ``prior_genes_names``, indices into
    ``sn_genes_names``, matched names), walking ``sn_genes_names`` in order
    and resolving duplicates in the prior list to their first occurrence.
    """
    excluded = set() if excluded_genes is None else set(excluded_genes)

    first_prior_pos = {}
    for pos, name in enumerate(np.asarray(prior_genes_names)):
        first_prior_pos.setdefault(name, pos)

    prior_idx, sn_idx, names = [], [], []
    for pos, name in enumerate(np.asarray(sn_genes_names)):
        if name in excluded or name not in first_prior_pos:
            continue
        prior_idx.append(first_prior_pos[name])
        sn_idx.append(pos)
        names.append(name)
    return prior_idx, sn_idx, names


# Deprecated in the reference (utils.py:762-787); kept for API parity.
def transfer_annotations_prob(mapping_matrix, to_transfer):
    return mapping_matrix.transpose() @ to_transfer


def transfer_annotations_prob_filter(mapping_matrix, filter, to_transfer):
    return mapping_matrix.transpose() @ (to_transfer * filter[:, np.newaxis])


def _jsonable(v):
    """numpy scalars → native Python for json round-trips."""
    if isinstance(v, np.generic):
        return v.item()
    return v


class _SweepJournal:
    """Crash-tolerant JSONL record of a multi-unit sweep (the JAX package's
    ``utils._SweepJournal``): one meta line, then one line per completed
    unit (a CV fold), appended batch by batch, so that a killed run loses
    at most one batch in flight. Used by ``cross_val(resume_path=...)``.

    On a mesh every rank builds it with ``sync``, the sweep's
    :class:`~tangram_tpu_torch.parallel.mesh.BatchLayout`: its lead rank
    alone writes, and each write ends in a barrier, so that every rank
    reads one file (several ranks appending would interleave lines)."""

    def __init__(self, path, meta: dict, sync=None):
        self.path = path
        self.meta = {k: _jsonable(v) for k, v in meta.items()}
        self.sync = sync

    def _writes(self) -> bool:
        return self.sync is None or self.sync.lead

    def _written(self) -> None:
        if self.sync is not None:
            self.sync.barrier()

    def load(self) -> list:
        """Stored records, in completion order. Raises if the file belongs
        to a different sweep (meta mismatch): resuming across sweeps would
        mix incomparable results."""
        if self._writes() and not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write(json.dumps({"kind": "meta", **self.meta}) + "\n")
        self._written()
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
        if self._writes():
            with open(self.path, "a") as f:
                for row in rows:
                    f.write(json.dumps(row, default=_jsonable) + "\n")
                f.flush()
        self._written()


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


def warn_tp_replication(shards, cell_axes, n_cells, what="per-trial"):
    """Loud fallback when requested cell sharding can't apply: a user who
    budgeted per-card memory for 1/shards of the logits would otherwise
    learn about the replication only via OOM. Shared by the tuner and
    batched cross-validation (the JAX package's message, word for word)."""
    pad = -n_cells % shards
    logging.warning(
        "mesh requests %d-way cell sharding over axes %s but n_cells=%d "
        "does not divide evenly; tensor parallelism degrades to "
        "REPLICATION (each chip holds full %s logits + optimizer moments, "
        "%dx the sharded budget). Pad to %d cells to restore sharding.",
        shards, cell_axes, n_cells, what, shards, n_cells + pad,
    )
