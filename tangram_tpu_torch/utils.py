"""Small shared utilities (the counterpart of ``tangram_tpu/utils.py``).

Only ``annotate_gene_sparsity`` is on the main mapping path; the rest of the
reference's utility surface (annotation transfer, deconvolution, the
cross-validation re-exports) belongs to later slices (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["annotate_gene_sparsity"]


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
