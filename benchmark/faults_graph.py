"""Faults of the graph terms planted under the timed path, to show that
driver ``job_graph``'s check sees them.

Each is a context manager that patches the program while it is open:

* ``geary_gradient``: Geary's term keeps its value and loses its
  gradient;
* ``graph_vjp_untransposed``: the k-NN graph product's backward gathers
  with W in place of Wᵀ;
* ``islands_dropped``: the one-hot cell-type columns left out of the
  contraction (zero in A), so the island term sees no type map;
* ``five_nn``: the spot graphs built from a 5-nearest-neighbour graph in
  place of pp_adatas's 6.

The CPU tests drive a whole run under each; ``benchmark.calibrate_graph``
reads them on the card.
"""

from __future__ import annotations

import contextlib

from .faults import _patched

__all__ = ["FAULTS"]


@contextlib.contextmanager
def geary_gradient():
    from tangram_tpu_torch.ops import losses

    indicators = losses.spatial_local_indicators

    def detached(G, W, lw):
        getis, moran, geary = indicators(G, W, lw)
        return getis, moran, None if geary is None else geary.detach()

    with _patched(losses, "spatial_local_indicators", detached):
        yield


@contextlib.contextmanager
def graph_vjp_untransposed():
    from tangram_tpu_torch.ops import core, losses

    def untransposed(W, X):
        if isinstance(W, core.NeighborGraph):
            return core._GraphMatmul.apply(X, W.indices, W.weights, W.indices, W.weights)
        return core.graph_matmul(W, X)

    with _patched(losses, "graph_matmul", untransposed):
        yield


@contextlib.contextmanager
def islands_dropped():
    from tangram_tpu_torch.ops import fused_step

    inputs = fused_step.unconstrained_inputs

    def without_types(M, data, lw):
        A, w = inputs(M, data, lw)
        if A.shape[1] > data.S.shape[1]:
            A = A.clone()
            A[:, data.S.shape[1]:] = 0
        return A, w

    with _patched(fused_step, "unconstrained_inputs", without_types):
        yield


@contextlib.contextmanager
def five_nn():
    from tangram_tpu_torch import mapping
    from tangram_tpu_torch import spatial as sw

    build = mapping._build_spot_graphs
    keys = ("spatial_connectivities", "spatial_distances")

    def from_five(adata_sp, lambdas, graph_format):
        kept = {k: adata_sp.obsp[k] for k in keys}
        sw.spatial_neighbors(adata_sp, n_neighs=5)
        try:
            return build(adata_sp, lambdas, graph_format)
        finally:
            for k, v in kept.items():
                adata_sp.obsp[k] = v

    with _patched(mapping, "_build_spot_graphs", from_five):
        yield


FAULTS = {"geary_gradient": geary_gradient, "graph_vjp_untransposed": graph_vjp_untransposed,
          "islands_dropped": islands_dropped, "five_nn": five_nn}
