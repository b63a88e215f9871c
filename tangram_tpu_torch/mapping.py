"""User API: preprocessing and the main mapping entry point.

Counterpart of ``tangram_tpu/mapping.py`` (``pp_adatas`` ref
mapping_utils.py:20, ``adata_to_cluster_expression`` ref
mapping_utils.py:103, ``map_cells_to_space`` ref mapping_utils.py:141):
AnnData in, AnnData out, feeding the PyTorch training engine in
:mod:`tangram_tpu_torch.models.mapper`. ``cells``, ``clusters`` and
``constrained`` modes with Adam or Adafactor, the L1/L2 terms, the five
graph terms on dense or k-NN spot graphs (cells and clusters modes), f32
or bf16 storage with round-to-nearest or stochastic rounding,
learning-rate schedules, early stopping, every ``init_method`` and
training over a ``mesh`` (``tangram_tpu_torch.parallel``) are ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import pandas as pd
import scipy.sparse as sp

from . import adlite, profiling
from . import spatial as sw
from .models.mapper import Mapper, MapperConstrained
from .utils import annotate_gene_sparsity, one_hot_encoding

__all__ = ["pp_adatas", "adata_to_cluster_expression", "map_cells_to_space"]

_MODES = ("cells", "clusters", "constrained")


def _densify(X) -> np.ndarray:
    if sp.issparse(X) or (hasattr(X, "toarray") and not isinstance(X, np.ndarray)):
        return np.asarray(X.toarray(), dtype="float32")
    if isinstance(X, np.ndarray):
        return np.asarray(X, dtype="float32")
    raise NotImplementedError(f"AnnData X has unrecognized type: {type(X)}")


def pp_adatas(adata_sc, adata_sp, genes=None, gene_to_lowercase=True):
    """Prepare a single-cell / spatial AnnData pair for mapping
    (ref mapping_utils.py:20-100).

    Drops never-expressed genes, optionally lowercases gene names, records
    the shared gene vocabulary (``uns['training_genes']`` = requested ∩ sc ∩
    sp in the requested order, the same in every process;
    ``uns['overlap_genes']`` = sorted sc ∩ sp), writes both density
    priors on the spatial side, and — when coordinates exist — the spot
    neighbor graph into ``obsp``.
    """
    for adata in (adata_sc, adata_sp):
        adlite.filter_genes(adata, min_cells=1)

    requested = list(adata_sc.var.index if genes is None else genes)

    if gene_to_lowercase:
        adata_sc.var.index = [g.lower() for g in adata_sc.var.index]
        adata_sp.var.index = [g.lower() for g in adata_sp.var.index]
        requested = [g.lower() for g in requested]

    adata_sc.var_names_make_unique()
    adata_sp.var_names_make_unique()

    shared = set(adata_sc.var.index) & set(adata_sp.var.index)
    # in the requested order: the reference's list(set(...)) takes a set's
    # iteration order, which moves with PYTHONHASHSEED from one process to
    # the next, and with it the order of S's and G's columns and so every
    # sum over genes
    training_genes = [g for g in dict.fromkeys(requested) if g in shared]
    overlap_genes = sorted(shared)

    for adata in (adata_sc, adata_sp):
        adata.uns["training_genes"] = training_genes
        adata.uns["overlap_genes"] = overlap_genes
    logging.info(
        f"wrote {len(training_genes)} uns['training_genes'] and "
        f"{len(overlap_genes)} uns['overlap_genes'] to both AnnDatas"
    )

    n_spots = adata_sp.X.shape[0]
    adata_sp.obs["uniform_density"] = np.full(n_spots, 1.0 / n_spots)

    spot_counts = np.asarray(adata_sp.X.sum(axis=1)).squeeze()
    adata_sp.obs["rna_count_based_density"] = spot_counts / spot_counts.sum()
    logging.info(
        "wrote obs['uniform_density'] and obs['rna_count_based_density'] "
        "priors to the spatial AnnData"
    )

    if "spatial" in adata_sp.obsm:
        sw.spatial_neighbors(adata_sp, set_diag=False)
        logging.info(
            "built obsp['spatial_connectivities'/'spatial_distances'] "
            "neighbor graphs from obsm['spatial']"
        )


def adata_to_cluster_expression(adata, cluster_label, scale=True, add_density=True):
    """Collapse an AnnData to one observation per cluster
    (ref mapping_utils.py:103-139) with a single indicator-matrix product
    (cluster sums when ``scale`` else means); ``obs['cluster_density']``
    records each cluster's cell share.
    """
    try:
        shares = adata.obs[cluster_label].value_counts(normalize=True)
    except KeyError:
        raise ValueError("Provided label must belong to adata.obs.")

    clusters = list(shares.index)
    codes = pd.Series(np.asarray(adata.obs[cluster_label])).map(
        {c: i for i, c in enumerate(clusters)}
    ).to_numpy()
    # unlabeled cells (NaN / missing category) are excluded from every
    # cluster aggregate, like the reference's groupby-based aggregation
    labeled = ~pd.isna(codes)
    indicator = sp.csr_matrix(
        (np.ones(int(labeled.sum())),
         (codes[labeled].astype(np.int64), np.nonzero(labeled)[0])),
        shape=(len(clusters), adata.shape[0]),
    )
    summed = indicator @ adata.X
    if sp.issparse(summed) or hasattr(summed, "toarray"):
        summed = summed.toarray()
    summed = np.asarray(summed, dtype=np.float64)
    if not scale:
        summed /= np.asarray(indicator.sum(axis=1))

    aggregated = adlite.AnnData(
        X=summed,
        obs=pd.DataFrame({cluster_label: clusters}),
        var=adata.var.copy(),
        uns=dict(adata.uns),
    )
    if add_density:
        aggregated.obs["cluster_density"] = [shares[c] for c in clusters]
    return aggregated


@dataclass
class _DensityPrior:
    """Resolved density target: spot prior ``d``, cluster source masses
    ``d_source`` (clusters mode), display label, effective ``lambda_d``."""

    d: np.ndarray | None
    d_source: np.ndarray | None
    label: str
    lambda_d: float


def _check_mapping_args(
    mode, lambda_g1, lambda_d, density_prior, cluster_label,
    target_count, lambda_f_reg, lambda_count,
):
    """Argument validation (ref mapping_utils.py:205-229). Returns the
    effective lambda_d (a set prior implies lambda_d=1)."""
    if lambda_g1 == 0:
        raise ValueError("lambda_g1 cannot be 0.")
    known_priors = ("rna_count_based", "uniform", None)
    if isinstance(density_prior, str) and density_prior not in known_priors:
        raise ValueError("Invalid input for density_prior.")
    if density_prior is not None and not lambda_d:
        lambda_d = 1
    if lambda_d > 0 and density_prior is None:
        raise ValueError("When lambda_d is set, please define the density_prior.")
    if mode not in _MODES:
        raise ValueError('Argument "mode" must be "cells", "clusters" or "constrained')
    if mode == "clusters" and cluster_label is None:
        raise ValueError("A cluster_label must be specified if mode is 'clusters'.")
    if mode == "constrained" and not all([target_count, lambda_f_reg, lambda_count]):
        raise ValueError(
            "target_count, lambda_f_reg and lambda_count must be specified if mode is 'constrained'."
        )
    return lambda_d


def _resolve_training_genes(adata_sc, adata_sp, cv_train_genes):
    for adata in (adata_sc, adata_sp):
        if not {"training_genes", "overlap_genes"} <= set(adata.uns.keys()):
            raise ValueError("Missing tangram parameters. Run `pp_adatas()`.")
    assert list(adata_sp.uns["training_genes"]) == list(adata_sc.uns["training_genes"])

    if cv_train_genes is None:
        return adata_sc.uns["training_genes"]
    if not set(cv_train_genes).issubset(set(adata_sc.uns["training_genes"])):
        raise ValueError("Given training genes list should be subset of two AnnDatas.")
    return cv_train_genes


def _resolve_density(mode, density_prior, lambda_d, adata_sc, adata_sp):
    """Turn the user's prior spec into concrete vectors
    (ref mapping_utils.py:282-307)."""
    label = "customized" if isinstance(density_prior, np.ndarray) else density_prior
    if isinstance(density_prior, str):
        density_prior = adata_sp.obs[f"{density_prior}_density"]

    d = density_prior if mode == "cells" else None
    d_source = None

    if mode == "clusters":
        d_source = np.asarray(adata_sc.obs["cluster_density"])

    if mode in ("clusters", "constrained"):
        if density_prior is None:
            d, label = adata_sp.obs["uniform_density"], "uniform"
        else:
            d = density_prior
        if not lambda_d:
            lambda_d = 1

    if d is not None:
        d = np.asarray(d, dtype=np.float32)
    return _DensityPrior(d=d, d_source=d_source, label=label, lambda_d=lambda_d)


# Spot-graph recipes per regularizer family: slot name → (standardized,
# self_inclusion) of the weight-matrix variant that family uses. Listed in
# reference order (ref mapping_utils.py:317-329) so that when both the
# Moran/Geary and Getis-Ord families are on, the Getis-Ord variant wins
# their shared "spatial_weights" slot: a reference quirk kept on purpose.
_GRAPH_RECIPES = (
    ("voxel_weights", "lambda_neighborhood_g1", True, True),
    ("neighborhood_filter", "lambda_ct_islands", False, False),
    ("spatial_weights", "lambda_moran|lambda_geary", True, False),
    ("spatial_weights", "lambda_getis_ord", False, True),
)


def _build_spot_graphs(adata_sp, lambdas, graph_format):
    """Each weight-matrix variant the graph terms need, built once: a
    ``NeighborGraph`` with ``graph_format="knn"``, a dense float64 array
    otherwise."""
    build = sw.neighbor_graph if graph_format == "knn" else sw.spatial_weights
    graphs = {"voxel_weights": None, "neighborhood_filter": None, "spatial_weights": None}
    for slot, trigger, standardized, self_inclusion in _GRAPH_RECIPES:
        if any(lambdas[name] > 0 for name in trigger.split("|")):
            graphs[slot] = build(
                adata_sp, standardized=standardized, self_inclusion=self_inclusion
            )
    return graphs


def _train_gene_report(M_logits, S, G, training_genes, adata_sc, adata_sp):
    """Per-gene training cosine scores + sparsity columns
    (ref mapping_utils.py:401-424). The projection recomputes the softmax
    from the trained logits where they live and fetches only the
    (spots × genes) result."""
    from .evaluation import _column_cosine, projected_expression_from_logits

    G_pred = projected_expression_from_logits(M_logits, S)
    report = pd.DataFrame(
        {"train_score": _column_cosine(G_pred, G)}, index=training_genes
    )
    report = report.sort_values(by="train_score", ascending=False)

    for adata in (adata_sc, adata_sp):
        annotate_gene_sparsity(adata)
    report["sparsity_sc"] = adata_sc[:, training_genes].var.sparsity
    report["sparsity_sp"] = adata_sp[:, training_genes].var.sparsity
    report["sparsity_diff"] = report["sparsity_sp"] - report["sparsity_sc"]
    return report


def map_cells_to_space(
    adata_sc,
    adata_sp,
    cv_train_genes=None,
    cluster_label=None,
    mode="cells",
    device=None,
    learning_rate=0.1,
    num_epochs=1000,
    scale=True,
    lambda_d=0,
    lambda_g1=1,
    lambda_g2=0,
    lambda_r=0,
    lambda_l1=0,
    lambda_l2=0,
    lambda_count=1,
    lambda_f_reg=1,
    target_count=None,
    lambda_neighborhood_g1=0,
    lambda_ct_islands=0,
    lambda_getis_ord=0,
    lambda_moran=0,
    lambda_geary=0,
    random_state=None,
    verbose=True,
    density_prior="rna_count_based",
    impl="auto",
    init_method="auto",
    graph_format="dense",
    mesh=None,
    moment_dtype="float32",
    compute_dtype="float32",
    param_dtype="float32",
    rounding="nearest",
    optimizer="adam",
    early_stop_tol=None,
    early_stop_window=100,
):
    """Learn the probabilistic cell→spot mapping (ref mapping_utils.py:141).

    Returns a cell-by-spot AnnData carrying the mapping probabilities,
    per-gene training scores in ``uns['train_genes_df']`` and the full
    ``uns['training_history']``.

    ``device=None`` means ``"cuda"`` and raises if CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch path. ``impl`` picks the
    training loop (``"auto"``: the CUDA kernels on the card, the
    materialized reference loop on the CPU; see
    :func:`tangram_tpu_torch.ops.core.resolve_impl`). ``optimizer`` is
    ``"adam"`` (the reference's) or ``"adafactor"`` (factored second
    moments: c + s floats of optimizer state instead of 2·c·s). In
    ``constrained`` mode the result's ``obs['F_out']`` holds each cell's
    learned filter probability.

    ``param_dtype``, ``moment_dtype`` and ``compute_dtype``
    (``"float32"`` or ``"bfloat16"``) and ``rounding`` (``"nearest"`` or
    ``"stochastic"``) act on the fused loops, as in the JAX package: bf16
    logits and Adam moments halve the training state, and stochastic
    rounding keeps their updates unbiased. The autograd and reference loops
    train in f32, and stochastic rounding there raises ``ValueError``. The
    returned mapping is f32 either way.

    ``mesh`` (a ``DeviceMesh`` from
    :func:`tangram_tpu_torch.parallel.make_mesh`, of ``device``'s type)
    trains sharded over the mesh's processes, each calling this function
    with the same arguments (``torchrun``; see
    :class:`~tangram_tpu_torch.models.mapper.Mapper`); every rank returns
    the whole mapping.

    The graph terms (``lambda_neighborhood_g1``, ``lambda_ct_islands``,
    ``lambda_getis_ord``, ``lambda_moran``, ``lambda_geary``; each on where
    > 0) need the spot graph that ``pp_adatas`` writes from
    ``obsm["spatial"]``; the cell-type islands also need ``cluster_label``.
    They act in cells and clusters modes; constrained mode ignores them, as
    the JAX package does. ``graph_format="knn"`` keeps the spot graphs in
    the structured (spots × neighbors) form, any other value as dense
    spots × spots matrices.

    ``learning_rate`` also takes a per-epoch vector or a callable (e.g.
    :func:`~tangram_tpu_torch.ops.schedules.cosine_lr`);
    ``early_stop_tol``/``early_stop_window`` stop training once a window
    improves the gene-voxel score by less than the tolerance (not in
    constrained mode); ``init_method`` is ``"auto"``, ``"numpy"``,
    ``"jax"`` (drawn on the device) or ``"expression"``
    (:class:`~tangram_tpu_torch.models.mapper.Mapper`).
    """
    lambda_d = _check_mapping_args(
        mode, lambda_g1, lambda_d, density_prior, cluster_label,
        target_count, lambda_f_reg, lambda_count,
    )
    if mode == "constrained" and early_stop_tol is not None:
        # before the constructor draws the (cells × spots) init
        raise ValueError(
            "early_stop_tol is not supported in constrained mode (the "
            "count/filter penalties keep moving the score target)"
        )
    low_precision = dict(moment_dtype=moment_dtype, compute_dtype=compute_dtype,
                         param_dtype=param_dtype, rounding=rounding)

    if mode == "clusters":
        adata_sc = adata_to_cluster_expression(
            adata_sc, cluster_label, scale, add_density=True
        )

    training_genes = _resolve_training_genes(adata_sc, adata_sp, cv_train_genes)

    with profiling.phase("preprocess"):
        S = _densify(adata_sc[:, training_genes].X)
        G = _densify(adata_sp[:, training_genes].X)
    if not S.any(axis=0).all() or not G.any(axis=0).all():
        raise ValueError("Genes with all zero values detected. Run `pp_adatas()`.")

    prior = _resolve_density(mode, density_prior, lambda_d, adata_sc, adata_sp)
    print_each = 100 if verbose else None
    logging.info(
        f"training: {len(training_genes)} genes, prior={prior.label}, mode={mode}"
    )

    if mode == "constrained":
        with profiling.phase("mapper_init"):
            mapper = MapperConstrained(
                S=S,
                G=G,
                d=prior.d,
                device=device,
                random_state=random_state,
                lambda_d=prior.lambda_d,
                lambda_g1=lambda_g1,
                lambda_g2=lambda_g2,
                lambda_r=lambda_r,
                lambda_count=lambda_count,
                lambda_f_reg=lambda_f_reg,
                target_count=target_count,
                impl=impl,
                init_method=init_method,
                mesh=mesh,
                optimizer=optimizer,
                **low_precision,
            )
        mapping_matrix, F_out, training_history = mapper.train(
            learning_rate=learning_rate, num_epochs=num_epochs, print_each=print_each,
        )
    else:
        lambdas = {
            "lambda_neighborhood_g1": lambda_neighborhood_g1,
            "lambda_ct_islands": lambda_ct_islands,
            "lambda_getis_ord": lambda_getis_ord,
            "lambda_moran": lambda_moran,
            "lambda_geary": lambda_geary,
        }
        graphs = _build_spot_graphs(adata_sp, lambdas, graph_format)

        ct_encode = None
        if lambda_ct_islands > 0:
            if cluster_label not in adata_sc.obs.keys():
                raise ValueError(
                    "cluster_label must be specified for the cell type island extension."
                )
            ct_encode = one_hot_encoding(adata_sc.obs[cluster_label]).values

        with profiling.phase("mapper_init"):
            mapper = Mapper(
                S=S,
                G=G,
                d=prior.d,
                d_source=prior.d_source,
                device=device,
                random_state=random_state,
                lambda_d=prior.lambda_d,
                lambda_g1=lambda_g1,
                lambda_g2=lambda_g2,
                lambda_r=lambda_r,
                lambda_l1=lambda_l1,
                lambda_l2=lambda_l2,
                lambda_neighborhood_g1=lambda_neighborhood_g1,
                voxel_weights=graphs["voxel_weights"],
                lambda_ct_islands=lambda_ct_islands,
                neighborhood_filter=graphs["neighborhood_filter"],
                ct_encode=ct_encode,
                lambda_getis_ord=lambda_getis_ord,
                lambda_moran=lambda_moran,
                lambda_geary=lambda_geary,
                spatial_weights=graphs["spatial_weights"],
                impl=impl,
                init_method=init_method,
                mesh=mesh,
                optimizer=optimizer,
                **low_precision,
            )
        del graphs  # the mapper holds its own f32 copies on its device
        mapping_matrix, training_history = mapper.train(
            learning_rate=learning_rate, num_epochs=num_epochs, print_each=print_each,
            early_stop_tol=early_stop_tol, early_stop_window=early_stop_window,
        )

    adata_map = adlite.AnnData(
        X=mapping_matrix,
        obs=adata_sc[:, training_genes].obs.copy(),
        var=adata_sp[:, training_genes].obs.copy(),
    )
    if mode == "constrained":
        adata_map.obs["F_out"] = F_out
    with profiling.phase("gene_report"):
        adata_map.uns["train_genes_df"] = _train_gene_report(
            mapper.M, S, G, training_genes, adata_sc, adata_sp,
        )
    adata_map.uns["training_history"] = training_history
    return adata_map
