"""The mapping optimizer: PyTorch training loops over the fused steps.

Counterpart of ``tangram_tpu/models/mapper.py`` for single-device training
with Adam or Adafactor, in f32 or with the JAX package's low-precision
options (``param_dtype``, ``moment_dtype``, ``compute_dtype``, ``rounding``;
they apply to the fused loops, as in JAX):

* :func:`fit_mapping` — the functional core, with three loops: the fused
  loops (``ops/fused_step.py``, unconstrained and constrained: the streamed
  CUDA kernels on a CUDA tensor, their plain twins on a CPU tensor), and
  the autograd loop, which differentiates the loss through
  :func:`~tangram_tpu_torch.ops.core.mapper_core` (the kernels'
  ``MapperCore`` with its streamed backward, or the materialized reference
  core) and applies the update of ``ops/optim.py``. Each loop can
  evaluate the validation metrics after a step.
* :class:`Mapper` and :class:`MapperConstrained` — the reference-compatible
  classes (same constructor keywords for the supported options, same
  ``train()`` contract, same history keys, same seeded numpy init streams).

History stays on the device as tensors and is fetched once per print
chunk; no step waits for the device.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch

from .. import profiling
from ..ops.core import NeighborGraph, resolve_impl, softmax_row_chunks
from ..ops.cuda_core import _rowstats
from ..ops.fused_step import (
    _check_rounding,
    fused_constrained_step,
    fused_unconstrained_step,
    fused_unconstrained_step_adafactor,
    init_fused_adafactor_state,
    init_fused_opt_state,
    initial_stats,
    unconstrained_a_operand,
)
from ..ops.init_draw import legacy_normal
from ..ops.losses import (
    VAL_METRIC_KEYS,
    LossWeights,
    MapperData,
    compute_constrained_loss,
    compute_loss,
    graph_terms_on,
    spatial_local_indicators,
    val_metrics,
)
from ..ops.optim import make_adafactor, make_adam, make_optimizer
from ..ops.schedules import resolve_lr

__all__ = ["Mapper", "MapperConstrained", "fit_mapping", "init_logits",
           "make_adam", "make_adafactor"]

HISTORY_KEYS = ["total_loss", "main_loss", "vg_reg", "kl_reg", "entropy_reg"]
CONSTRAINED_HISTORY_KEYS = HISTORY_KEYS + ["count_reg", "lambda_f_reg"]
VAL_KEYS = list(VAL_METRIC_KEYS)
# the per-epoch terms fit_mapping records: the history keys plus the L1/L2
# and graph terms, which the printed score line shows but training_history
# leaves out (the JAX package's scan history carries them alike)
GRAPH_TERM_KEYS = ["gv_neighborhood_sim", "ct_island_penalty", "getis_ord_sim",
                   "moran_sim", "geary_sim"]
TERM_KEYS = HISTORY_KEYS + ["l1_reg", "l2_reg"] + GRAPH_TERM_KEYS

PRINT_NAMES = {
    "main_loss": "Gene-voxel score",
    "vg_reg": "Voxel-gene score",
    "kl_reg": "Cell densities reg",
    "entropy_reg": "Entropy reg",
    "l1_reg": "L1 reg",
    "l2_reg": "L2 reg",
    "gv_neighborhood_sim": "Spatial weighted score",
    "ct_island_penalty": "Cell type islands penalty",
    "getis_ord_sim": "Getis-Ord score",
    "moran_sim": "Moran score",
    "geary_sim": "Geary score",
}
CONSTRAINED_PRINT_NAMES = {
    "main_loss": "Score",
    "vg_reg": "VG reg",
    "kl_reg": "KL reg",
    "entropy_reg": "Entropy reg",
    "count_reg": "Count reg",
    "lambda_f_reg": "Lambda f reg",
}


def resolve_device(device) -> torch.device:
    """``None`` means ``"cuda"``, which must be available; nothing quietly
    moves to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return device


def _check_mesh(mesh, device: torch.device):
    """``mesh`` as the mapper takes it: None, or a ``DeviceMesh``
    (``tangram_tpu_torch.parallel.make_mesh``) of the mapper's device
    type."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed DeviceMesh "
                        f"(tangram_tpu_torch.parallel.make_mesh), not {type(mesh).__name__}")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh holds its blocks on {mesh.device_type!r}, the "
                         f"mapper's device is {device}")
    return mesh


def sharded_expression_init(S, G, mesh=None):
    """:func:`expression_init_logits`, each rank of ``mesh`` computing its
    block of M on the mesh's device and the blocks gathered to the host of
    every rank (the fits take the full M and keep their block), so the
    full logits never sit on one device."""
    if mesh is None:
        return expression_init_logits(S, G)
    from ..parallel.mesh import _Layout

    S = torch.as_tensor(S)
    lay = _Layout(mesh, S.shape[0], torch.as_tensor(G).shape[0])
    block = expression_init_logits(lay.cell_rows(S), torch.as_tensor(G)[lay.cols].to(lay.device))
    return lay.gather(block)


#: above this many entries of M, ``init_method="auto"`` draws on the device:
#: a host float64 draw would take 8 bytes of host RAM per entry
DEVICE_DRAW_ENTRIES = 1 << 30


def _draw_method(method: str, n_entries: int) -> str:
    """``"auto"`` resolved by size, as the JAX package does: the numpy
    stream below :data:`DEVICE_DRAW_ENTRIES`, the device draw above."""
    if method == "auto":
        return "numpy" if n_entries < DEVICE_DRAW_ENTRIES else "jax"
    if method not in ("numpy", "jax"):
        raise ValueError(
            f"unknown init method {method!r}; expected 'auto', 'numpy' or "
            "'jax' ('expression' is resolved by Mapper itself)"
        )
    return method


def _device_generator(random_state, device) -> torch.Generator:
    """A generator on ``device`` seeded as the JAX package seeds its
    ``PRNGKey``: 0 when ``random_state`` is None."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if random_state is None else int(random_state))
    return gen


def init_logits(n_cells: int, n_spots: int, random_state: Optional[int] = None,
                method: str = "numpy", dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """M ~ N(0, 1).

    ``method="numpy"`` is the reference's stream (``np.random.seed(seed)``
    only when the seed is truthy, then ``np.random.normal(0, 1, (c, s))``
    cast to f32, then to ``dtype``), so both packages start from the
    identical M; on a CUDA ``device`` it is drawn there
    (:func:`_numpy_stream`).
    ``method="jax"`` draws on ``device`` with ``torch.randn`` from a
    generator seeded like the JAX package's ``PRNGKey`` (0 for None): no
    host copy, the draw for atlas-scale M. It follows a different generator
    than JAX's, so its bits differ from the JAX package's; its moments and
    its determinism per seed are what it shares. ``"auto"`` picks numpy
    below 2^30 entries and the device draw above.

    Under :func:`~tangram_tpu_torch.profiling.record_phases` the draw is
    phase ``init_draw``, the host's casts ``init_cast`` and the copy to
    ``device`` ``init_upload`` (on the card, the state's copy).
    """
    method = _draw_method(method, n_cells * n_spots)
    if method == "jax":
        with profiling.phase("init_draw"):
            return torch.randn((n_cells, n_spots), dtype=dtype, device=device,
                               generator=_device_generator(random_state, device))
    if random_state:
        np.random.seed(seed=random_state)
    return _numpy_stream((n_cells, n_spots), dtype, device)


def _numpy_stream(shape, dtype=torch.float32, device="cpu", keep=True):
    """``np.random.normal(0, 1, shape)`` from numpy's global state, cast to
    f32 and then ``dtype``, on ``device``: drawn there by the card's kernels
    (:func:`~tangram_tpu_torch.ops.init_draw.legacy_normal`) on a CUDA
    device, else on the host, cast there and copied. Both leave numpy's
    state alike and give the same bits. ``keep=False`` draws only to move
    the state and returns None."""
    device = torch.device(device)
    if device.type == "cuda":
        return legacy_normal(shape, dtype, device, keep=keep)
    with profiling.phase("init_draw"):
        M = np.random.normal(0, 1, shape)
    if not keep:
        return None
    with profiling.phase("init_cast"):
        M = torch.from_numpy(M.astype(np.float32)).to(dtype=dtype)
    with profiling.phase("init_upload"):
        return M.to(device)


def expression_init_logits(S, G, scale=4.0, dtype=torch.float32):
    """Data-driven logits (the JAX package's extension): ``scale`` times the
    cosine between each cell's and each spot's expression over the training
    genes, one (c × g)·(g × s) ``torch.matmul`` on the tensors' device, in
    f32 (TF32 stays off, PyTorch's default)."""
    S = torch.as_tensor(S, dtype=dtype)
    G = torch.as_tensor(G, dtype=dtype, device=S.device)
    Sn = S / torch.clamp(torch.linalg.vector_norm(S, dim=1, keepdim=True), min=1e-8)
    Gn = G / torch.clamp(torch.linalg.vector_norm(G, dim=1, keepdim=True), min=1e-8)
    return scale * torch.matmul(Sn, Gn.T)


def init_constrained_logits(n_cells: int, n_spots: int,
                            random_state: Optional[int] = None,
                            method: str = "auto", device="cpu", dtype=torch.float32):
    """(M, F) of the constrained mapper. ``method="numpy"`` is the
    reference's stream (``mapping_optimizer.py:472-493``): seed (only when
    truthy), one *discarded* N(0, 1) draw of M's shape, then M, then F
    (cells,), each cast to f32 (M then to ``dtype``); each draw is made on
    ``device`` as in :func:`init_logits`, numpy's state carried from one to
    the next. ``"jax"`` draws M, then F, on ``device``
    from one generator seeded as in :func:`init_logits`; ``"auto"`` picks
    by size as there. Phases as in :func:`init_logits`."""
    if _draw_method(method, n_cells * n_spots) == "jax":
        with profiling.phase("init_draw"):
            gen = _device_generator(random_state, device)
            M = torch.randn((n_cells, n_spots), device=device, generator=gen)
            return M, torch.randn((n_cells,), device=device, generator=gen)
    if random_state:
        np.random.seed(seed=random_state)
    _numpy_stream((n_cells, n_spots), device=device, keep=False)  # discarded first draw
    M = _numpy_stream((n_cells, n_spots), dtype, device)
    return M, _numpy_stream((n_cells,), device=device)


def _warm_start_logits(adata_map) -> torch.Tensor:
    """Logits of a warm start from a mapping's probabilities:
    log(clip(adata_map.X, 1e-12)) in f32, on the host."""
    P0 = np.asarray(adata_map.X, dtype=np.float32)
    return torch.from_numpy(np.log(np.clip(P0, 1e-12, None)))


def _draw_device(method: str, n_entries: int, device, mesh=None):
    """Where the init of ``method`` is drawn: on ``device`` for the device
    draw; for the numpy stream on a CUDA ``device`` without a mesh too
    (:func:`_numpy_stream` then takes the card's kernels), else on the host
    (a mesh keeps the full M there)."""
    if _draw_method(method, n_entries) == "jax":
        return device
    return device if torch.device(device).type == "cuda" and mesh is None else "cpu"


def _draw_dtype(method: str, n_entries: int, draw_device, storage):
    """The type the start is drawn in: ``storage`` for the numpy stream on
    the card (written there in its storage type, so the card never holds
    the f32 start beside its cast), else f32 (cast later, as before)."""
    on_card = torch.device(draw_device).type == "cuda"
    return storage if on_card and _draw_method(method, n_entries) == "numpy" else torch.float32


def _lr_at(learning_rate, t: int) -> float:
    """Step ``t``'s learning rate: the constant, or entry ``t`` of the
    per-epoch vector (a host float either way: no step waits on the
    device for it)."""
    return learning_rate if np.ndim(learning_rate) == 0 else float(learning_rate[t])


def _lr_slice(learning_rate, start: int, stop: int):
    """The learning rate of epochs ``start:stop``: the constant, or that
    slice of the per-epoch vector."""
    return learning_rate if np.ndim(learning_rate) == 0 else learning_rate[start:stop]


def _check_optimizer(optimizer: str) -> str:
    make_optimizer(optimizer, 0.0)  # JAX's ValueError for any other name
    return optimizer


#: the storage and compute types the port trains in
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dtype) -> str:
    """``"float32"`` for "float32", torch.float32 or np.float32, and so on."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def _check_low_precision(rounding: str, param_dtype, moment_dtype) -> None:
    """The JAX package's checks of the rounding option (``Mapper`` and
    ``fit_mapping``): one of the two names, and with stochastic rounding
    f32 or bf16 storage."""
    if _check_rounding(rounding):
        for name, dt in (("param_dtype", param_dtype), ("moment_dtype", moment_dtype)):
            if _dtype_name(dt) not in DTYPES:
                raise ValueError(f"rounding='stochastic' supports float32/bfloat16 "
                                 f"storage; got {name}={dt!r}")


def _torch_dtype(name: str, dtype) -> torch.dtype:
    key = _dtype_name(dtype)
    if key not in DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {dtype!r}")
    return DTYPES[key]


def _fused_loop(M, opt_state, data, lw, num_epochs, learning_rate, optimizer,
                record, param_dtype, moment_dtype, compute_dtype, rounding):
    """The fused unconstrained loop. M is cast to ``param_dtype`` here (a
    new tensor when its type differs) and a fresh Adam carry takes
    ``moment_dtype``, as the JAX fused branches do; Adafactor's factor
    vectors stay f32."""
    M = M.to(param_dtype)
    if opt_state is None:
        opt_state = (init_fused_opt_state(M, moment_dtype) if optimizer == "adam"
                     else init_fused_adafactor_state(M))
    step = (fused_unconstrained_step if optimizer == "adam"
            else fused_unconstrained_step_adafactor)
    count, v1, v2 = opt_state
    stats = initial_stats(M, lw)
    # A does not move between steps: its dP-tile operand is built once
    A_op = unconstrained_a_operand(M, data, lw, compute_dtype)
    rows = []
    for t in range(num_epochs):
        M, count, v1, v2, stats, terms = step(
            M, count, v1, v2, stats, data, lw, _lr_at(learning_rate, t),
            compute_dtype=compute_dtype, rounding=rounding, A_op=A_op,
        )
        rows.append(record(terms, t, M))
    return M, (count, v1, v2), rows


def _fused_constrained_loop(params, opt_state, data, lw, num_epochs, learning_rate,
                            record, param_dtype, moment_dtype, compute_dtype,
                            rounding):
    """The fused constrained loop: M cast to ``param_dtype`` and its fresh
    moments of ``moment_dtype``; F and its moments stay f32."""
    M, F = params
    M = M.to(param_dtype)
    if opt_state is None:
        _, mu, nu = init_fused_opt_state(M, moment_dtype)
        opt_state = (0, (mu, torch.zeros_like(F)), (nu, torch.zeros_like(F)))
    count, (mu, muF), (nu, nuF) = opt_state
    stats = tuple(_rowstats(M))
    rows = []
    for t in range(num_epochs):
        (M, F), count, (mu, muF), (nu, nuF), stats, terms = fused_constrained_step(
            M, F, count, mu, nu, muF, nuF, stats, data, lw, _lr_at(learning_rate, t),
            compute_dtype=compute_dtype, rounding=rounding)
        rows.append(record(terms, t, M))
    return (M, F), (count, (mu, muF), (nu, nuF)), rows


def _autograd_loop(params, opt_state, data, lw, num_epochs, learning_rate,
                   optimizer, constrained, impl, record):
    """Autograd through :func:`mapper_core` with the resolved ``impl`` (the
    kernels' MapperCore or the materialized reference core), then the
    update of :func:`~tangram_tpu_torch.ops.optim.make_optimizer` at the
    step's learning rate, in place. Each parameter trains in its own type,
    as optax trains a pytree: a bf16 M takes its bf16 gradient from the
    core and a bf16 update."""
    params = tuple(params) if constrained else params
    loss_fn = compute_constrained_loss if constrained else compute_loss
    rows = []
    for t in range(num_epochs):
        with torch.enable_grad():
            leaves = tuple(p.detach().requires_grad_() for p in
                           (params if constrained else (params,)))
            total, terms = loss_fn(leaves if constrained else leaves[0], data, lw, impl)
            grads = torch.autograd.grad(total, leaves)
        terms = {k: v.detach() for k, v in terms.items()}
        opt_state = make_optimizer(optimizer, _lr_at(learning_rate, t)).update(
            grads if constrained else grads[0], opt_state, params)
        rows.append(record(terms, t, params[0] if constrained else params))
    return params, opt_state, rows


def _recorder(term_keys, val=None, val_each: int = 1, step_offset: int = 0):
    """``record(terms, t, *state)`` → the history row of step ``t``: the
    pre-step loss terms, then, when ``val`` is given, the validation
    metrics ``val(*state)`` of the post-step logits on the steps where
    ``(step_offset + t) % val_each == 0`` and NaN on the others (the
    reference's order and cadence). Every loop, on one device or a mesh,
    records through it."""
    def record(terms, t, *state):
        row = [terms[k] for k in term_keys]
        if val is not None:
            if (step_offset + t) % val_each == 0:
                vm = val(*state)
                row += [vm[k] for k in VAL_KEYS]
            else:
                row += [torch.full((), float("nan"), device=row[0].device)] * len(VAL_KEYS)
        return torch.stack(row)
    return record


def _history(rows, term_keys, with_val: bool, device) -> dict:
    """A loop's history from its recorded rows: each of ``term_keys`` [and
    ``VAL_KEYS``] a (num_epochs,) tensor."""
    keys = term_keys + (VAL_KEYS if with_val else [])
    table = (torch.stack(rows) if rows
             else torch.empty((0, len(keys)), device=device))
    return {k: table[:, i] for i, k in enumerate(keys)}


@torch.no_grad()
def fit_mapping(params, data: MapperData, lw: LossWeights, num_epochs: int,
                learning_rate: float = 0.1, impl: str = "auto",
                opt_state=None, return_opt_state: bool = False,
                optimizer: str = "adam", constrained: bool = False,
                fused: bool = True, with_val: bool = False,
                val_data: Optional[MapperData] = None, val_each: int = 1,
                step_offset: int = 0, moment_dtype="float32",
                compute_dtype="float32", param_dtype="float32",
                rounding: str = "nearest"):
    """Run ``num_epochs`` optimizer steps on ``params``: the logits ``M``,
    or ``(M, F)`` with ``constrained`` (F the filter logits (cells,); the
    data then needs ``target_count``). ``learning_rate`` is a constant, a
    per-epoch vector of length ``num_epochs`` or a callable ``epoch -> lr``
    (:func:`~tangram_tpu_torch.ops.schedules.resolve_lr`); step ``t`` reads
    entry ``t``.

    ``param_dtype``, ``moment_dtype`` and ``compute_dtype`` (``"float32"``
    or ``"bfloat16"``) and ``rounding`` (``"nearest"`` or
    ``"stochastic"``) are the JAX package's low-precision options, and like
    there they act on the fused loops only: M is stored in ``param_dtype``
    (the returned M keeps it), Adam's mu and nu in ``moment_dtype`` (a
    constrained F's moments and Adafactor's factors stay f32), A and dY
    enter the kernels in ``compute_dtype``, and the updates store by
    ``rounding``. The autograd loop trains M in the type it is given,
    whatever they say, as the JAX package runs optax: a bf16 M takes a
    bf16 gradient and moments and a bf16 update rounded to nearest.
    Stochastic rounding off the fused loops is a ``ValueError``.

    ``optimizer`` is ``"adam"`` (the reference's, the default) or
    ``"adafactor"`` (factored second moments: c + s floats of state instead
    of Adam's 2·c·s). ``impl`` (:func:`~tangram_tpu_torch.ops.core.resolve_impl`)
    and ``fused`` pick the loop, as in the JAX package:

    * ``"kernels"`` / ``"fused"`` with ``fused=True``: the fused step, except
      constrained + Adafactor, which has no fused step;
    * ``"kernels"`` / ``"fused"`` otherwise: autograd through the kernels'
      ``MapperCore`` (the rowstats and project kernels forward, the
      backward_rbar and dm_backward kernels backward);
    * ``"reference"``: autograd through the materialized core;
    * ``"auto"``: ``"kernels"`` on CUDA, ``"reference"`` on the CPU.

    ``opt_state`` is ``(count, mu, nu)`` for Adam or ``(count, vr, vc)``
    (vr (c,), vc (s,)) for Adafactor, fresh when ``None``; constrained, mu
    and nu are (M, F) pairs and Adafactor's carry ends with F's ``v``.
    Parameters and optimizer state are updated **in place**; keep a copy
    to reuse the start. History entries are recorded *before* each step,
    like the reference loop. With ``with_val`` the validation metrics of
    ``val_data`` (``data`` when ``None``) are evaluated on the post-step
    logits where ``(step_offset + t) % val_each == 0``, NaN elsewhere.

    Returns ``(params, history)`` or ``(params, opt_state, history)``;
    ``history`` maps each key of ``TERM_KEYS`` (``CONSTRAINED_HISTORY_KEYS``
    when constrained) [and ``VAL_KEYS``] to a (num_epochs,) tensor on M's
    device.
    """
    num_epochs = int(num_epochs)
    learning_rate = resolve_lr(learning_rate, num_epochs)
    _check_optimizer(optimizer)
    M = params[0] if constrained else params
    resolved = resolve_impl(impl, M)
    use_fused = (fused and resolved != "reference"
                 and (optimizer == "adam" or not constrained))
    if rounding == "stochastic" and not use_fused:
        # training with biased nearest rounding instead is the drift that
        # stochastic rounding exists to prevent: reject, as the JAX package
        raise ValueError(
            "rounding='stochastic' is implemented in the fused step; the "
            "autograd and reference loops store round-to-nearest. Use "
            "impl='kernels' or impl='fused' with fused=True (constrained mode "
            "with optimizer='adam'), or drop the rounding option.")
    _check_low_precision(rounding, param_dtype, moment_dtype)
    low = [_torch_dtype(name, dt) for name, dt in (
        ("param_dtype", param_dtype), ("moment_dtype", moment_dtype),
        ("compute_dtype", compute_dtype))] + [rounding]
    term_keys = CONSTRAINED_HISTORY_KEYS if constrained else TERM_KEYS
    vd = data if val_data is None else val_data

    def val(M):
        return val_metrics(M, vd.S, vd.G, vd.gene_mask, impl=resolved)

    record = _recorder(term_keys, val if with_val else None, int(val_each), int(step_offset))
    if use_fused and constrained:
        params, opt_state, rows = _fused_constrained_loop(
            params, opt_state, data, lw, num_epochs, learning_rate, record, *low)
    elif use_fused:
        params, opt_state, rows = _fused_loop(
            params, opt_state, data, lw, num_epochs, learning_rate, optimizer, record,
            *low)
    else:
        if opt_state is None:
            # the carry does not depend on the learning rate
            opt_state = make_optimizer(optimizer, 1.0).init(params)
        params, opt_state, rows = _autograd_loop(
            params, opt_state, data, lw, num_epochs, learning_rate, optimizer,
            constrained, resolved, record)
    history = _history(rows, term_keys, with_val, M.device)
    if return_opt_state:
        return params, opt_state, history
    return params, history


def _final_softmax(M) -> np.ndarray:
    """The returned mapping, softmax(M) in f32 on the host."""
    out = np.empty(tuple(M.shape), dtype=np.float32)
    for r0, P in softmax_row_chunks(M):
        out[r0:r0 + P.shape[0]] = P.cpu().numpy()
    return out


def _storage_dtype(device, impl, low_precision, fused=True) -> torch.dtype:
    """The type M is stored in on ``device``: the fused loop's
    ``param_dtype`` when training will take that loop, else f32. Rejects a
    bad impl."""
    resolved = resolve_impl(impl, torch.empty(0, device=device))
    if fused and resolved != "reference":
        return _torch_dtype("param_dtype", low_precision["param_dtype"])
    return torch.float32


def _upload_logits(M, device, dtype):
    """The logits ``M`` on ``device`` in their storage type ``dtype``: a host
    M cast on the host, so that the device never holds the f32 init beside
    the copy that the fused loop would make (the JAX package donates it).
    The cast is phase ``init_cast``, the copy ``init_upload``; a start drawn
    on the card in ``dtype`` passes through both unchanged."""
    with profiling.phase("init_cast"):
        M = M.to(dtype)
    with profiling.phase("init_upload"):
        return M.to(device)


def _print_epoch(terms_at_t, names):
    msgs = []
    for key, label in names.items():
        if key not in terms_at_t:
            continue
        v = float(terms_at_t[key])
        if np.isnan(v):
            continue
        msgs.append("{}: {:.3f}".format(label, v))
    print(", ".join(msgs))


def _train_chunked(run_chunk, params, num_epochs, learning_rate, chunk_epochs,
                   print_names, stop=None):
    """Run ``chunk_epochs``-epoch chunks with the optimizer state carried
    across (identical to one run), the learning-rate vector sliced per
    chunk, and print the first epoch of each chunk, like the reference's
    per-epoch loop. Each chunk's history is fetched to the host in one copy.
    ``run_chunk(params, opt_state, chunk, lr_chunk, epoch)`` runs ``chunk``
    epochs from absolute epoch ``epoch`` and returns ``(params, opt_state,
    history)``. ``stop(history_chunk)``, when given, ends training after a
    chunk for which it returns True. Under
    :func:`~tangram_tpu_torch.profiling.record_phases`, phase
    ``train_dispatch`` holds the host's issuing of the chunks' steps and
    ``train_execute_history`` the history fetches, which wait for the
    device to finish each chunk."""
    chunks, opt_state, epoch, keys = [], None, 0, []
    while epoch < num_epochs:
        chunk = min(int(chunk_epochs), num_epochs - epoch)
        with profiling.phase("train_dispatch"):
            params, opt_state, h = run_chunk(
                params, opt_state, chunk, _lr_slice(learning_rate, epoch, epoch + chunk),
                epoch)
        keys = list(h)
        with profiling.phase("train_execute_history"):
            table = torch.stack([h[k] for k in keys], dim=1).cpu().numpy()
        if print_names is not None:
            _print_epoch(dict(zip(keys, table[0])), print_names)
        chunks.append(table)
        epoch += chunk
        if stop is not None and stop(dict(zip(keys, table.T))):
            break
    table = np.concatenate(chunks) if chunks else np.zeros((0, 0), np.float32)
    return params, {k: table[:, i] for i, k in enumerate(keys)}


def _early_stop(tol: float):
    """The stop test of early stopping (the JAX package's
    ``Mapper._train_early_stopped``): stop after a window whose best
    gene-voxel score improves the best so far by less than ``tol``, or is
    not finite (a diverged run would otherwise train to the full budget)."""
    best = -np.inf

    def stop(history_chunk) -> bool:
        nonlocal best
        chunk_best = float(np.max(history_chunk["main_loss"]))
        if not np.isfinite(chunk_best) or chunk_best - best < tol:
            return True
        best = max(best, chunk_best)
        return False

    return stop


def _history_lists(history, keys, with_val=False, val_each=1):
    """``training_history``: a list of floats per key ([] for a key the run
    did not record), the validation keys taken every ``val_each`` epochs."""
    out = {k: [float(v) for v in history.get(k, ())] for k in keys}
    for k in VAL_KEYS:
        out[k] = [float(v) for v in history[k][::val_each]] if with_val else []
    return out


def _warn_if_diverged(training_history):
    """Warn with the first epoch whose total loss is non-finite: from there
    the optimizer state is poisoned and the mapping is unreliable."""
    vals = np.asarray(training_history.get("total_loss", ()), dtype=np.float64)
    if vals.size and not np.isfinite(vals).all():
        first = int(np.flatnonzero(~np.isfinite(vals))[0])
        logging.warning(
            "Training diverged: total_loss became non-finite at epoch %d of "
            "%d — the returned mapping is unreliable; reduce learning_rate "
            "or the regularizer weights.", first, vals.size,
        )


def _mesh_chunks(mapper, F, early_stop: bool, val_kw):
    """``(run_chunk, params)`` of a mapper's training over its mesh, with
    the JAX package's dispatch (``Mapper.train``): the fused sharded Adam
    step on a mesh with a ``"cell"`` axis, M cast to ``param_dtype``; the
    generic sharded path otherwise and for Adafactor (with a warning: it
    materializes the gradient of the block); stochastic rounding only on
    the fused path. Early stopping needs the fused path. ``F`` is the
    constrained mapper's filter logits, or None."""
    from ..parallel import fit_mapping_fused_sharded, fit_mapping_sharded

    low = mapper.low_precision
    use_fused = "cell" in mapper.mesh.mesh_dim_names
    if early_stop and not use_fused:
        raise NotImplementedError("early stopping over a mesh requires a 'cell' axis "
                                  "(the fused sharded path)")
    if early_stop and mapper.optimizer != "adam":
        raise NotImplementedError(
            f"early stopping over a mesh supports optimizer='adam' (the fused sharded "
            f"path); got {mapper.optimizer!r}. Drop early_stop_tol or the mesh.")
    if use_fused and mapper.optimizer != "adam":
        logging.warning(
            f"optimizer={mapper.optimizer!r} on a mesh runs through the generic "
            "sharded path (the fused sharded kernels implement Adam); expect its "
            "materialized gradient's higher memory traffic.")
        use_fused = False
    if low["rounding"] == "stochastic" and not use_fused:
        raise ValueError("rounding='stochastic' is implemented in the fused sharded step "
                         "(a mesh with a 'cell' axis); the generic sharded path stores "
                         "round-to-nearest.")
    constrained = F is not None
    if use_fused:
        M = mapper.M.to(_torch_dtype("param_dtype", low["param_dtype"]))
        kw = dict(mesh=mapper.mesh, moment_dtype=low["moment_dtype"],
                  compute_dtype=low["compute_dtype"], rounding=low["rounding"], **val_kw)
        fit = fit_mapping_fused_sharded
    else:
        M = mapper.M
        with_val = val_kw.get("val_data") is not None
        kw = dict(mesh=mapper.mesh, optimizer=mapper.optimizer, constrained=constrained,
                  with_val=with_val, val_data=val_kw.get("val_data"),
                  val_each=val_kw.get("val_each") or 1)
        fit = fit_mapping_sharded

    def run_chunk(params, opt_state, chunk, lr_chunk, epoch):
        return fit(params, mapper.data, mapper.lw, chunk, lr_chunk, opt_state=opt_state,
                   return_opt_state=True, step_offset=epoch, **kw)

    return run_chunk, ((M, F) if constrained else M)


class Mapper:
    """Unconstrained mapping optimizer; API-compatible with the reference
    ``Mapper`` (``mapping_optimizer.py:14-157``) for the options this port
    supports.

    The graph terms take their spot graphs as dense (spots × spots) arrays
    or :class:`~tangram_tpu_torch.ops.core.NeighborGraph`: ``voxel_weights``
    (``lambda_neighborhood_g1``), ``neighborhood_filter`` with the (cells ×
    cell types) ``ct_encode`` (``lambda_ct_islands``) and
    ``spatial_weights`` (``lambda_getis_ord``, ``lambda_moran``,
    ``lambda_geary``, whose reference indicators are computed here from the
    training genes of G). Each is put on the mapper's device in f32.

    ``device=None`` means ``"cuda"`` (raises if CUDA is absent); pass
    ``device="cpu"`` for the plain PyTorch path. ``impl``, ``optimizer``
    and the low-precision options (``moment_dtype``, ``compute_dtype``,
    ``param_dtype``, ``rounding``) are as for :func:`fit_mapping`; an
    invalid ``rounding``, or stochastic rounding of a type other than f32
    or bf16, raises here. ``train_genes_idx`` and ``val_genes_idx`` select
    the training and validation genes (columns of S and G); like the
    reference, validation scores the TRAINING genes unless
    ``emulate_reference_val_quirk=False``. ``adata_map`` warm starts M from
    the log of its mapping ``adata_map.X`` and wins over ``init_method``,
    which otherwise draws M:
    ``"auto"`` (the reference's numpy stream below 2^30 entries, the
    device draw above), ``"numpy"``, ``"jax"`` (the device draw; see
    :func:`init_logits`) or ``"expression"`` (:func:`expression_init_logits`
    over the training genes). ``mesh`` (a ``DeviceMesh`` of the mapper's
    device type, from :func:`tangram_tpu_torch.parallel.make_mesh`) trains
    sharded, every rank of the mesh constructing the mapper alike: the
    fused Adam step shard by shard on a mesh with a ``"cell"`` axis, the
    generic sharded autograd loop otherwise (and for Adafactor, with a
    warning); the full M then stays on the host and ``train`` gathers it
    there on every rank (see :mod:`tangram_tpu_torch.parallel`).
    """

    def __init__(
        self,
        S,
        G,
        train_genes_idx=None,
        val_genes_idx=None,
        d=None,
        d_source=None,
        lambda_g1=1.0,
        lambda_d=0,
        lambda_g2=0,
        lambda_r=0,
        lambda_l1=0,
        lambda_l2=0,
        lambda_neighborhood_g1=0,
        voxel_weights=None,
        lambda_getis_ord=0,
        lambda_geary=0,
        lambda_moran=0,
        neighborhood_filter=None,
        ct_encode=None,
        lambda_ct_islands=0,
        spatial_weights=None,
        device=None,
        adata_map=None,
        random_state=None,
        init_method: str = "auto",
        impl: str = "auto",
        emulate_reference_val_quirk: bool = True,
        mesh=None,
        moment_dtype: str = "float32",
        compute_dtype: str = "float32",
        param_dtype: str = "float32",
        rounding: str = "nearest",
        optimizer: str = "adam",
    ):
        self.device = resolve_device(device)
        self.mesh = _check_mesh(mesh, self.device)
        self.random_state = random_state
        self.impl = impl
        self.optimizer = _check_optimizer(optimizer)
        _check_low_precision(rounding, param_dtype, moment_dtype)
        self.low_precision = dict(moment_dtype=moment_dtype, compute_dtype=compute_dtype,
                                  param_dtype=param_dtype, rounding=rounding)
        self.lw = LossWeights(
            lambda_g1=float(lambda_g1),
            lambda_d=float(lambda_d),
            lambda_g2=float(lambda_g2),
            lambda_r=float(lambda_r),
            lambda_l1=float(lambda_l1),
            lambda_l2=float(lambda_l2),
            lambda_neighborhood_g1=float(lambda_neighborhood_g1),
            lambda_ct_islands=float(lambda_ct_islands),
            lambda_getis_ord=float(lambda_getis_ord),
            lambda_moran=float(lambda_moran),
            lambda_geary=float(lambda_geary),
        )

        def dev(x):
            if x is None:
                return None
            return torch.tensor(np.ascontiguousarray(x, dtype=np.float32),
                                device=self.device)

        S = np.asarray(S, dtype=np.float32)
        G = np.asarray(G, dtype=np.float32)

        def genes(idx):
            if idx is None:
                return dev(S), dev(G)
            idx = np.asarray(idx)
            return dev(S[:, idx]), dev(G[:, idx])

        S_train, G_train = genes(train_genes_idx)
        # Reference quirk: its _val_loss_fn scores the TRAIN split
        # (mapping_optimizer.py:321-322); pass False for a true val split
        self._val_S, self._val_G = (
            (S_train, G_train) if emulate_reference_val_quirk else genes(val_genes_idx))
        # phase graph_refs: the spot graphs' upload and the reference
        # indicators, recorded when a graph term is on
        with (profiling.phase("graph_refs") if graph_terms_on(self.lw)
              else contextlib.nullcontext()):
            W_spatial = self._to_weights(spatial_weights)
            getis_ref, moran_ref, geary_ref = spatial_local_indicators(
                G_train, W_spatial, self.lw)
            graphs = dict(voxel_weights=self._to_weights(voxel_weights),
                          neighborhood_filter=self._to_weights(neighborhood_filter),
                          ct_encode=dev(ct_encode))
        self.data = MapperData(
            S=S_train, G=G_train, d=dev(d), d_source=dev(d_source),
            spatial_weights=W_spatial, getis_ord_ref=getis_ref, moran_ref=moran_ref,
            geary_ref=geary_ref, **graphs,
        )
        storage = (None if self.mesh is not None
                   else _storage_dtype(self.device, impl, self.low_precision))
        if adata_map is not None:
            # the warm start wins over init_method: logits are the log of
            # the given mapping (softmax removes the per-row constant)
            M = _warm_start_logits(adata_map)
        elif init_method == "expression":
            M = sharded_expression_init(S_train, G_train, self.mesh)
        else:
            n_entries = S.shape[0] * G.shape[0]
            on = _draw_device(init_method, n_entries, self.device, self.mesh)
            M = init_logits(S.shape[0], G.shape[0], random_state, init_method,
                            dtype=_draw_dtype(init_method, n_entries, on, storage),
                            device=on)
        # on a mesh the full M stays on the host: each rank's fit keeps its block
        self.M = M.cpu() if self.mesh is not None else _upload_logits(M, self.device, storage)

    def _to_weights(self, W):
        """A spot graph on the mapper's device in f32: a NeighborGraph moved
        there, anything else as a dense tensor."""
        if W is None:
            return None
        if isinstance(W, NeighborGraph):
            return W.to(self.device)
        if isinstance(W, torch.Tensor):
            return W.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(W, dtype=np.float32), device=self.device)

    def train(self, num_epochs, learning_rate=0.1, print_each=100, val_each=None,
              early_stop_tol=None, early_stop_window=100):
        """Run the optimizer; returns ``(M_probs, training_history)`` like
        the reference ``Mapper.train`` (``mapping_optimizer.py:358-408``).

        Training runs in ``print_each``-epoch chunks with one score line per
        chunk. ``learning_rate`` is a constant, a per-epoch vector or a
        callable (:func:`~tangram_tpu_torch.ops.schedules.resolve_lr`). With
        ``val_each``, the validation metrics of the post-step logits are
        recorded every ``val_each`` epochs (the ``val_*`` lists of
        ``training_history``). ``early_stop_tol`` (the JAX package's
        extension) trains in ``early_stop_window``-epoch chunks instead and
        stops after a chunk that improves the best gene-voxel score by less
        than the tolerance, or whose score is not finite; the history then
        covers the epochs run. The logits are updated in place and
        ``self.M`` is bound to the trained tensor (in ``param_dtype`` after
        the fused loop). ``M_probs`` is the row softmax in f32, on the host.
        """
        num_epochs = int(num_epochs)
        learning_rate = resolve_lr(learning_rate, num_epochs)
        early_stop = early_stop_tol is not None and num_epochs > 0
        if early_stop and int(early_stop_window) <= 0:
            raise ValueError("early_stop_window must be positive")
        if print_each:
            logging.info(f"Printing scores every {print_each} epochs.")
        with_val = val_each is not None
        val_data = MapperData(S=self._val_S, G=self._val_G)

        def run_chunk(M, opt_state, chunk, lr_chunk, epoch):
            return fit_mapping(M, self.data, self.lw, chunk, lr_chunk,
                               impl=self.impl, opt_state=opt_state,
                               return_opt_state=True, optimizer=self.optimizer,
                               with_val=with_val, val_data=val_data,
                               val_each=int(val_each) if with_val else 1,
                               step_offset=epoch, **self.low_precision)

        params = self.M
        if self.mesh is not None:
            run_chunk, params = _mesh_chunks(self, None, early_stop, dict(
                val_data=val_data if with_val else None,
                val_each=int(val_each) if with_val else None))
        if early_stop:
            chunk_epochs, stop = int(early_stop_window), _early_stop(float(early_stop_tol))
        else:
            chunk_epochs, stop = (print_each if print_each else max(num_epochs, 1)), None
        self.M, history = _train_chunked(
            run_chunk, params, num_epochs, learning_rate, chunk_epochs,
            PRINT_NAMES if print_each else None, stop=stop,
        )
        epochs_run = len(history.get("main_loss", ()))
        if early_stop and epochs_run < num_epochs:
            logging.info(
                f"Early stopping at epoch {epochs_run}: gene-voxel score "
                f"improved < {early_stop_tol} over the last "
                f"{early_stop_window}-epoch window.")
        training_history = _history_lists(history, HISTORY_KEYS, with_val,
                                           int(val_each) if with_val else 1)
        _warn_if_diverged(training_history)
        with profiling.phase("mapping_fetch"):
            output = _final_softmax(self.M)
        return output, training_history


class MapperConstrained:
    """Constrained (filtered) mapping optimizer; API-compatible with the
    reference ``MapperConstrained`` (``mapping_optimizer.py:411-493``) on
    one device. It learns the logits M and a per-cell filter F; the loss
    adds a count term pulling Σσ(F) to ``target_count`` (the number of
    spots by default) and a term pushing σ(F) to 0 or 1.

    ``device``, ``impl``, ``optimizer`` and the low-precision options are
    as for :class:`Mapper`; with Adam the kernels run the fused constrained
    step (M in ``param_dtype``, its moments in ``moment_dtype``, F and its
    moments f32), with Adafactor the autograd loop through the kernels'
    ``MapperCore`` (f32; stochastic rounding raises). ``init_method`` is
    as for :class:`Mapper`. ``adata_map`` warm starts M from the log of its
    mapping (F is still drawn N(0, 1)). ``mesh`` trains sharded as for
    :class:`Mapper`, F split by cells.
    Training-history values are floats (the reference stringifies them,
    ``mapping_optimizer.py:630``).
    """

    def __init__(
        self,
        S,
        G,
        d,
        lambda_d=1,
        lambda_g1=1,
        lambda_g2=1,
        lambda_r=0,
        lambda_count=1,
        lambda_f_reg=1,
        target_count=None,
        device=None,
        adata_map=None,
        random_state=None,
        init_method: str = "auto",
        impl: str = "auto",
        mesh=None,
        moment_dtype: str = "float32",
        compute_dtype: str = "float32",
        param_dtype: str = "float32",
        rounding: str = "nearest",
        optimizer: str = "adam",
    ):
        self.device = resolve_device(device)
        self.mesh = _check_mesh(mesh, self.device)
        self.random_state = random_state
        self.impl = impl
        self.optimizer = _check_optimizer(optimizer)
        _check_low_precision(rounding, param_dtype, moment_dtype)
        self.low_precision = dict(moment_dtype=moment_dtype, compute_dtype=compute_dtype,
                                  param_dtype=param_dtype, rounding=rounding)
        S = np.asarray(S, dtype=np.float32)
        G = np.asarray(G, dtype=np.float32)
        n_cells, n_spots = S.shape[0], G.shape[0]
        if target_count is None:
            target_count = n_spots
        self.lw = LossWeights(
            lambda_g1=float(lambda_g1),
            lambda_d=float(lambda_d),
            lambda_g2=float(lambda_g2),
            lambda_r=float(lambda_r),
            lambda_count=float(lambda_count),
            lambda_f_reg=float(lambda_f_reg),
        )

        def dev(x):
            return torch.tensor(np.asarray(x, dtype=np.float32), device=self.device)

        self.data = MapperData(
            S=dev(S), G=dev(G), d=None if d is None else dev(d),
            target_count=dev(np.float32(target_count)),
        )
        n_entries = n_cells * n_spots
        storage = (None if self.mesh is not None
                   else _storage_dtype(self.device, impl, self.low_precision,
                                       fused=self.optimizer == "adam"))
        if adata_map is not None:
            # the warm start wins over an expression request; F is drawn by
            # the method M would have been drawn by
            M = _warm_start_logits(adata_map)
            method = _draw_method("auto" if init_method == "expression" else init_method,
                                  n_entries)
            F = init_logits(1, n_cells, random_state, method,
                            device=_draw_device(method, n_entries, self.device, self.mesh))[0]
        elif init_method == "expression":
            # F keeps the reference's N(0, 1) draw, so the filter starts unbiased
            M = sharded_expression_init(self.data.S, self.data.G, self.mesh)
            F = init_logits(1, n_cells, random_state, "auto")[0]
        else:
            on = _draw_device(init_method, n_entries, self.device, self.mesh)
            M, F = init_constrained_logits(
                n_cells, n_spots, random_state, init_method, device=on,
                dtype=_draw_dtype(init_method, n_entries, on, storage))
        if self.mesh is not None:
            self.M, self.F = M.cpu(), F.cpu()
        else:
            with profiling.phase("init_upload"):
                self.F = F.to(self.device)
            self.M = _upload_logits(M, self.device, storage)

    def train(self, num_epochs, learning_rate=0.1, print_each=100):
        """Returns ``(M_probs, F_probs, training_history)`` like the
        reference ``MapperConstrained.train``, in ``print_each``-epoch chunks
        with one score line per chunk, the learning rate as for
        :meth:`Mapper.train`; M and F are updated in place."""
        num_epochs = int(num_epochs)
        learning_rate = resolve_lr(learning_rate, num_epochs)

        def run_chunk(params, opt_state, chunk, lr_chunk, epoch):
            del epoch
            return fit_mapping(params, self.data, self.lw, chunk, lr_chunk,
                               impl=self.impl, opt_state=opt_state,
                               return_opt_state=True, optimizer=self.optimizer,
                               constrained=True, **self.low_precision)

        params = (self.M, self.F)
        if self.mesh is not None:
            run_chunk, params = _mesh_chunks(self, self.F, False, {})
        (self.M, self.F), history = _train_chunked(
            run_chunk, params, num_epochs, learning_rate,
            print_each if print_each else max(num_epochs, 1),
            CONSTRAINED_PRINT_NAMES if print_each else None,
        )
        training_history = {k: [float(v) for v in history.get(k, ())]
                            for k in CONSTRAINED_HISTORY_KEYS}
        _warn_if_diverged(training_history)
        with profiling.phase("mapping_fetch"):
            output = _final_softmax(self.M)
        F_out = torch.sigmoid(self.F).cpu().numpy()
        return output, F_out, training_history
