"""The mapping optimizer: a PyTorch training loop over the fused step.

Counterpart of ``tangram_tpu/models/mapper.py`` for the unconstrained
mapper with Adam or Adafactor and f32 storage:

* :func:`fit_mapping` — the functional core, with two loops: the fused loop
  (``ops/fused_step.py``: the streamed CUDA kernels on a CUDA tensor, their
  plain twins on a CPU tensor) and the reference loop (autograd through the
  materialized core plus the optimizer update written out).
* :class:`Mapper` — the reference-compatible class (same constructor
  keywords for the supported options, same ``train()`` contract, same
  history keys, same seeded N(0, 1) numpy init stream).

History stays on the device as tensors and is fetched once per print
chunk; no step waits for the device.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..ops.core import resolve_impl, unported
from ..ops.fused_step import (
    ADAFACTOR_EPS,
    ADAM_EPS,
    BETA1,
    BETA2,
    adafactor_decay,
    adam_scalars,
    fused_unconstrained_step,
    fused_unconstrained_step_adafactor,
    init_fused_adafactor_state,
    init_fused_opt_state,
    initial_stats,
)
from ..ops.losses import LossWeights, MapperData, check_supported, compute_loss

__all__ = ["Mapper", "fit_mapping", "init_logits", "resolve_device",
           "adafactor_update"]

HISTORY_KEYS = ["total_loss", "main_loss", "vg_reg", "kl_reg", "entropy_reg"]
VAL_KEYS = ["val_total_loss", "val_gene_sim", "val_sp_sparsity_weighted_sim",
            "val_entropy"]
# the per-epoch terms fit_mapping records: the history keys plus the L1/L2
# terms, which the printed score line shows but training_history leaves out
TERM_KEYS = HISTORY_KEYS + ["l1_reg", "l2_reg"]
OPTIMIZERS = ("adam", "adafactor")

PRINT_NAMES = {
    "main_loss": "Gene-voxel score",
    "vg_reg": "Voxel-gene score",
    "kl_reg": "Cell densities reg",
    "entropy_reg": "Entropy reg",
    "l1_reg": "L1 reg",
    "l2_reg": "L2 reg",
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


def init_logits(n_cells: int, n_spots: int, random_state: Optional[int] = None,
                device="cpu") -> torch.Tensor:
    """M ~ N(0, 1) from the reference's numpy stream
    (``np.random.seed(seed)`` only when the seed is truthy, then
    ``np.random.normal(0, 1, (c, s))`` cast to f32), so both packages start
    from the identical M."""
    if random_state:
        np.random.seed(seed=random_state)
    M = np.random.normal(0, 1, (n_cells, n_spots)).astype(np.float32)
    return torch.from_numpy(M).to(device)


def _check_lr(learning_rate) -> float:
    if np.ndim(learning_rate) != 0 or callable(learning_rate):
        raise unported("a learning-rate schedule",
                       "queue A6 (schedules and early stop)")
    return float(learning_rate)


def _check_optimizer(optimizer: str) -> str:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f'optimizer must be "adam" or "adafactor", got {optimizer!r}')
    return optimizer


def _fused_loop(M, opt_state, data, lw, num_epochs, learning_rate, optimizer):
    step = (fused_unconstrained_step if optimizer == "adam"
            else fused_unconstrained_step_adafactor)
    count, v1, v2 = opt_state
    stats = initial_stats(M, lw)
    rows = []
    for _ in range(num_epochs):
        M, count, v1, v2, stats, terms = step(
            M, count, v1, v2, stats, data, lw, learning_rate
        )
        rows.append(torch.stack([terms[k] for k in TERM_KEYS]))
    return M, (count, v1, v2), rows


def _adam_update(M, g, count, mu, nu, learning_rate):
    """Adam written out as the JAX package's ``_adam_vector`` does, in place
    on M, mu and nu; ``count`` is the incremented step."""
    lr, bc1, bc2 = adam_scalars(count, learning_rate)
    mu.copy_(BETA1 * mu + (1.0 - BETA1) * g)
    nu.copy_(BETA2 * nu + (1.0 - BETA2) * (g * g))
    M.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
    return mu, nu


def adafactor_update(M, g, count: int, vr, vc, learning_rate: float):
    """optax ``adafactor`` as ``tangram_tpu.models.mapper.make_adafactor``
    configures it (factored second moments, no momentum, no clipping, no
    parameter scale, ``min_dim_size_to_factor=2``), written out on a
    materialized gradient ``g`` and applied to M in place. ``count`` is the
    pre-increment step; ``vr`` (c,) and ``vc`` (s,) are the carried
    statistics, returned updated. Follows optax's orientation: the statistic
    on the smaller axis is divided by its mean, and the update multiplies
    the factor of that axis first."""
    c, s = M.shape
    decay, one_minus = adafactor_decay(count)
    grad_sqr = g * g + ADAFACTOR_EPS
    vr = decay * vr + one_minus * grad_sqr.mean(dim=1)
    vc = decay * vc + one_minus * grad_sqr.mean(dim=0)
    if s >= c:
        u = g * ((vr / vr.mean()) ** -0.5)[:, None] * (vc ** -0.5)[None, :]
    else:
        u = g * ((vc / vc.mean()) ** -0.5)[None, :] * (vr ** -0.5)[:, None]
    M.sub_(float(np.float32(learning_rate)) * u)
    return vr, vc


def _reference_loop(M, opt_state, data, lw, num_epochs, learning_rate, optimizer):
    """Autograd through the materialized core, then the optimizer update
    written out (:func:`_adam_update` or :func:`adafactor_update`)."""
    count, v1, v2 = opt_state
    rows = []
    for _ in range(num_epochs):
        with torch.enable_grad():
            Mv = M.detach().requires_grad_()
            total, terms = compute_loss(Mv, data, lw)
            (g,) = torch.autograd.grad(total, (Mv,))
        rows.append(torch.stack([terms[k].detach() for k in TERM_KEYS]))
        if optimizer == "adam":
            v1, v2 = _adam_update(M, g, count + 1, v1, v2, learning_rate)
        else:
            v1, v2 = adafactor_update(M, g, count, v1, v2, learning_rate)
        count += 1
    return M, (count, v1, v2), rows


@torch.no_grad()
def fit_mapping(M, data: MapperData, lw: LossWeights, num_epochs: int,
                learning_rate: float = 0.1, impl: str = "auto",
                opt_state=None, return_opt_state: bool = False,
                optimizer: str = "adam"):
    """Run ``num_epochs`` optimizer steps on the logits ``M``.

    ``optimizer`` is ``"adam"`` (the reference's, the default) or
    ``"adafactor"`` (factored second moments: c + s floats of state instead
    of Adam's 2·c·s). ``impl`` picks the loop
    (:func:`~tangram_tpu_torch.ops.core.resolve_impl`): ``"kernels"`` /
    ``"fused"`` run the fused step, ``"reference"`` the materialized
    autograd loop, ``"auto"`` the kernels on CUDA and the reference loop on
    the CPU.

    ``opt_state`` is ``(count, mu, nu)`` for Adam or ``(count, vr, vc)``
    (vr (c,), vc (s,)) for Adafactor, fresh when ``None``. M and Adam's
    mu/nu are updated **in place**; keep a copy to reuse the start. History
    entries are recorded *before* each step, like the reference loop.
    Returns ``(M, history)`` or ``(M, opt_state, history)``, where
    ``history`` maps each key of ``TERM_KEYS`` to a (num_epochs,) tensor on
    M's device.
    """
    check_supported(lw)
    learning_rate = _check_lr(learning_rate)
    _check_optimizer(optimizer)
    resolved = resolve_impl(impl, M)
    if M.dtype != torch.float32:
        raise unported(f"param dtype {M.dtype}", "queue A4 (bf16 and stochastic rounding)")
    if opt_state is None:
        opt_state = (init_fused_opt_state(M) if optimizer == "adam"
                     else init_fused_adafactor_state(M))
    loop = _reference_loop if resolved == "reference" else _fused_loop
    M, opt_state, rows = loop(M, opt_state, data, lw, int(num_epochs),
                              learning_rate, optimizer)
    table = (torch.stack(rows) if rows
             else torch.empty((0, len(TERM_KEYS)), device=M.device))
    history = {k: table[:, i] for i, k in enumerate(TERM_KEYS)}
    if return_opt_state:
        return M, opt_state, history
    return M, history


def _final_softmax(M):
    return torch.softmax(M, dim=1)


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


def _train_chunked(run_chunk, M, num_epochs, print_each, print_names):
    """Run ``print_each``-epoch chunks with the optimizer state carried
    across (identical to one run) and print the first epoch of each chunk,
    like the reference's per-epoch loop. Each chunk's history is fetched to
    the host in one copy. ``run_chunk(M, opt_state, chunk)`` returns
    ``(M, opt_state, history)``."""
    chunks, opt_state, epoch = [], None, 0
    while epoch < num_epochs:
        chunk = min(int(print_each), num_epochs - epoch)
        M, opt_state, h = run_chunk(M, opt_state, chunk)
        table = torch.stack([h[k] for k in TERM_KEYS], dim=1).cpu().numpy()
        if print_names is not None:
            _print_epoch(dict(zip(TERM_KEYS, table[0])), print_names)
        chunks.append(table)
        epoch += chunk
    table = (np.concatenate(chunks) if chunks
             else np.zeros((0, len(TERM_KEYS)), np.float32))
    return M, {k: table[:, i] for i, k in enumerate(TERM_KEYS)}


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


class Mapper:
    """Unconstrained mapping optimizer; API-compatible with the reference
    ``Mapper`` (``mapping_optimizer.py:14-157``) for the options this port
    supports. The spatial-graph and cell-type-island terms raise
    ``NotImplementedError`` naming their ROADMAP item.

    ``device=None`` means ``"cuda"`` (raises if CUDA is absent); pass
    ``device="cpu"`` for the plain PyTorch path. ``impl`` and ``optimizer``
    are as for :func:`fit_mapping`.
    """

    def __init__(
        self,
        S,
        G,
        d=None,
        d_source=None,
        lambda_g1=1.0,
        lambda_d=0,
        lambda_g2=0,
        lambda_r=0,
        lambda_l1=0,
        lambda_l2=0,
        lambda_neighborhood_g1=0,
        lambda_getis_ord=0,
        lambda_geary=0,
        lambda_moran=0,
        lambda_ct_islands=0,
        device=None,
        random_state=None,
        impl: str = "auto",
        optimizer: str = "adam",
    ):
        self.device = resolve_device(device)
        self.random_state = random_state
        self.impl = impl
        self.optimizer = _check_optimizer(optimizer)
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
        check_supported(self.lw)

        def dev(x):
            if x is None:
                return None
            return torch.tensor(np.asarray(x, dtype=np.float32), device=self.device)

        S = np.asarray(S, dtype=np.float32)
        G = np.asarray(G, dtype=np.float32)
        self.data = MapperData(S=dev(S), G=dev(G), d=dev(d), d_source=dev(d_source))
        self.M = init_logits(S.shape[0], G.shape[0], random_state, self.device)
        resolve_impl(impl, self.M)  # reject a bad impl before training

    def train(self, num_epochs, learning_rate=0.1, print_each=100, val_each=None,
              early_stop_tol=None, early_stop_window=100):
        """Run the optimizer; returns ``(M_probs, training_history)`` like
        the reference ``Mapper.train`` (``mapping_optimizer.py:358-408``).

        Training runs in ``print_each``-epoch chunks with one score line per
        chunk. The logits are updated in place and ``self.M`` stays bound to
        the trained tensor. ``M_probs`` is the row softmax, on the host.
        """
        del early_stop_window
        if val_each is not None:
            raise unported("val_each", "queue A3 (val_metrics)")
        if early_stop_tol is not None:
            raise unported("early_stop_tol", "queue A6 (schedules and early stop)")
        num_epochs = int(num_epochs)
        learning_rate = _check_lr(learning_rate)
        if print_each:
            logging.info(f"Printing scores every {print_each} epochs.")

        def run_chunk(M, opt_state, chunk):
            return fit_mapping(M, self.data, self.lw, chunk, learning_rate,
                               impl=self.impl, opt_state=opt_state,
                               return_opt_state=True, optimizer=self.optimizer)

        self.M, history = _train_chunked(
            run_chunk, self.M, num_epochs,
            print_each if print_each else max(num_epochs, 1),
            PRINT_NAMES if print_each else None,
        )
        training_history = {k: [float(v) for v in history[k]] for k in HISTORY_KEYS}
        for k in VAL_KEYS:
            training_history[k] = []
        _warn_if_diverged(training_history)
        output = _final_softmax(self.M).cpu().numpy()
        return output, training_history
