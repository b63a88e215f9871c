"""Tracing and profiling utilities, the counterpart of
``tangram_tpu/profiling.py`` on ``torch.profiler`` and the host clock.

* :func:`record_phases` / :func:`phase` — wall-clock phase timings of the
  library's own stages (the JAX package's phase names and the port's finer
  ones), no-ops unless a recording is active; each phase is also a
  ``tangram.<name>`` range in a :func:`trace`. While a recording is
  active the kernels are timed on the card too
  (:data:`~tangram_tpu_torch.ops.cuda_core.DEVICE_SECONDS`).
* :func:`trace` — a ``torch.profiler`` trace (CPU, and CUDA when present)
  that TensorBoard's profiler plugin or Chrome's trace viewer loads.
* :func:`annotate` — a named range inside such a trace.
* :func:`benchmark_mapping` — warm-up-excluded ms per step of
  :func:`~tangram_tpu_torch.models.mapper.fit_mapping` on a synthetic
  problem.
* :class:`StepTimer` — wall-clock segment timing for host-side stages.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "trace",
    "annotate",
    "benchmark_mapping",
    "StepTimer",
    "record_phases",
    "phase",
    "recording",
]

_PHASE_SINK = threading.local()


@contextlib.contextmanager
def record_phases():
    """Collect wall-clock phase timings from library internals.

    :func:`tangram_tpu_torch.map_cells_to_space` and ``Mapper.train`` mark
    their stages with :func:`phase`, under the JAX package's names:
    ``preprocess``, ``mapper_init``, ``train_dispatch`` (each training
    chunk's ``fit_mapping`` call: the host issuing the steps),
    ``train_execute_history`` (each chunk's history fetch, which waits for
    the card to finish the chunk), ``mapping_fetch`` and ``gene_report``;
    and under the port's own: ``inputs`` (the training genes, the
    clusters aggregation, the density prior, the spot graphs and the
    one-hot cell types) and ``result_build`` (the returned AnnData). Inside
    ``mapper_init``, ``init_draw`` holds the draw of the seeded start,
    ``init_cast`` its cast on the host and ``init_upload`` its copy to the
    device (for a start drawn on the card, ``init_draw`` holds the kernels
    and the read-back of numpy's state, ``init_upload`` the state's copy).
    With a graph term on, ``spot_graphs`` inside ``inputs`` holds the spot
    graphs and one-hot cell types built on the host, and ``graph_refs``
    inside ``mapper_init`` their upload and the reference indicators; an
    inner phase counts in its outer one's total too.

    >>> with tgt.profiling.record_phases() as phases:
    ...     tgt.map_cells_to_space(ad_sc, ad_sp, ...)
    >>> phases  # {"mapper_init": 1.2, "init_draw": 1.0, ...}

    Thread-local and reentrant (an inner recording shadows the outer for
    its duration). With no recording active, :func:`phase` is a no-op.
    While one is active, each kernel launch of
    :mod:`~tangram_tpu_torch.ops.cuda_core` is also timed on the card,
    without a synchronization
    (:func:`~tangram_tpu_torch.ops.cuda_core.device_seconds`).
    """
    prev = getattr(_PHASE_SINK, "sink", None)
    sink: dict = {}
    _PHASE_SINK.sink = sink
    try:
        yield sink
    finally:
        _PHASE_SINK.sink = prev


def recording() -> bool:
    """True while a :func:`record_phases` recording is active in this
    thread."""
    return getattr(_PHASE_SINK, "sink", None) is not None


@contextlib.contextmanager
def phase(name: str):
    """Accumulate a named wall-clock segment into the active
    :func:`record_phases` sink, inside a ``tangram.<name>`` range of a
    :func:`trace`; no-op when no recording is active."""
    sink = getattr(_PHASE_SINK, "sink", None)
    if sink is None:
        yield
        return
    with annotate(f"tangram.{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with profiling.trace('/tmp/tb') as prof: ...``.

    Records CPU activity, and CUDA activity when CUDA is available, and
    writes a ``*.pt.trace.json`` file into ``log_dir`` on exit (TensorBoard's
    profiler plugin and Chrome's trace viewer load it). Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` tabulates
    the run."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named range inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Accumulates named wall-clock segments: ``with timer('io'): ...``"""

    segments: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.segments.setdefault(name, 0.0)
            self.segments[name] += time.perf_counter() - t0

    def summary(self) -> dict:
        return dict(self.segments)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_mapping(
    n_cells: int,
    n_spots: int,
    n_genes: int = 249,
    num_epochs: int = 100,
    learning_rate: float = 0.1,
    impl: str = "auto",
    seed: int = 0,
    device=None,
):
    """Steps per second of :func:`fit_mapping` on a synthetic problem.

    Runs on ``device`` (``None`` means ``"cuda"``, which must be available;
    ``"cpu"`` runs the plain PyTorch loop). A first fit warms up (kernel
    build and load, allocator); the second, from logits 1.0001× the first
    start's, is timed on the host clock between two device
    synchronizations. Returns the JAX package's keys: per-step
    milliseconds, epochs per second and the projected seconds of a
    1000-epoch mapping at this shape, with ``"backend"`` the device's name.
    """
    from .models.mapper import fit_mapping, init_logits, resolve_device
    from .ops.losses import LossWeights, MapperData

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    S = rng.poisson(1.0, (n_cells, n_genes)).astype(np.float32)
    G = rng.poisson(2.0, (n_spots, n_genes)).astype(np.float32)
    d = rng.random(n_spots).astype(np.float32)
    d /= d.sum()

    lw = LossWeights(lambda_g1=1.0, lambda_d=1.0)
    data = MapperData(S=torch.from_numpy(S).to(dev), G=torch.from_numpy(G).to(dev),
                      d=torch.from_numpy(d).to(dev))
    M0 = init_logits(n_cells, n_spots, random_state=seed, method="jax", device=dev)

    # the fused loops update M in place: each fit gets its own copy
    _, history = fit_mapping(M0.clone(), data, lw, num_epochs, learning_rate, impl=impl)
    _ = float(history["total_loss"][-1])
    _synchronize(dev)

    M1 = M0 * 1.0001
    _synchronize(dev)
    t0 = time.perf_counter()
    _, history = fit_mapping(M1, data, lw, num_epochs, learning_rate, impl=impl)
    _ = float(history["total_loss"][-1])
    _synchronize(dev)
    elapsed = time.perf_counter() - t0

    return {
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_cells": n_cells,
        "n_spots": n_spots,
        "n_genes": n_genes,
        "num_epochs": num_epochs,
        "seconds": elapsed,
        "ms_per_step": elapsed / num_epochs * 1e3,
        "epochs_per_s": num_epochs / elapsed,
        "projected_1000_epochs_s": elapsed / num_epochs * 1000,
    }
