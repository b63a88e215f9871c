"""Driver ``job_graph``: whole mappings with Tangram's spatial graph terms,
held to the plain graph-term reference.

Set-up and the window are driver ``job``'s (:func:`.job.setup`): the same
pair from the seed, the same shell, one caller in a closed loop. The
cell's ``call`` gains the configuration's ``graph`` block: its lambdas
under ``map_cells_to_space``'s names, ``graph_format`` and
``cluster_label``. ``pp_adatas`` builds the spot graph from the pair's
coordinates as it does for any user, at its default of 6 nearest
neighbours on generic coordinates, which the block states as
``n_neighs`` and ``coord_type`` for the reference.

Each job's mapping, training scores and loss history are kept, and the
five graph terms' histories too: ``fit_mapping`` records them and
``training_history`` leaves them out, so they are read from what the
training loop (``models.mapper._train_chunked``) returns, without changing
it. After the window every job is held to one run of
:func:`..reference.spatial.run_job`: ``job``'s four numbers, and
``graph_terms_max``, the worst of the five terms' gaps, each the largest
gap of the term's history over the reference history's mean |value|
(printed beside it as ``graph_gap.<term>``).

Those numbers cannot tell the contractions' precision apart: after the
island term's max(·, 0) starts to switch, any perturbation, f32 summation
order included, grows into the same jitter of the mapping about its
optimum. So the check also runs one more job of the program, of
:data:`HEAD_EPOCHS` epochs, before that switching sets in, and holds it to
the reference run as long: ``job``'s numbers, ``head_``-prefixed.

Variants (``benchmark.calibrate_graph`` and the CPU tests): ``program``;
``control``, the reference with every contraction operand rounded to TF32
in the program's place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..harness import Window
from ..reference import spatial
from . import job

__all__ = ["setup", "window", "check", "VARIANTS", "gaps", "reference", "run_program",
           "run", "head", "head_gaps", "HEAD_EPOCHS"]

VARIANTS = ("program", "control")
#: the epochs of the check's short job: the island term is still 0 through
#: them (PERF.md §2)
HEAD_EPOCHS = 20


@dataclass
class State:
    job: job.State
    graph: dict  # the configuration's graph block


def setup(cell, seed, device, variant="program"):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}; expected one of {VARIANTS}")
    graph = cell.config["graph"]
    call = dict(cell.workload["call"], graph_format=graph["graph_format"],
                cluster_label=graph["cluster_label"],
                **{k: v for k, v in graph.items() if k.startswith("lambda_")})
    cell = dataclasses.replace(cell, workload=dict(cell.workload, call=call))
    return State(job=job.setup(cell, seed, device, variant), graph=graph)


@contextlib.contextmanager
def _training_histories(sink: list):
    """Each history the mapper's training loop returns, appended to
    ``sink`` as it passes."""
    from tangram_tpu_torch.models import mapper

    loop = mapper._train_chunked

    def recorded(*args, **kwargs):
        params, history = loop(*args, **kwargs)
        sink.append(history)
        return params, history

    mapper._train_chunked = recorded
    try:
        yield
    finally:
        mapper._train_chunked = loop


def run_program(state):
    """One job of the program: (mapping, scores, total loss history, the
    graph terms' histories; a term the loop did not record is absent)."""
    histories = []
    with _training_histories(histories):
        X, scores, total = job._run_program(state.job)
    last = histories[-1] if histories else {}
    terms = {k: np.asarray(last[k], dtype=np.float64) for k in spatial.GRAPH_KEYS if k in last}
    return X, scores, total, terms


def reference(state, operands: str = "float32") -> spatial.SpatialResult:
    """One run of the graph-term reference on the cell's inputs."""
    s = state.job
    kw, p = s.kwargs, s.pair
    return spatial.run_job(p.markers, p.genes_sc, p.X_sc, s.labels, p.genes_sp, p.X_sp,
                           p.coords, state.graph, kw["density_prior"], kw["num_epochs"],
                           kw["learning_rate"], kw["random_state"], s.device, operands)


def run_control(state):
    """The control: the reference with its contraction operands in TF32."""
    out = reference(state, "tf32")
    return out.mapping.cpu().numpy(), out.scores, out.total_loss, out.terms


def head(state, epochs: int = HEAD_EPOCHS):
    """The cell's state for a job of ``epochs`` epochs, with no outputs."""
    return dataclasses.replace(state, job=dataclasses.replace(
        state.job, kwargs=dict(state.job.kwargs, num_epochs=epochs), outputs=[]))


def run(state):
    """One job of the state's variant: the program's, or the control's."""
    return run_control(state) if state.job.variant == "control" else run_program(state)


def window(state, seconds, spans):
    outputs = state.job.outputs
    start = time.perf_counter_ns()
    deadline = start + int(seconds * 1e9)
    with contextlib.redirect_stdout(sys.stderr):
        while True:
            with spans("job"):
                outputs.append(run(state))
            end = time.perf_counter_ns()
            if end >= deadline:
                break
    n = len(outputs)
    return Window(start_ns=start, end_ns=end, values={"job_s": (end - start) / 1e9 / n},
                  epochs=n * state.job.kwargs["num_epochs"], attempted=n, jobs=n)


def _term_gap(got, want) -> float:
    """The largest gap of a history over the reference history's mean
    |value|; inf for a history missing or of another length, NaN where
    either holds one."""
    if got is None or got.shape != want.shape:
        return float("inf")
    gap = float(np.abs(got - want).max())
    scale = float(np.abs(want).mean())
    if scale > 0 or np.isnan(scale):
        return gap / scale
    return 0.0 if gap == 0 else float("inf")


def gaps(ref: spatial.SpatialResult, output, device) -> dict:
    """:func:`.job._gaps` of one job's output, and each graph term's gap
    with ``graph_terms_max``, the worst of them."""
    numbers = job._gaps(ref, output[:3], device)
    terms = {f"graph_gap.{k}": _term_gap(output[3].get(k), ref.terms[k])
             for k in spatial.GRAPH_KEYS}
    numbers["graph_terms_max"] = float(np.max(list(terms.values())))
    numbers.update(terms)
    return numbers


def head_gaps(state, epochs: int = HEAD_EPOCHS, ref=None) -> dict:
    """:func:`.job._gaps` of one job of ``epochs`` epochs (the program's,
    or the control's in its variant) against ``ref``, the reference run as
    long (run here if not given), each name ``head_``-prefixed. The graph
    terms' gaps are left out: the island term's history is still 0 there."""
    short = head(state, epochs)
    with contextlib.redirect_stdout(sys.stderr):
        output = run(short)
    ref = reference(short) if ref is None else ref
    return {f"head_{k}": v for k, v in job._gaps(ref, output[:3], state.job.device).items()}


def check(state, window):
    t0 = time.perf_counter()
    if state.job.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(state)
    numbers = {}
    for output in state.job.outputs:
        for k, v in gaps(ref, output, state.job.device).items():
            numbers[k] = max(numbers.get(k, 0.0), v) if not np.isnan(v) else v
    del ref
    numbers.update(head_gaps(state))
    numbers["reference_s"] = time.perf_counter() - t0
    return numbers
