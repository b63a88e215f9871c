"""Driver ``job_sr``: whole mappings in bf16 storage with stochastic
rounding, held to the stochastic-rounding reference.

Set-up and the window are driver ``job``'s (:func:`.job.setup`,
:func:`.job.window`): the same pair from the seed, the same shell, one
caller in a closed loop; the cell's ``call`` asks for bf16 M, moments and
operands and ``rounding="stochastic"``. The check holds every job of the
window to one run of :func:`..reference.stochastic.run_job` after it,
whose rounding bits are its own: the two runs agree in law, not bit for
bit, so the numbers are those of ``job`` with a row threshold set from
bf16 readings (the cell's ``row_off``), and one number that the rounding
noise hardly moves: ``loss_tail``, the gap of the mean of the last
:data:`TAIL` losses.

Variants (``benchmark.calibrate_sr`` and the CPU tests): ``program``;
``control_nearest``, the program with ``rounding="nearest"``;
``control_e4m3``, the reference with every contraction operand at 3
mantissa bits in the program's place.
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
from ..reference import stochastic
from . import job

__all__ = ["setup", "window", "check", "VARIANTS", "TAIL"]

VARIANTS = ("program", "control_nearest", "control_e4m3")
#: the last epochs whose mean loss ``loss_tail`` compares
TAIL = 100


@dataclass
class State:
    job: job.State
    row_off: float  # a row is off when its L1 gap passes this


def setup(cell, seed, device, variant="program"):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}; expected one of {VARIANTS}")
    if variant == "control_nearest":
        call = dict(cell.workload["call"], rounding="nearest")
        cell = dataclasses.replace(cell, workload=dict(cell.workload, call=call))
    # job's "control" skips the warm-up: the e4m3 control runs no program
    state = job.setup(cell, seed, device, "control" if variant == "control_e4m3" else "program")
    state.variant = variant
    return State(job=state, row_off=float(cell.workload["row_off"]))


def reference(state, **options):
    """One run of the stochastic-rounding reference on the cell's inputs
    (``options``: :func:`..reference.stochastic.run_job`'s ``rounding``,
    ``operands`` and ``bits``)."""
    kw, p = state.kwargs, state.pair
    return stochastic.run_job(p.markers, p.genes_sc, p.X_sc, state.labels, p.genes_sp, p.X_sp,
                              kw["mode"], kw["density_prior"], kw["num_epochs"],
                              kw["learning_rate"], kw["random_state"], state.device, **options)


def run_control_e4m3(state):
    """The reference with its contraction operands at 3 mantissa bits, as
    the program's output: with rounding bits of its own, as the program
    rounds independently of the reference that checks it."""
    out = reference(state, operands="e4m3", bits=state.kwargs["random_state"] + 1)
    return out.mapping.cpu().numpy(), out.scores, out.total_loss


def window(state, seconds, spans):
    if state.job.variant != "control_e4m3":
        return job.window(state.job, seconds, spans)
    s = state.job
    start = time.perf_counter_ns()
    deadline = start + int(seconds * 1e9)
    with contextlib.redirect_stdout(sys.stderr):
        while True:
            with spans("job"):
                s.outputs.append(run_control_e4m3(s))
            end = time.perf_counter_ns()
            if end >= deadline:
                break
    n = len(s.outputs)
    return Window(start_ns=start, end_ns=end, values={"job_s": (end - start) / 1e9 / n},
                  epochs=n * s.kwargs["num_epochs"], attempted=n, jobs=n)


def gaps(ref, output, device, row_off):
    """:func:`.job._gaps` with ``map_rows_off`` at ``row_off``, and
    ``loss_tail``: the gap of the mean of the last :data:`TAIL` losses over
    the history's mean |loss|."""
    numbers = job._gaps(ref, output, device)
    X, _, total = output
    rows = (torch.as_tensor(X, device=device) - ref.mapping).abs().sum(dim=1)
    numbers["map_rows_off"] = float((rows > row_off).double().mean())
    numbers["loss_tail"] = float(abs(total[-TAIL:].mean() - ref.total_loss[-TAIL:].mean())
                                 / np.abs(ref.total_loss).mean())
    return numbers


def check(state, window):
    t0 = time.perf_counter()
    if state.job.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(state.job)
    numbers = {}
    for output in state.job.outputs:
        for k, v in gaps(ref, output, state.job.device, state.row_off).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    numbers["reference_s"] = time.perf_counter() - t0
    return numbers
