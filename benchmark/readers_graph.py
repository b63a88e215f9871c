"""The arithmetic of the per-layer metrics of a cell with the graph terms
on (its configuration's ``graph`` block); each metric's file under
``metrics/`` names one of these as its ``read``. Each takes the run's
:class:`~benchmark.harness.Context` and returns a number, or None when the
run has nothing to read for it: a program without these spans and timers,
or a step of no such cell.

The island term appends the one-hot cell types to the contraction's
operand, so the step's contractions are ``genes + types`` columns wide
(and one more for the marginal): the shares here count that width, where
the readers of ``readers.py`` and ``readers_spans.py`` count ``genes``.
"""

from __future__ import annotations

import json

from .readers import _per_job
from .readers_spans import _card_timers
from .reference.kernel_work import launch_key, role_work
from .reference.work import step_work

__all__ = ["epilogue_ms", "graph_inputs_s", "stack_roofline", "stack_project_roofline",
           "stack_rbar_roofline", "stack_dm_adam_roofline", "stack_mfu"]


def _graph_cell(step):
    """(rows, spots, contraction width, storage) of the benchmark's cell
    with a ``graph`` block whose step's work is ``step``, or None."""
    from .harness import ROOT, load_cell, step_of

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in manifest["workloads"]:
        cell = load_cell(entry["name"])
        cfg = cell.config
        if "graph" in cfg and step_of(cell) == step:
            return (cfg[cell.workload["step_rows"]], cfg["spots"], cfg["genes"] + cfg["types"],
                    cfg["storage"])
    return None


def epilogue_ms(ctx):
    """Milliseconds per step of the stream's time in the loss epilogue,
    forward and backward, the host's gaps in issuing it included
    (``DEVICE_SECONDS["epilogue"]`` over the window's epochs, one step
    each)."""
    timers = _card_timers()
    if timers is None:
        return None
    secs = timers[0].get("epilogue", 0.0)
    if secs <= 0 or not ctx.window.epochs:
        return None
    return 1e3 * secs / ctx.window.epochs


def graph_inputs_s(ctx):
    """Seconds per job in ``spot_graphs`` (the spot graphs and one-hot
    types built on the host) and ``graph_refs`` (their upload and the
    reference indicators)."""
    return _per_job(ctx, ("spot_graphs", "graph_refs"))


def stack_roofline(ctx, role):
    """%: the roofline time of one launch of ``role`` at the stack's width
    times its launches in the window, over their card seconds."""
    cell, timers = _graph_cell(ctx.step), _card_timers()
    if cell is None or timers is None:
        return None
    rows, spots, width, storage = cell
    seconds, launches = timers
    key = launch_key(role, **storage)
    n, secs = launches.get(key, 0), seconds.get(key, 0.0)
    if not n or secs <= 0:
        return None
    return 100.0 * role_work(role, rows, spots, width, **storage).seconds * n / secs


def stack_project_roofline(ctx):
    return stack_roofline(ctx, "project")


def stack_rbar_roofline(ctx):
    return stack_roofline(ctx, "rbar")


def stack_dm_adam_roofline(ctx):
    return stack_roofline(ctx, "dm_adam")


def stack_mfu(ctx):
    """%: the step's contractions at the stack's width at the card's peak
    for their storage, times the window's epochs, over the traced
    window's wall time."""
    cell, t = _graph_cell(ctx.step), ctx.trace
    if cell is None or t is None or t.window_s <= 0:
        return None
    rows, spots, width, storage = cell
    step = step_work(rows, spots, width, **storage)
    return 100.0 * step.seconds_flops * ctx.window.epochs / t.window_s
