"""The arithmetic of the per-layer metrics that read the program's finer
spans and its per-kernel card timers; each metric's file under
``metrics/`` names one of these as its ``read``. Each takes the run's
:class:`~benchmark.harness.Context` and returns a number, or None when the
run has nothing to read for it (a program without these spans or timers
among them).

The phases are the program's ``record_phases`` totals over the window. The
per-kernel shares read the program's launch counters
(``cuda_core.LAUNCHES``) and the card seconds of those launches
(``cuda_core.device_seconds()``), both reset at the window's start and
read after it, once the card has finished.
"""

from __future__ import annotations

import json

from .readers import _per_job
from .reference.kernel_work import launch_key, role_work

__all__ = ["init_draw_s", "init_copy_s", "result_s", "role_roofline",
           "project_roofline", "rbar_roofline", "dm_adam_roofline"]


def init_draw_s(ctx):
    """Seconds per job in the program's ``init_draw`` phase: the seeded
    start drawn (on the host for the reference's numpy stream)."""
    return _per_job(ctx, ("init_draw",))


def init_copy_s(ctx):
    """Seconds per job in ``init_cast`` and ``init_upload``: the start cast
    to its storage type on the host and copied to the card."""
    return _per_job(ctx, ("init_cast", "init_upload"))


def result_s(ctx):
    """Seconds per job in ``result_build``: the returned AnnData with its
    ``obs`` and ``var``, and its training history."""
    return _per_job(ctx, ("result_build",))


def _cell_of(step):
    """(cells, spots, genes, storage) of the benchmark's cell whose step's
    work is ``step``, or None."""
    from .harness import ROOT, load_cell, step_of

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in manifest["workloads"]:
        cell = load_cell(entry["name"])
        if step_of(cell) == step:
            cfg = cell.config
            return cfg[cell.workload["step_rows"]], cfg["spots"], cfg["genes"], cfg["storage"]
    return None


def _card_timers():
    """(card seconds, launch counts) by counter, or None when the program
    does not time its kernels."""
    from tangram_tpu_torch.ops import cuda_core

    read = getattr(cuda_core, "device_seconds", None)
    if read is None:
        return None
    return read(), dict(cuda_core.LAUNCHES)


def role_roofline(ctx, role):
    """%: the roofline time of one launch of ``role``
    (:func:`~benchmark.reference.kernel_work.role_work` at the cell's
    shapes and storage) times its launches in the window, over their card
    seconds."""
    cell = _cell_of(ctx.step)
    timers = _card_timers()
    if cell is None or timers is None:
        return None
    cells, spots, genes, storage = cell
    seconds, launches = timers
    key = launch_key(role, **storage)
    n, secs = launches.get(key, 0), seconds.get(key, 0.0)
    if not n or secs <= 0:
        return None
    return 100.0 * role_work(role, cells, spots, genes, **storage).seconds * n / secs


def project_roofline(ctx):
    return role_roofline(ctx, "project")


def rbar_roofline(ctx):
    return role_roofline(ctx, "rbar")


def dm_adam_roofline(ctx):
    return role_roofline(ctx, "dm_adam")
