"""The arithmetic of the per-layer metrics; each metric's file under
``metrics/`` names one of these as its ``read``. Each takes the run's
:class:`~benchmark.harness.Context` and returns a number, or None when the
run has nothing to read for it."""

from __future__ import annotations

__all__ = ["mapper_init_s", "shell_other_s", "dispatch_ms", "kernel_roofline", "mfu",
           "device_idle"]


def _per_job(ctx, names):
    jobs = ctx.window.jobs
    if not jobs or not any(n in ctx.phases for n in names):
        return None
    return sum(ctx.phases.get(n, 0.0) for n in names) / jobs


def mapper_init_s(ctx):
    """Seconds per job in the program's ``mapper_init`` phase (the seeded
    start drawn and put on the card, the data uploaded)."""
    return _per_job(ctx, ("mapper_init",))


def shell_other_s(ctx):
    """Seconds per job in the shell's other phases: ``preprocess``,
    ``mapping_fetch`` (the row softmax fetched to the host) and
    ``gene_report``."""
    return _per_job(ctx, ("preprocess", "mapping_fetch", "gene_report"))


def dispatch_ms(ctx):
    """Milliseconds per epoch of the program's ``train_dispatch`` phase:
    the host issuing an epoch's work."""
    if "train_dispatch" not in ctx.phases or not ctx.window.epochs:
        return None
    return ctx.phases["train_dispatch"] / ctx.window.epochs * 1e3


def kernel_roofline(ctx):
    """%: the step's roofline time times the window's epochs, over the
    summed time of every CUDA kernel in the traced window."""
    t = ctx.trace
    if t is None or t.kernel_s <= 0:
        return None
    return 100.0 * ctx.step.seconds * ctx.window.epochs / t.kernel_s


def mfu(ctx):
    """%: the step's contractions at the card's peak for their storage,
    times the window's epochs, over the traced window's wall time."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * ctx.step.seconds_flops * ctx.window.epochs / t.window_s


def device_idle(ctx):
    """%: the traced window's time in which no kernel, copy or memset ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
