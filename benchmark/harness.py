"""Run one cell once: set-up, the measured window, the metrics, the check.

Everything that belongs to one configuration, cell or per-layer metric is
found by name: ``BENCHMARK.json`` at the checkout's root names them,
``benchmark/workloads/<cell>.json`` holds a cell's traffic, the
configuration's ``file`` its sizes, ``benchmark/drivers/<driver>.py`` the
entry a cell's window calls, and ``benchmark/metrics/<metric>.py`` the
reader of one per-layer metric (``read(ctx)`` → a number, or None when the
run has nothing to read for it).

A driver module has three functions:

* ``setup(cell, seed, device, variant)`` → its state;
* ``window(state, seconds, spans)`` → :class:`Window`;
* ``check(state, window)`` → {number name: value}, after freeing the
  program's state on the card; the cell's ``limits`` say which are
  compared and against what.

``variant`` is ``"program"`` in the benchmark's runs; the controls
(``"control"``, and for ``job`` ``"control_bf16"``: see each driver) put a
lower precision in the program's place for ``benchmark.calibrate`` and
the CPU tests.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from .trace import MARK, Spans, program_phases, reduce_trace

__all__ = ["ROOT", "Cell", "Window", "Context", "load_cell", "measure", "FORBIDDEN",
           "is_share_of_peak"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "tangram_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    workload: dict  # benchmark/workloads/<name>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


@dataclass
class Window:
    start_ns: int
    end_ns: int
    values: dict  # the driver's end-to-end metrics
    epochs: int  # optimizer epochs completed in the window
    attempted: int
    failed: int = 0
    jobs: int | None = None  # whole jobs, for the job driver


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    phases: dict  # the program's record_phases totals over the window, s
    window: Window
    trace: object | None  # trace.DeviceTrace of a --trace 1 run
    step: object  # reference.work.StepWork of the cell's step


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT, workloads_dir: Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    wdir = workloads_dir or BENCH / "workloads"
    workload = json.loads((wdir / f"{name}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m
                                                      and m["moves"] in reported)]
    return Cell(name=name, chips=int(entry["chips"]), config=config, workload=workload,
                end_to_end=e2e, per_layer=per_layer)


def load_driver(name: str):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def step_of(cell: Cell):
    """The work of the cell's optimizer step: its rows are the
    configuration's key that the cell's ``step_rows`` names (``cells``,
    ``types``), its width the configuration's ``genes``, in its ``storage``."""
    from .reference.work import step_work

    cfg = cell.config
    return step_work(cfg[cell.workload["step_rows"]], cfg["spots"], cfg["genes"],
                     **cfg["storage"])


def is_share_of_peak(name: str) -> bool:
    """A kernel's share of its roofline, or a share of the card's peak:
    above 100% the work is counted too high or the time leaves out work."""
    return "_roofline" in name or "mfu" in name


def _synchronize(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Outcome:
    result: dict  # the result line
    checks: dict  # name -> (value, limit)
    notes: list  # earlier lines


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            variant: str = "program") -> Outcome:
    """Set up, run the window (traced with ``trace``), read the metrics and
    check the outputs: ``correct`` holds each number the cell's ``limits``
    name to its limit and, in a traced run, each share of a roofline or
    peak to 100%. ``t_start`` is the process's start on
    ``time.perf_counter``."""
    import torch

    from tangram_tpu_torch import profiling
    from tangram_tpu_torch.ops import cuda_core

    driver = load_driver(cell.workload["driver"])
    notes = []
    state = driver.setup(cell, seed, device, variant)
    _synchronize(torch, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cuda_core.reset_launches()
    spans = Spans()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    mark_ns = time.perf_counter_ns()
    if trace:
        with record_function(MARK):
            pass
    with program_phases(profiling, spans) as phases:
        window = driver.window(state, seconds, spans)
    _synchronize(torch, device)
    device_trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        device_trace = reduce_trace(prof.profiler.kineto_results.events(), mark_ns,
                                    (window.start_ns, window.end_ns), spans.items)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {k: v for k, v in cuda_core.LAUNCHES.items() if v}
    notes.append(f"launches in the window: {json.dumps(launches)}")
    notes.append(f"phases in the window (s): {json.dumps({k: round(v, 6) for k, v in phases.items()})}")

    values = dict(window.values)
    values["setup_s"] = setup_s
    values["peak_gib"] = peak / 2**30
    metrics, shares = {}, {}
    if trace:
        ctx = Context(phases=dict(phases), window=window, trace=device_trace, step=step_of(cell))
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
                if is_share_of_peak(m["name"]):
                    shares[m["name"]] = (v, 100.0)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    numbers = driver.check(state, window)
    limits = cell.workload["limits"]
    checks = {k: (numbers[k], limits[k]) for k in limits}
    checks.update(shares)
    extra = {k: v for k, v in numbers.items() if k not in limits}
    notes.append(f"numbers not compared: {json.dumps(extra)}")
    correct = window.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = device_trace.busy_s if device_trace else 0.0
        dev["window_s"] = device_trace.window_s if device_trace else (
            (window.end_ns - window.start_ns) / 1e9)
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if device_trace is not None:
        result["breakdown"] = {"device_ops": device_trace.device_ops,
                               "idle_gaps": device_trace.idle_by_host}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return Outcome(result=result, checks=checks, notes=notes)
