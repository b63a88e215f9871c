"""Spans on the host clock and the reduction of a ``torch.profiler`` trace.

A driver marks its own spans (``job`` around each job) and the harness
stamps the program's ``record_phases`` phases with their start and end as
they close. A traced window runs under
``torch.profiler`` (CPU and CUDA activity); a ``record_function`` marker
at the window's start ties the profiler's clock to the host's.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

__all__ = ["Spans", "DeviceTrace", "reduce_trace", "union_seconds", "idle_gaps"]

MARK = "benchmark.window"
#: device operations' names are cut to this many characters in the breakdown
NAME_CHARS = 160


class Spans:
    """Named host intervals (ns on ``time.perf_counter_ns``)."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))


class StampedPhases(dict):
    """A ``record_phases`` sink that also records when each phase closed:
    the program adds a phase's duration to its running total as it ends,
    so the end is now and the start is now minus the increment."""

    def __init__(self, spans: Spans):
        super().__init__()
        self.spans = spans

    def __setitem__(self, key, total):
        now = time.perf_counter_ns()
        start = now - round((total - self.get(key, 0.0)) * 1e9)
        self.spans.items.append((key, start, now))
        super().__setitem__(key, total)


@contextlib.contextmanager
def program_phases(profiling, spans: Spans):
    """``profiling.record_phases()`` of the program, its sink stamped into
    ``spans`` where the program keeps it where this looks for it (else the
    plain totals). Yields the dict of phase totals (seconds)."""
    with profiling.record_phases() as plain:
        holder = getattr(profiling, "_PHASE_SINK", None)
        if holder is not None and getattr(holder, "sink", None) is plain:
            holder.sink = StampedPhases(spans)
            yield holder.sink
        else:
            yield plain


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def idle_gaps(intervals, t0: int, t1: int):
    """(start_ns, end_ns) of the stretches of [t0, t1] that no interval
    covers."""
    gaps, cursor = [], t0
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
        if cursor >= t1:
            break
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(s, e) for s, e in gaps if e > s]


@dataclass
class DeviceTrace:
    """What a traced window measured on the device."""

    window_s: float  # the traced window, host clock
    busy_s: float  # union of kernel, memcpy and memset intervals
    kernel_s: float  # summed durations of every kernel
    device_ops: list = field(default_factory=list)  # [[name, seconds]], top 10
    idle_by_host: list = field(default_factory=list)  # [[host span, idle s]], top 10


def _labeller(spans):
    """``label(t)``: the innermost host span open at ``t``, for spans that
    nest or follow one another: the latest-starting one that covers t."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]

    def label(t: int) -> str:
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            name, _, end = spans[i]
            if end >= t:
                return name
        return "harness"

    return label


def _is_device(event) -> bool:
    return str(event.device_type()).rsplit(".", 1)[-1].upper() == "CUDA"


_COPY_WORDS = ("memcpy", "memset")


def reduce_trace(events, mark_host_ns: int, window_host_ns: tuple, spans) -> DeviceTrace | None:
    """Reduce the profiler's events (``prof.profiler.kineto_results.events()``)
    of a window that began with the ``MARK`` range, entered at host time
    ``mark_host_ns``. ``window_host_ns`` is the window's (start, end) on the
    host clock; ``spans`` are (name, start, end) host spans. None when the
    trace holds no marker or no device activity."""
    events = list(events)
    marks = [e for e in events if e.name() == MARK and not _is_device(e)]
    if not marks:
        return None
    offset = marks[0].start_ns() - mark_host_ns  # profiler clock − host clock
    t0, t1 = (t + offset for t in window_host_ns)
    intervals, kernel_ns, by_name = [], 0, {}
    for e in events:
        if not _is_device(e) or e.is_user_annotation():
            continue
        s, dur = e.start_ns(), e.duration_ns()
        if s + dur < t0 or s > t1 or dur <= 0:
            continue
        name = e.name()
        intervals.append((max(s, t0), min(s + dur, t1)))
        if not any(w in name.lower() for w in _COPY_WORDS):
            kernel_ns += dur
        by_name[name] = by_name.get(name, 0) + dur
    if not intervals:
        return None
    label_at = _labeller([(n, s + offset, e + offset) for n, s, e in spans])
    idle: dict = {}
    for s, e in idle_gaps(intervals, t0, t1):
        label = label_at((s + e) // 2)
        idle[label] = idle.get(label, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS - 3] + "...", ns) for n, ns in top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(window_s=(t1 - t0) / 1e9, busy_s=union_seconds(intervals),
                       kernel_s=kernel_ns / 1e9,
                       device_ops=[[n, ns / 1e9] for n, ns in top],
                       idle_by_host=[[n, ns / 1e9] for n, ns in gaps])
