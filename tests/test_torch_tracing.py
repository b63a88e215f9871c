"""The port's tracing inside a mapping job, on the CPU: the phases of
``map_cells_to_space`` (the init's draw, cast and upload nested in
``mapper_init``; ``inputs`` and ``result_build`` at the top level), each
phase's range in a ``profiling.trace`` file, the per-kernel card timers of
``ops.cuda_core`` against fake events (never a synchronize), and the
benchmark's readers of these spans and timers on hand-made contexts.
"""

import glob
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import tangram_tpu_torch as tgt
from benchmark import readers_spans
from benchmark.harness import Context, Window, load_cell, load_metric, step_of
from benchmark.reference.kernel_work import ROLES, launch_key, role_work
from benchmark.reference.work import StepWork
from benchmark.trace import Spans, program_phases
from tangram_tpu_torch import profiling as tprof
from tangram_tpu_torch.ops import cuda_core as cc

TOP = {"inputs", "preprocess", "mapper_init", "train_dispatch", "train_execute_history",
       "mapping_fetch", "result_build", "gene_report"}
INIT = {"init_draw", "init_cast", "init_upload"}
CELL = "mop_slideseq.cells_adam"


def small_pair(seed=0):
    rng = np.random.default_rng(seed)
    S = (rng.poisson(2.0, (24, 10)) + 1).astype(np.float32)
    G = (rng.poisson(2.0, (16, 10)) + 1).astype(np.float32)
    genes = pd.DataFrame(index=[f"g{i}" for i in range(10)])
    ad_sc = tgt.AnnData(X=S, var=genes.copy(),
                        obs=pd.DataFrame(index=[f"c{i}" for i in range(24)]))
    ad_sp = tgt.AnnData(X=G, var=genes.copy(),
                        obs=pd.DataFrame(index=[f"s{i}" for i in range(16)]))
    tgt.pp_adatas(ad_sc, ad_sp)
    return ad_sc, ad_sp


def run_job(mode, init_method, **kw):
    """A small job under the benchmark's stamped recording: (phase totals,
    [(phase, start_ns, end_ns)])."""
    ad_sc, ad_sp = small_pair()
    target = dict(target_count=16) if mode == "constrained" else {}
    spans = Spans()
    with program_phases(tprof, spans) as sink:
        tgt.map_cells_to_space(ad_sc, ad_sp, mode=mode, num_epochs=4, random_state=1,
                               verbose=False, device="cpu", init_method=init_method,
                               **target, **kw)
    return sink, spans.items


@pytest.mark.parametrize("init_method", ["numpy", "jax"])
@pytest.mark.parametrize("mode", ["cells", "constrained"])
def test_init_phases_nest_inside_mapper_init(mode, init_method):
    sink, spans = run_job(mode, init_method)
    assert set(sink) == TOP | INIT
    assert sum(sink[n] for n in INIT) <= sink["mapper_init"]
    (outer,) = [(s, e) for n, s, e in spans if n == "mapper_init"]
    for name, s, e in spans:
        if name in INIT:
            assert outer[0] <= s <= e <= outer[1], name


def test_top_level_phases_follow_one_another():
    _, spans = run_job("cells", "numpy")
    top = sorted((s, e, n) for n, s, e in spans if n in TOP)
    for (_, e0, n0), (s1, _, n1) in zip(top, top[1:]):
        assert e0 <= s1, (n0, n1)
    assert [n for _, _, n in top][:4] == ["inputs", "preprocess", "inputs", "inputs"]
    assert [n for _, _, n in top][-3:] == ["result_build", "gene_report", "result_build"]


def test_phases_are_ranges_in_a_trace(tmp_path):
    ad_sc, ad_sp = small_pair()
    log_dir = str(tmp_path / "tb")
    with tprof.trace(log_dir), tprof.record_phases() as rec:
        tgt.map_cells_to_space(ad_sc, ad_sp, num_epochs=3, random_state=1, verbose=False,
                               device="cpu")
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(rec) == TOP | INIT
    assert {f"tangram.{n}" for n in rec} <= names


def test_phase_and_timers_are_no_ops_without_a_recording(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("called without a recording")

    monkeypatch.setattr(tprof, "annotate", boom)
    monkeypatch.setattr(cc, "_timing_event", boom)
    cc.reset_launches()
    assert not tprof.recording()
    with tprof.phase("anything"):
        pass
    with cc.launch("project", torch.zeros(2, 2)):
        pass
    assert cc.LAUNCHES["project"] == 1
    assert not cc._PENDING and cc.device_seconds() == cc.DEVICE_SECONDS
    assert set(cc.DEVICE_SECONDS.values()) == {0.0}
    cc.reset_launches()


class FakeEvent:
    """A timing event on a fake clock (ms); the card 'finishes' an event
    when the test sets ``done``. Waiting on one fails the test."""

    clock = 0.0
    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.t, self.done = None, False

    def record(self, stream=None):
        self.t, self.done = FakeEvent.clock, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time of an unfinished event"
        return end.t - self.t

    def synchronize(self):
        raise AssertionError("an event was waited on")


@pytest.fixture
def fake_card(monkeypatch):
    def no_sync(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize was called")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.cuda, "Event", no_sync)
    monkeypatch.setattr(cc, "_timing_event", FakeEvent)
    monkeypatch.setattr(cc, "_FREE_EVENTS", {})
    FakeEvent.clock, FakeEvent.made = 0.0, 0
    cc.reset_launches()
    yield
    cc.reset_launches()


def timed_launch(name, ms, *storage):
    with cc.launch(name, *(storage or (torch.zeros(2, 2),))):
        FakeEvent.clock += ms
    return cc._PENDING[-1]


def test_device_seconds_resolve_without_waiting(fake_card):
    with tprof.record_phases():
        a = timed_launch("project", 3.0)
        b = timed_launch("rbar", 2.0)
        c = timed_launch("dm_adam", 5.0, torch.zeros(2, 2, dtype=torch.bfloat16))
        assert c[0] == "dm_adam.bf16"
        assert cc.device_seconds() == dict.fromkeys(cc.DEVICE_SECONDS, 0.0)
        # the card finishes rbar first: a new launch adds nothing while the
        # oldest (project) runs; device_seconds adds every finished one
        b[1].done = b[2].done = True
        timed_launch("project", 1.0)
        assert cc.DEVICE_SECONDS["rbar"] == 0.0
        assert cc.device_seconds()["rbar"] == pytest.approx(2e-3)
        for _, start, end, _ in (a, c):
            start.done = end.done = True
        totals = cc.device_seconds()
    assert totals["project"] == pytest.approx(3e-3)
    assert totals["dm_adam.bf16"] == pytest.approx(5e-3) and totals["dm_adam"] == 0.0
    assert len(cc._PENDING) == 1
    assert cc.LAUNCHES["project"] == 2 and cc.LAUNCHES["dm_adam.bf16"] == 1
    # finished pairs are reused: no new events for the next launches
    made = FakeEvent.made
    with tprof.record_phases():
        timed_launch("rbar", 1.0)
        timed_launch("rbar", 1.0)
    assert FakeEvent.made == made


def test_a_failed_launch_is_neither_counted_nor_timed(fake_card):
    with tprof.record_phases(), pytest.raises(RuntimeError):
        with cc.launch("project", torch.zeros(2, 2)):
            raise RuntimeError("kernel launch failed")
    assert cc.LAUNCHES["project"] == 0 and not cc._PENDING


def test_reset_launches_clears_counts_seconds_and_pending(fake_card):
    with tprof.record_phases():
        _, start, end, _ = timed_launch("project", 2.0)
        start.done = end.done = True
        timed_launch("rbar", 1.0)
        assert cc.device_seconds()["project"] > 0
    cc.reset_launches()
    assert set(cc.LAUNCHES.values()) == {0}
    assert set(cc.DEVICE_SECONDS.values()) == {0.0}
    assert not cc._PENDING
    # every counter's seconds, and the graph terms' loss epilogue, timed
    # as a span and counted in no launch
    assert set(cc.DEVICE_SECONDS) == set(cc.LAUNCHES) | {"epilogue"}
    assert {"init_normal", "init_normal.bf16"} <= set(cc.DEVICE_SECONDS)


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def context(phases, jobs=2):
    window = Window(start_ns=0, end_ns=1, values={}, epochs=1000 * jobs, attempted=jobs,
                    jobs=jobs)
    return Context(phases=phases, window=window, trace=None, step=step_of(load_cell(CELL)))


READERS = {"shell.init_draw_s": ("init_draw",), "shell.init_copy_s": ("init_cast", "init_upload"),
           "shell.result_s": ("result_build",)}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers(metric):
    read = load_metric(metric).read
    assert read(context({"mapper_init": 9.0, "gene_report": 1.0})) is None
    assert read(context({READERS[metric][0]: 1.0}, jobs=0)) is None
    phases = {"mapper_init": 20.0, "init_draw": 16.0, "init_cast": 0.8, "init_upload": 0.6,
              "result_build": 1.3}
    want = sum(phases[n] for n in READERS[metric]) / 2
    assert read(context(phases)) == pytest.approx(want)


def test_role_work_at_the_cells_shape():
    cfg = load_cell(CELL).config
    c, s, k = cfg["cells"], cfg["spots"], cfg["genes"]
    project, rbar, dm_adam = (role_work(r, c, s, k) for r in ROLES)
    assert project.seconds == rbar.seconds == pytest.approx(2 * c * s * (k + 1) / 165e12)
    assert project.seconds == pytest.approx(0.789e-3, rel=1e-3)
    assert project.bytes == 4 * c * s and dm_adam.bytes == 24 * c * s
    assert dm_adam.seconds == pytest.approx(24 * c * s / 3.35e12)
    assert dm_adam.seconds == pytest.approx(1.8655e-3, rel=1e-3)
    # two roles form the step's two contractions; dm_adam moves its M, mu, nu
    step = step_of(load_cell(CELL))
    assert project.flops["f32_contraction"] + rbar.flops["f32_contraction"] == \
        step.flops["f32_contraction"]
    assert dm_adam.bytes < step.bytes


def test_role_work_in_bf16():
    bf16 = dict(param="bfloat16", moments="bfloat16", operands="bfloat16")
    w = role_work("dm_adam", 100, 50, 8, **bf16)
    assert w.bytes == 12 * 100 * 50
    assert w.flops == {"bf16_tensor": 2 * 100 * 50 * 8, "f32_fma": 2 * 100 * 50}
    assert launch_key("project", operands="bfloat16") == "project.bf16"
    assert launch_key("rbar", operands="bfloat16") == "rbar"
    assert launch_key("dm_adam", moments="bfloat16") == "dm_adam.bf16"
    assert [launch_key(r) for r in ROLES] == list(ROLES)
    with pytest.raises(ValueError):
        role_work("gsq", 1, 1, 1)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(cc, "LAUNCHES", dict.fromkeys(cc.LAUNCHES, 0))
    monkeypatch.setattr(cc, "DEVICE_SECONDS", dict.fromkeys(cc.LAUNCHES, 0.0))
    monkeypatch.setattr(cc, "_PENDING", type(cc._PENDING)())
    return cc


@pytest.mark.parametrize("role", ROLES)
def test_role_roofline_readers(role, counters):
    read = load_metric(f"kernel_roofline.{role}").read
    ctx = context({})
    assert read(ctx) is None  # no launches
    counters.LAUNCHES[role] = 2000
    assert read(ctx) is None  # launched, never timed
    counters.DEVICE_SECONDS[role] = 7.0
    cfg = load_cell(CELL).config
    bound = role_work(role, cfg["cells"], cfg["spots"], cfg["genes"]).seconds
    assert read(ctx) == pytest.approx(100.0 * bound * 2000 / 7.0)
    assert 0 < read(ctx) < 100
    # a step of no cell of the benchmark: nothing to read
    other = Context(phases={}, window=ctx.window, trace=None,
                    step=StepWork(bytes=1, flops={}, seconds_bytes=0.0, seconds_flops=0.0))
    assert read(other) is None


def test_role_roofline_reads_bf16_counters(counters, monkeypatch):
    bf16 = {"param": "bfloat16", "moments": "bfloat16", "operands": "bfloat16"}
    monkeypatch.setattr(readers_spans, "_cell_of", lambda step: (1000, 500, 20, bf16))
    counters.LAUNCHES["project"], counters.DEVICE_SECONDS["project"] = 10, 1.0
    assert readers_spans.project_roofline(context({})) is None
    counters.LAUNCHES["project.bf16"], counters.DEVICE_SECONDS["project.bf16"] = 10, 2e-3
    want = 100.0 * role_work("project", 1000, 500, 20, **bf16).seconds * 10 / 2e-3
    assert readers_spans.project_roofline(context({})) == pytest.approx(want)


def test_role_roofline_reads_nothing_from_a_program_without_timers(counters, monkeypatch):
    monkeypatch.delattr(cc, "device_seconds")
    counters.LAUNCHES["rbar"] = 5
    counters.DEVICE_SECONDS["rbar"] = 1.0
    assert readers_spans.rbar_roofline(context({})) is None
