"""The harness on the CPU: cells found by name, the reference against its
float64 self, no card no result, and what a run may load."""

import ast
import json
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import run
from benchmark.harness import BENCH, ROOT, load_cell, measure
from benchmark.reference import generators
from benchmark.reference.tangram import Precision, run_job

from .conftest import tiny_root


def test_a_new_cell_file_is_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "mop_slideseq.throwaway", "config": "mop_slideseq",
                                  "traffic": "throwaway", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "mop_slideseq.cells_adam" in m.get("workloads", ()):
            m["workloads"].append("mop_slideseq.throwaway")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = json.loads((root / "workloads" / "mop_slideseq.cells_adam.json").read_text())
    cell["call"] = {"mode": "clusters", "cluster_label": "subclass_label"}
    cell["step_rows"] = "types"
    (root / "workloads" / "mop_slideseq.throwaway.json").write_text(json.dumps(cell))

    found = load_cell("mop_slideseq.throwaway", root=root, workloads_dir=root / "workloads")
    assert found.workload["call"]["mode"] == "clusters"
    assert {m["name"] for m in found.end_to_end} == {"job_s", "peak_gib", "setup_s"}
    out = measure(found, 3, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert out.result["correct"] and out.result["attempted"] == 1


def _tiny_pair(seed=11):
    return generators.tutorial_pair(200, 90, 300, 260, 34, 30, 4, seed, 0.09, 0.006)


def test_the_pair_has_the_asked_widths_and_is_seeded():
    pair = _tiny_pair()
    assert pair.X_sc.shape == (200, 300) and pair.X_sp.shape == (90, 260)
    assert len(pair.markers) == 34 and set(pair.genes_sp) <= set(pair.genes_sc)
    shared = [g for g in pair.markers if g in set(pair.genes_sp)]
    assert shared == pair.markers[:30]
    for X in (pair.X_sc, pair.X_sp):
        assert X.indptr[-1] == len(X.indices) == len(X.data) and (X.data > 0).all()
    again = _tiny_pair()
    assert np.array_equal(pair.X_sc.data, again.X_sc.data)
    assert np.array_equal(pair.X_sp.indices, again.X_sp.indices)
    assert not np.array_equal(pair.X_sc.data, _tiny_pair(12).X_sc.data)


def test_reference_agrees_with_its_float64_self():
    pair = _tiny_pair()
    labels = np.array([pair.types[t] for t in pair.labels])
    args = (pair.markers, pair.genes_sc, pair.X_sc, labels, pair.genes_sp, pair.X_sp)
    for mode in ("cells", "clusters"):
        f32 = run_job(*args, mode, "rna_count_based", 40, 0.1, 7, "cpu")
        f64 = run_job(*args, mode, "rna_count_based", 40, 0.1, 7, "cpu",
                      Precision("float64", "float64", "float64"))
        rel = np.abs(f32.total_loss - f64.total_loss) / np.abs(f64.total_loss)
        assert rel.max() < 1e-5, (mode, rel.max())
        assert float((f32.mapping.double() - f64.mapping).abs().sum(1).max()) < 1e-3
        assert max(abs(f32.scores[g] - f64.scores[g]) for g in f64.scores) < 1e-5


def test_without_a_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "mop_slideseq.cells_adam", "--seed", str(2**31 + 5),
                     "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert code != 0 and out == "" and "no CUDA device" in err


FORBIDDEN = ("jax", "jaxlib", "flax", "tangram_tpu")


def test_a_run_loads_nothing_of_jax(tmp_path):
    root = tiny_root(tmp_path)
    script = f"""
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark.harness import load_cell, measure, forbidden_modules
from pathlib import Path
root = Path({str(root)!r})
cell = load_cell("mop_slideseq.cells_adam", root=root, workloads_dir=root / "workloads")
measure(cell, 2**31 + 9, 0.0, True, torch.device("cpu"), time.perf_counter())
print(forbidden_modules())
print(sorted(m for m in sys.modules if m.split(".")[0] == "tangram_tpu_torch")[:1])
"""
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    forbidden, port = done.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert port == "['tangram_tpu_torch']"  # the run did load the port


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN + ("tangram_tpu_torch", "benchmark"), \
                    (path.name, name)
    script = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.generators, benchmark.reference.tangram, benchmark.reference.work
print(sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN + ("tangram_tpu_torch",)!r}))
"""
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "[]"


def test_a_share_above_100_percent_fails_the_run(tmp_path, monkeypatch):
    from benchmark import harness

    class Over:
        @staticmethod
        def read(ctx):
            return 100.5

    class Plain:
        @staticmethod
        def read(ctx):
            return 50.0

    monkeypatch.setattr(harness, "load_metric",
                        lambda name: Over if harness.is_share_of_peak(name) else Plain)
    root = tiny_root(tmp_path)
    cell = load_cell("mop_slideseq.cells_adam", root=root, workloads_dir=root / "workloads")
    result = measure(cell, 2**31 + 3, 0.0, True, torch.device("cpu"), time.perf_counter()).result
    assert result["checks"]["mfu.job"] == {"value": 100.5, "limit": 100.0}
    assert result["checks"]["kernel_roofline.job"]["value"] == 100.5
    assert "device_idle.job" not in result["checks"]
    assert not result["correct"]


def test_trace_reduction_on_made_up_events():
    from benchmark.trace import MARK, reduce_trace

    class E:
        def __init__(self, name, dev, start, dur, note=False):
            self._n, self._d, self._s, self._u, self._a = name, dev, start, dur, note

        def name(self):
            return self._n

        def device_type(self):
            return f"DeviceType.{self._d}"

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._u

        def is_user_annotation(self):
            return self._a

    off = 1_000_000  # profiler clock ahead of the host clock
    events = [E(MARK, "CPU", off + 100, 5, True), E(MARK, "CUDA", off + 100, 900, True),
              E("k1", "CUDA", off + 200, 100), E("k2", "CUDA", off + 250, 100),
              E("Memcpy HtoD", "CUDA", off + 600, 100), E("k1", "CUDA", off + 5000, 10)]
    spans = [("job", 100, 1100), ("mapper_init", 350, 600), ("train_dispatch", 700, 1100)]
    t = reduce_trace(events, 100, (100, 1100), spans)
    assert t.window_s == 1000e-9
    assert t.busy_s == 250e-9  # [200, 350] and [600, 700]
    assert t.kernel_s == 200e-9  # k1 and k2; the copy and the kernel outside are not
    assert t.device_ops == [["k1", 100e-9], ["k2", 100e-9], ["Memcpy HtoD", 100e-9]]
    assert dict(t.idle_by_host) == {"job": 100e-9, "mapper_init": 250e-9,
                                    "train_dispatch": 400e-9}
