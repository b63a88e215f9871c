"""BENCHMARK.json against the benchmark's contract, and each of its names
against the files that hold it."""

import json
import re

import pytest

from benchmark.harness import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
ALL_METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert all(_line(w) for w in MANIFEST["command"]) and len(MANIFEST["command"]) <= 32
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_use_allowed_characters_and_are_unique(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)


def test_units_and_sources():
    for m in ALL_METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher"), m
        assert m["source"] in SOURCES, m
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace"), m
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25, m
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]), m
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_setup_s_is_declared_for_every_cell():
    (setup,) = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert "workloads" not in setup and setup["bound"] <= 0.25


def _reported(cell):
    return {m["name"] for m in MANIFEST["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_per_layer_metric_lists_cells_that_report_what_it_moves():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["workloads"], m
        for cell in m["workloads"]:
            assert cell in cells, m
            assert m["moves"] in _reported(cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        reported = _reported(w["name"])
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in MANIFEST["per_layer"])


def test_cells_configs_and_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"])
        used.add(w["config"])
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"]
        assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
        config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert isinstance(config[cell["step_rows"]], int), cell["step_rows"]
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_per_layer_metric_has_a_reader():
    for m in MANIFEST["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        assert path.exists(), path


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
