"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's
manifest whose configurations are cut to a size a CPU run holds in
seconds, with the cells' own workload files (limits included)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import BENCH, ROOT, load_cell

#: the small shapes of the CPU runs
TINY = {"mop_slideseq": dict(cells=300, spots=120, genes=40, genes_sc=400, genes_sp=350,
                             markers=44, types=5, num_epochs=60)}


def tiny_root(tmp: Path, sizes: dict | None = None) -> Path:
    """A manifest at ``tmp`` whose configurations take ``TINY``'s shapes,
    updated by ``sizes`` ({config: {key: value}})."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "configs").mkdir(parents=True)
    (tmp / "workloads").mkdir()
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY[c["name"]], **(sizes or {}).get(c["name"], {}))
        c["file"] = f"configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in manifest["workloads"]:
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        (tmp / "workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    """``load(name, **sizes)`` → the cell ``name`` at the small shapes (its
    configuration's keys updated by ``sizes``)."""
    torch.set_num_threads(2)

    def load(name, **sizes):
        root = tiny_root(tmp_path / f"{name}{len(list(tmp_path.iterdir()))}",
                         {name.split(".")[0]: sizes})
        return load_cell(name, root=root, workloads_dir=root / "workloads")

    return load
