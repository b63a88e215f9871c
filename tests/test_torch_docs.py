"""The port's docs tooling (``tangram_tpu_torch/scripts/gen_api_docs.py`` and
``gen_tutorial_notebook.py``), case for case with ``tests/test_docs.py``:
the API reference generates with a page and an index entry for every
module and every public name on its module's page, the committed
``docs/reference_torch/`` is current (``--check``), and the committed
notebook is valid nbformat 4, is what the generator writes, calls the
tutorial's steps and never imports jax."""

import ast
import importlib
import json
import os

from tangram_tpu_torch.scripts import gen_api_docs, gen_tutorial_notebook

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_api_docs_generate(tmp_path):
    pages = gen_api_docs.generate(str(tmp_path))
    assert "index.md" in pages
    spatial = pages["tangram_tpu_torch_spatial.md"]
    assert "spatial_neighbors" in spatial and "coord_type" in spatial
    mapper = pages["tangram_tpu_torch_models_mapper.md"]
    assert "fit_mapping" in mapper and "class `Mapper" in mapper
    assert "ops.pallas_core" not in pages["index.md"]
    # every documented module links from the index, and every public name
    # of a module is on its page
    for mod in gen_api_docs.MODULES:
        page = pages[mod.replace(".", "_") + ".md"]
        assert f"`{mod}`" in pages["index.md"]
        for name in gen_api_docs._public_names(importlib.import_module(mod)):
            assert f"`{name}" in page or f"`tgt.{name}`" in page, (mod, name)
    # nothing that names where the docs were generated
    for page in pages.values():
        assert REPO not in page and " at 0x" not in page


def test_api_docs_committed_and_current():
    """docs/reference_torch is committed and regenerating it is a no-op
    (the generator's --check mode)."""
    ref_dir = os.path.join(REPO, "docs", "reference_torch")
    assert os.path.isdir(ref_dir), "run python -m tangram_tpu_torch.scripts.gen_api_docs"
    rc = gen_api_docs.main(["--check", "--outdir", ref_dir])
    assert rc == 0, "docs/reference_torch stale: rerun tangram_tpu_torch.scripts.gen_api_docs"


def test_tutorial_notebook_valid():
    path = os.path.join(REPO, "notebooks", "tutorial_tangram_tpu_torch.ipynb")
    assert os.path.exists(path), "run python -m tangram_tpu_torch.scripts.gen_tutorial_notebook"
    with open(path) as f:
        nb = json.load(f)
    assert nb == gen_tutorial_notebook.build()
    assert nb["nbformat"] == 4
    kinds = {c["cell_type"] for c in nb["cells"]}
    assert kinds == {"markdown", "code"}
    imported = set()
    for c in nb["cells"]:
        if c["cell_type"] == "code":
            assert c["outputs"] == [] and c["execution_count"] is None
            tree = ast.parse("".join(c["source"]))  # syntax-valid
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    imported.update(a.name.split(".")[0] for a in node.names)
                elif isinstance(node, ast.ImportFrom):
                    imported.add(node.module.split(".")[0])
    joined = "".join(
        "".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"
    )
    for call in ("pp_adatas", "map_cells_to_space", "project_genes",
                 "cross_val", "eval_metric"):
        assert call in joined
    assert "tangram_tpu_torch" in imported
    assert "jax" not in imported and "tangram_tpu" not in imported
    # every call that trains names its device
    for call in ("map_cells_to_space(", "cross_val("):
        for part in joined.split(call)[1:]:
            assert "device=DEVICE" in part.split("\n)")[0], call
