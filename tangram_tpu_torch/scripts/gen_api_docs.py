"""Generate the markdown API reference of ``tangram_tpu_torch`` under
``docs/reference_torch/`` (the port of ``scripts/gen_api_docs.py``).

A small introspection-based generator (no sphinx or pdoc needed): one
page per module, signatures and docstrings for every public symbol (the
module's ``__all__`` when it defines one, else the names it defines that
do not start with an underscore); class entries include their public
methods. A submodule re-exported by a package is listed by name, not
rendered: its own page carries it.

Regenerate after docstring changes::

    python -m tangram_tpu_torch.scripts.gen_api_docs            # writes docs/reference_torch/
    python -m tangram_tpu_torch.scripts.gen_api_docs --check    # exit 1 if out of date
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import sys
import tempfile

__all__ = ["MODULES", "render_module", "generate", "main"]

#: the counterparts of the JAX package's documented modules (its
#: ``ops.pallas_core`` is ``ops.cuda_core`` here), then the port's own
MODULES = [
    "tangram_tpu_torch",
    "tangram_tpu_torch.mapping",
    "tangram_tpu_torch.models.mapper",
    "tangram_tpu_torch.evaluation",
    "tangram_tpu_torch.deconv",
    "tangram_tpu_torch.spatial",
    "tangram_tpu_torch.tuning",
    "tangram_tpu_torch.search",
    "tangram_tpu_torch.gene_selection",
    "tangram_tpu_torch.cell_selection",
    "tangram_tpu_torch.checkpoint",
    "tangram_tpu_torch.profiling",
    "tangram_tpu_torch.plot_utils",
    "tangram_tpu_torch.adlite",
    "tangram_tpu_torch.utils",
    "tangram_tpu_torch.ops.core",
    "tangram_tpu_torch.ops.losses",
    "tangram_tpu_torch.ops.schedules",
    "tangram_tpu_torch.ops.fused_step",
    "tangram_tpu_torch.ops.cuda_core",
    "tangram_tpu_torch.parallel.mesh",
    "tangram_tpu_torch.parallel.fused_sharded",
    "tangram_tpu_torch.ops.optim",
    "tangram_tpu_torch.convert",
    "tangram_tpu_torch.north_star",
]

ROOT = "tangram_tpu_torch"
OUTDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "docs", "reference_torch")


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or "*(undocumented)*"


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", None) != mod.__name__ and not isinstance(
                obj, (int, float, str, list, dict, tuple, set)):
            continue
        out.append(name)
    return out


def _render_symbol(name, obj, level="##"):
    lines = []
    if inspect.ismodule(obj):
        lines.append(f"{level} module `{name}`\n")
        lines.append(f"`{obj.__name__}`: see its page.\n")
    elif inspect.isclass(obj):
        lines.append(f"{level} class `{name}{_signature(obj)}`\n")
        lines.append(_doc(obj) + "\n")
        for mname, meth in sorted(vars(obj).items()):
            if mname.startswith("_") or not callable(meth):
                continue
            fn = meth.__func__ if isinstance(meth, (staticmethod, classmethod)) else meth
            lines.append(f"{level}# `{name}.{mname}{_signature(fn)}`\n")
            lines.append(_doc(fn) + "\n")
    elif callable(obj):
        lines.append(f"{level} `{name}{_signature(obj)}`\n")
        lines.append(_doc(obj) + "\n")
    else:
        lines.append(f"{level} `{name}`\n")
        lines.append(f"`{type(obj).__name__}` constant: `{obj!r}`\n")
    return "\n".join(lines)


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    parts = [f"# `{modname}`\n", (inspect.getdoc(mod) or "") + "\n"]
    for name in _public_names(mod):
        try:
            obj = getattr(mod, name)
        except AttributeError:
            continue
        # the package page lists re-exports by name; their home pages carry
        # the docs
        home = getattr(obj, "__module__", modname)
        if modname == ROOT and home != ROOT:
            continue
        parts.append(_render_symbol(name, obj))
    if modname == ROOT:
        parts.append(
            "## Flat namespace\n\nEvery public symbol below is re-exported at the "
            "package root (like the reference's `tangram/__init__.py`); see its "
            "home module's page for the docs:\n")
        parts.append("\n".join(f"- `tgt.{n}`" for n in sorted(mod.__all__)) + "\n")
    return "\n".join(parts)


def generate(outdir: str) -> dict:
    """Write every page and the index into ``outdir``; returns them by file
    name."""
    pages = {}
    for modname in MODULES:
        pages[modname.replace(".", "_") + ".md"] = render_module(modname)
    index = ["# API reference of tangram_tpu_torch\n",
             "Generated by `python -m tangram_tpu_torch.scripts.gen_api_docs`: "
             "regenerate after docstring changes.\n"]
    for modname in MODULES:
        index.append(f"- [`{modname}`]({modname.replace('.', '_')}.md)")
    pages["index.md"] = "\n".join(index) + "\n"
    os.makedirs(outdir, exist_ok=True)
    for fname, content in pages.items():
        with open(os.path.join(outdir, fname), "w") as f:
            f.write(content)
    return pages


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tangram_tpu_torch.scripts.gen_api_docs",
                                description=__doc__.splitlines()[0])
    p.add_argument("--outdir", default=OUTDIR)
    p.add_argument("--check", action="store_true",
                   help="exit 1 if a page in --outdir differs from a fresh one")
    args = p.parse_args(argv)
    if args.check:
        with tempfile.TemporaryDirectory() as tmp:
            fresh = generate(tmp)
        stale = []
        for fname, content in fresh.items():
            path = os.path.join(args.outdir, fname)
            if not os.path.exists(path):
                stale.append(fname)
                continue
            with open(path) as f:
                if f.read() != content:
                    stale.append(fname)
        if stale:
            print("stale:", ", ".join(stale))
            return 1
        print(f"{args.outdir} up to date")
        return 0
    generate(args.outdir)
    print(f"wrote {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
