"""The port's namespace against the JAX package's.

Every public name of ``tangram_tpu`` resolves on ``tangram_tpu_torch`` with
the same call signature (parameter names, kinds and defaults; annotations
name each package's array type and are not compared), and so does every
name of the ``__all__`` of every module of ``tangram_tpu`` (walked with
``pkgutil.walk_packages``) on the port's module of the same path, except
for explicit lists: the names still waiting for their slice of the port
(ROADMAP queue A), the names that are not ported, the names the port
gives another path, and the deliberate signature differences (keyed by
where the port defines the name). A name that lands must leave
``WAITING``; a new difference must be listed with its reason.
"""

import importlib
import inspect
import pkgutil
import types

import pytest

import tangram_tpu as tg
import tangram_tpu_torch as tgt

#: names not ported yet, by ROADMAP item
WAITING = {}
#: names that are not ported (ROADMAP "Do not port")
DROPPED = {"enable_compilation_cache": "XLA's persistent compilation cache (TPU-only)"}
#: names the port gives another path (module path, name), with the reason
RENAMED = {
    "ops.pallas_core.mapper_core_pallas": (
        "ops.cuda_core.MapperCore",
        "the Pallas core's forward and custom VJP are the CUDA kernels' autograd "
        "Function, MapperCore.apply(M, A, w) -> (Y, q, h), beside its launchers"),
}
#: deliberate signature differences, keyed by where the port defines the
#: name: the port's parameters are the JAX package's plus ``added``, with
#: the defaults of ``changed`` differing
SIGNATURE_DIFFERENCES = {
    "models.mapper.init_logits": dict(added=["device"], changed=["dtype"],
                                      why="dtype is a torch dtype; the draw's device"),
    "evaluation.projected_expression": dict(added=["device"], changed=[],
                                            why="the card the chunks stream through"),
    "profiling.benchmark_mapping": dict(added=["device"], changed=[],
                                        why="the device the fits run on"),
    "parallel.mesh.init_distributed": dict(
        added=["backend"], changed=[], why="NCCL on the card unless the caller names gloo"),
    "parallel.fused_sharded.fit_mapping_fused_sharded": dict(
        added=[], changed=["moment_dtype", "compute_dtype"],
        why="dtypes named as the port's fit_mapping names them"),
    "ops.fused_step.fused_unconstrained_step": dict(
        added=["A_op"], changed=["compute_dtype"],
        why="a torch dtype; the dP tiles' A operand, built once per fit"),
    "ops.fused_step.fused_unconstrained_step_adafactor": dict(
        added=["A_op"], changed=["compute_dtype"],
        why="as fused_unconstrained_step"),
    "ops.fused_step.fused_constrained_step": dict(added=[], changed=["compute_dtype"],
                                                  why="a torch dtype"),
    "ops.fused_step.init_fused_opt_state": dict(added=[], changed=["moment_dtype"],
                                                why="a torch dtype"),
}
#: JAX's fit_mapping is a buffer-donating wrapper ``(*args, donate=False,
#: **kwargs)`` around its jitted core; the port's takes its keywords
#: explicitly (PyTorch updates M in place instead of donating it)
EXPLICIT = {"models.mapper.fit_mapping"}

PORTED = sorted(set(tg.__all__) - set(WAITING) - set(DROPPED))

#: every module of the JAX package but the root (``test_name_matches_jax``
#: holds the flat names), by its path below the package
JAX_MODULES = {info.name.removeprefix("tangram_tpu."): importlib.import_module(info.name)
               for info in pkgutil.walk_packages(tg.__path__, "tangram_tpu.")}
#: each name of each module's ``__all__`` as "module path.name"
MODULE_NAMES = sorted(f"{path}.{name}" for path, module in JAX_MODULES.items()
                      for name in getattr(module, "__all__", ()))


def params(fn):
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


def home(obj) -> str:
    """Where the port defines ``obj``: its module path below the package
    and its name."""
    return f"{obj.__module__.removeprefix('tangram_tpu_torch.')}.{obj.__qualname__}"


def resolve(root, path: str):
    for part in path.split("."):
        root = getattr(root, part)
    return root


def assert_same_call(qualname, got, want):
    key = home(got)
    if key in EXPLICIT:
        kinds = {p.kind for p in inspect.signature(got).parameters.values()}
        assert inspect.Parameter.VAR_POSITIONAL not in kinds, qualname
        return
    g, w = params(got), params(want)
    diff = SIGNATURE_DIFFERENCES.get(key, dict(added=[], changed=[]))
    assert [p[0] for p in g] == [p[0] for p in w] + diff["added"], qualname
    for (name, kind, default), (_, want_kind, want_default) in zip(g, w):
        assert kind == want_kind, f"{qualname}: {name}"
        if name not in diff["changed"]:
            assert default == want_default, f"{qualname}: {name}"


def test_the_port_resolves_78_of_the_79_names():
    """The port resolves 78 of the 79 names, all but the TPU-only one."""
    assert len(tg.__all__) == 79
    assert len(PORTED) == 78
    assert sorted(set(tg.__all__) - set(tgt.__all__)) == sorted(set(WAITING) | set(DROPPED))
    assert set(tgt.__all__) == set(PORTED)
    assert dir(tgt) == tgt.__all__
    assert tgt.__version__ == tg.__version__
    for name in list(WAITING) + list(DROPPED):
        with pytest.raises(AttributeError):
            getattr(tgt, name)


@pytest.mark.parametrize("name", PORTED)
def test_name_matches_jax(name):
    want = getattr(tg, name)
    got = getattr(tgt, name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        assert got.__name__ == "tangram_tpu_torch." + name.split(".")[-1]
        for sub in getattr(want, "__all__", []):
            if sub in DROPPED:
                assert not hasattr(got, sub)
                continue
            assert hasattr(got, sub), f"{name}.{sub}"
            if callable(getattr(want, sub)):
                assert_same_call(f"{name}.{sub}", getattr(got, sub), getattr(want, sub))
        return
    if isinstance(want, type) or callable(want):
        assert callable(got)
        assert_same_call(name, got, want)
    else:
        assert got == want


def test_signature_differences_are_real():
    """Each listed difference exists (a fixed one must leave the list)."""
    for qualname, diff in SIGNATURE_DIFFERENCES.items():
        got, want = resolve(tgt, qualname), resolve(tg, qualname)
        assert home(got) == qualname
        assert params(got) != params(want), qualname
        names = [p[0] for p in params(got)]
        assert names[len(names) - len(diff["added"]):] == diff["added"]


def test_every_module_is_ported_but_one_rename_and_one_drop():
    """The walk reaches every module of the JAX package; each name of each
    ``__all__`` is on the port's module of the same path, but for the one
    renamed name and the one TPU-only name."""
    assert {"models.mapper", "ops.pallas_core", "ops.fused_step", "parallel.mesh",
            "utils", "tuning"} <= set(JAX_MODULES)
    missing = set()
    for qualname in MODULE_NAMES:
        path, name = qualname.rsplit(".", 1)
        try:
            port = importlib.import_module("tangram_tpu_torch." + path)
        except ModuleNotFoundError:
            port = None
        if port is None or not hasattr(port, name):
            missing.add(qualname)
    assert len(RENAMED) == 1 and len(DROPPED) == 1
    assert missing == set(RENAMED) | {"utils.enable_compilation_cache"}
    assert set(WAITING) == set()


def test_models_mapper_all_equals_jax():
    """The optimizer factories are ported: ``models.mapper.__all__`` is
    JAX's, ``make_optimizer`` beside them."""
    from tangram_tpu.models import mapper as jm
    from tangram_tpu_torch.models import mapper as tm

    assert tm.__all__ == jm.__all__
    assert_same_call("models.mapper.make_optimizer", tm.make_optimizer, jm.make_optimizer)


@pytest.mark.parametrize("qualname", MODULE_NAMES)
def test_module_name_matches_jax(qualname):
    """Each name of a JAX module's ``__all__`` on the port's module of the
    same path, with the same call signature (or a listed difference); a
    renamed name at its new path; a dropped one absent."""
    path, name = qualname.rsplit(".", 1)
    want = getattr(JAX_MODULES[path], name)
    if qualname in RENAMED:
        new_path, _ = RENAMED[qualname]
        got = resolve(importlib.import_module("tangram_tpu_torch." + new_path.rsplit(".", 1)[0]),
                      new_path.rsplit(".", 1)[1])
        assert callable(got) and callable(want)
        return
    port = importlib.import_module("tangram_tpu_torch." + path)
    if name in DROPPED:
        assert not hasattr(port, name)
        return
    got = getattr(port, name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        assert got.__name__ == want.__name__.replace("tangram_tpu", "tangram_tpu_torch", 1)
    elif callable(want):
        assert callable(got)
        assert_same_call(qualname, got, want)
    else:
        assert got == want
