"""The port's flat namespace against the JAX package's.

Every public name of ``tangram_tpu`` resolves on ``tangram_tpu_torch`` with
the same call signature (parameter names, kinds and defaults; annotations
name each package's array type and are not compared), and every name of
a shared submodule's ``__all__`` does too, except for two explicit lists:
the names still waiting for their slice of the port (ROADMAP queue A) and
the deliberate signature differences. A name that lands must leave
``WAITING``; a new difference must be listed with its reason.
"""

import inspect
import types

import pytest

import tangram_tpu as tg
import tangram_tpu_torch as tgt

#: names not ported yet, by ROADMAP item
WAITING = {"parallel": "A11"}
#: names that are not ported (ROADMAP "Do not port")
DROPPED = {"enable_compilation_cache": "XLA's persistent compilation cache (TPU-only)"}
#: deliberate signature differences: the port's parameters are the JAX
#: package's plus ``added``, with the defaults of ``changed`` differing
SIGNATURE_DIFFERENCES = {
    "init_logits": dict(added=["device"], changed=["dtype"],
                        why="dtype is a torch dtype; the draw's device"),
    "models.init_logits": dict(added=["device"], changed=["dtype"],
                               why="as init_logits"),
    "evaluation.projected_expression": dict(added=["device"], changed=[],
                                            why="the card the chunks stream through"),
    "profiling.benchmark_mapping": dict(added=["device"], changed=[],
                                        why="the device the fits run on"),
}
#: JAX's fit_mapping is a buffer-donating wrapper ``(*args, donate=False,
#: **kwargs)`` around its jitted core; the port's takes its keywords
#: explicitly (PyTorch updates M in place instead of donating it)
EXPLICIT = {"fit_mapping", "models.fit_mapping"}

PORTED = sorted(set(tg.__all__) - set(WAITING) - set(DROPPED))


def params(fn):
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


def assert_same_call(qualname, got, want):
    if qualname in EXPLICIT:
        kinds = {p.kind for p in inspect.signature(got).parameters.values()}
        assert inspect.Parameter.VAR_POSITIONAL not in kinds, qualname
        return
    g, w = params(got), params(want)
    diff = SIGNATURE_DIFFERENCES.get(qualname, dict(added=[], changed=[]))
    assert [p[0] for p in g] == [p[0] for p in w] + diff["added"], qualname
    for (name, kind, default), (_, want_kind, want_default) in zip(g, w):
        assert kind == want_kind, f"{qualname}: {name}"
        if name not in diff["changed"]:
            assert default == want_default, f"{qualname}: {name}"


def test_the_port_resolves_68_of_the_79_names():
    """Since the tuner landed the port resolves 77 of the 79 names (the
    test keeps its first name)."""
    assert len(tg.__all__) == 79
    assert len(PORTED) == 77
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
        path = qualname.split(".")
        got, want = tgt, tg
        for part in path:
            got, want = getattr(got, part), getattr(want, part)
        assert params(got) != params(want), qualname
        assert [p[0] for p in params(got)][-len(diff["added"]):] == diff["added"]
