"""Gives the benchmark's CPU tests the small shapes of
``mop_slideseq_spatial``.

Each of those tests copies every configuration of ``BENCHMARK.json`` at
the shapes that ``benchmark/tests/conftest.py``'s ``TINY`` names, so every
configuration needs an entry there, whichever test files run. This one
is added as that module registers: ``mop_slideseq``'s shapes, 100 epochs.
"""


def pytest_plugin_registered(plugin, manager):
    if getattr(plugin, "__name__", None) == "benchmark.tests.conftest":
        plugin.TINY.setdefault("mop_slideseq_spatial",
                               dict(plugin.TINY["mop_slideseq"], num_epochs=100))
