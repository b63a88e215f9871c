"""The small shapes of the CPU tests for the configurations that
``tests/conftest.py``'s ``TINY`` does not name: every configuration in
``BENCHMARK.json`` needs one there, since each test's manifest copies them
all. ``mop_slideseq_bf16`` takes ``mop_slideseq``'s shapes and 200 epochs:
after fewer, the rounding noise of bf16 storage still hides the controls
of its check (``tests/test_bench_sr.py``)."""

from benchmark.tests.conftest import TINY

TINY.setdefault("mop_slideseq_bf16", dict(TINY["mop_slideseq"], num_epochs=200))
