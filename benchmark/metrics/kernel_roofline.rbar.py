"""Per-layer metric kernel_roofline.rbar: see ``benchmark.readers_spans.rbar_roofline``."""

from benchmark.readers_spans import rbar_roofline as read  # noqa: F401
