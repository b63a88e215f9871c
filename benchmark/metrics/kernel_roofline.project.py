"""Per-layer metric kernel_roofline.project: see ``benchmark.readers_spans.project_roofline``."""

from benchmark.readers_spans import project_roofline as read  # noqa: F401
