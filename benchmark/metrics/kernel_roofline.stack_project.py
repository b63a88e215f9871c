"""Per-layer metric kernel_roofline.stack_project: see ``benchmark.readers_graph.stack_project_roofline``."""

from benchmark.readers_graph import stack_project_roofline as read  # noqa: F401
