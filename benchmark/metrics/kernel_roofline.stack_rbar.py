"""Per-layer metric kernel_roofline.stack_rbar: see ``benchmark.readers_graph.stack_rbar_roofline``."""

from benchmark.readers_graph import stack_rbar_roofline as read  # noqa: F401
