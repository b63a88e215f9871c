"""Per-layer metric kernel_roofline.stack_dm_adam: see ``benchmark.readers_graph.stack_dm_adam_roofline``."""

from benchmark.readers_graph import stack_dm_adam_roofline as read  # noqa: F401
