"""Per-layer metric mfu.stack_job: see ``benchmark.readers_graph.stack_mfu``."""

from benchmark.readers_graph import stack_mfu as read  # noqa: F401
