"""Per-layer metric graph.epilogue_ms: see ``benchmark.readers_graph.epilogue_ms``."""

from benchmark.readers_graph import epilogue_ms as read  # noqa: F401
