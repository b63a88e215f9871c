"""Per-layer metric shell.graph_inputs_s: see ``benchmark.readers_graph.graph_inputs_s``."""

from benchmark.readers_graph import graph_inputs_s as read  # noqa: F401
