"""Per-layer metric shell.result_s: see ``benchmark.readers_spans.result_s``."""

from benchmark.readers_spans import result_s as read  # noqa: F401
