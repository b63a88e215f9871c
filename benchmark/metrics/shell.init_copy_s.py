"""Per-layer metric shell.init_copy_s: see ``benchmark.readers_spans.init_copy_s``."""

from benchmark.readers_spans import init_copy_s as read  # noqa: F401
