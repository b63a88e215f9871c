"""Per-layer metric shell.init_draw_s: see ``benchmark.readers_spans.init_draw_s``."""

from benchmark.readers_spans import init_draw_s as read  # noqa: F401
