"""Per-layer metric loop.dispatch_ms: see ``benchmark.readers.dispatch_ms``."""

from benchmark.readers import dispatch_ms as read  # noqa: F401
