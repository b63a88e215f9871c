"""Per-layer metric mfu.job: see ``benchmark.readers.mfu``."""

from benchmark.readers import mfu as read  # noqa: F401
