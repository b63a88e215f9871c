"""Per-layer metric device_idle.job: see ``benchmark.readers.device_idle``."""

from benchmark.readers import device_idle as read  # noqa: F401
