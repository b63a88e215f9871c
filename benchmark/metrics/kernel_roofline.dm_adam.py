"""Per-layer metric kernel_roofline.dm_adam: see ``benchmark.readers_spans.dm_adam_roofline``."""

from benchmark.readers_spans import dm_adam_roofline as read  # noqa: F401
