"""Per-layer metric shell.mapper_init_s: see ``benchmark.readers.mapper_init_s``."""

from benchmark.readers import mapper_init_s as read  # noqa: F401
