"""Per-layer metric shell.other_s: see ``benchmark.readers.shell_other_s``."""

from benchmark.readers import shell_other_s as read  # noqa: F401
