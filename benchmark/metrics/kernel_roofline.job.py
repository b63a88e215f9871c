"""Per-layer metric kernel_roofline.job: see ``benchmark.readers.kernel_roofline``."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
