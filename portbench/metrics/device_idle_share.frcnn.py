"""``device_idle_share`` in the Faster R-CNN cell."""

from portbench.metrics.device_idle_share import UNIT, read  # noqa: F401
