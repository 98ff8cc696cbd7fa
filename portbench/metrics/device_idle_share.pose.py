"""``device_idle_share`` in the pose cells, where it moves ``frames_per_s.pose``."""

from portbench.metrics.device_idle_share import UNIT, read  # noqa: F401
