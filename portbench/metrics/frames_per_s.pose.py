"""``frames_per_s`` in the pose cells, where it moves ``frames_per_s.pose``."""

from portbench.metrics.frames_per_s import UNIT, read  # noqa: F401
