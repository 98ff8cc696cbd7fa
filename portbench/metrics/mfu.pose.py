"""``mfu`` in the pose cells, where it moves ``frames_per_s.pose``."""

from portbench.metrics.mfu import UNIT, read  # noqa: F401
