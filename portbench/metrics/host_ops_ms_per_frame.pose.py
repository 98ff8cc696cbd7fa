"""``host_ops_ms_per_frame`` in the pose cells, where it moves ``frames_per_s.pose``."""

from portbench.metrics.host_ops_ms_per_frame import UNIT, read  # noqa: F401
