"""``host_ops_ms_per_frame`` in the Faster R-CNN cell."""

from portbench.metrics.host_ops_ms_per_frame import UNIT, read  # noqa: F401
