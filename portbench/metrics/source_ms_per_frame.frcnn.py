"""``source_ms_per_frame`` in the Faster R-CNN cell."""

from portbench.metrics.source_ms_per_frame import UNIT, read  # noqa: F401
