"""``nms_roofline`` in the Faster R-CNN cell."""

from portbench.metrics.nms_roofline import UNIT, read  # noqa: F401
