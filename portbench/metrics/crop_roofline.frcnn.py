"""``crop_roofline`` in the Faster R-CNN cell."""

from portbench.metrics.crop_roofline import UNIT, read  # noqa: F401
