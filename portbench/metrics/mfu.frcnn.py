"""``mfu`` in the Faster R-CNN cell."""

from portbench.metrics.mfu import UNIT, read  # noqa: F401
