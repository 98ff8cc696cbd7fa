"""``weights_load_s`` in the Faster R-CNN cell."""

from portbench.metrics.weights_load_s import UNIT, read  # noqa: F401
