"""``kernels/csrc/peaks.cu``: one call is one ``pose_peaks`` launch."""

from portbench.metrics._roofline import share

UNIT = "%"


def read(run):
    return share(run, "peaks", ("pose_peaks",), ("pose_peaks",))
