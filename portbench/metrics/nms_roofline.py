"""``kernels/csrc/nms.cu``: one call is ``nms_shared``, or
``nms_sort_global`` then ``nms_mask_walk_global``."""

from portbench.metrics._roofline import share

UNIT = "%"


def read(run):
    return share(run, "nms", ("nms_shared", "nms_sort_global",
                              "nms_mask_walk_global"),
                 ("nms_shared", "nms_sort_global"))
