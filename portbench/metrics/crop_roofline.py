"""``kernels/csrc/crop_resize.cu``: one call is one ``crop_rows`` or
``crop_pixels`` launch."""

from portbench.metrics._roofline import share

UNIT = "%"


def read(run):
    return share(run, "crop", ("crop_rows", "crop_pixels"),
                 ("crop_rows", "crop_pixels"))
