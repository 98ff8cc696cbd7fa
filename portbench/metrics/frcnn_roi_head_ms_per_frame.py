"""The program's ``stream:FasterRCNN:roi_head`` intervals inside the
window, per stored frame: the card's stream on the RoI head (the 7x7 crop
at C = 512, fc6, fc7, ``cls_score`` and its softmax, the masking of the
rows not kept), nested in ``stream:FasterRCNN``."""

from portbench.metrics import _program

_program.install()

UNIT = "ms"


def read(run):
    return _program.ms_per_frame(run, ["stream:FasterRCNN:roi_head"])
