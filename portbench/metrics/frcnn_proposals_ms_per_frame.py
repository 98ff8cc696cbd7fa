"""The program's ``stream:FasterRCNN:proposals`` intervals inside the
window, per stored frame: the card's stream on the proposal layer (the fg
softmax, the decode and clip, the top ``pre_nms`` in stable order, the
``nms`` call), nested in ``stream:FasterRCNN``."""

from portbench.metrics import _program

_program.install()

UNIT = "ms"


def read(run):
    return _program.ms_per_frame(run, ["stream:FasterRCNN:proposals"])
