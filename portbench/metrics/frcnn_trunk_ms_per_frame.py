"""The program's ``stream:FasterRCNN:trunk`` intervals inside the window,
per stored frame: the card's stream on VGG16's conv1_1..conv5_3,
``rpn_conv`` and its two 1x1 heads (nested in ``stream:FasterRCNN``)."""

from portbench.metrics import _program

_program.install()

UNIT = "ms"


def read(run):
    return _program.ms_per_frame(run, ["stream:FasterRCNN:trunk"])
