"""The program's ``stream:FasterRCNN`` intervals inside the window, per
stored frame: the time the card's stream spent on the Faster R-CNN
forward (the VGG16 trunk and RPN, the proposals, the RoI head), from the
moment it reached the op's first work to the moment it finished its last
(so with any starvation inside the op)."""

from portbench.metrics import _program

_program.install()

UNIT = "ms"


def read(run):
    return _program.ms_per_frame(run, ["stream:FasterRCNN"])
