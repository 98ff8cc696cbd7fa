"""The program's ``stream:OpenPoseForward`` intervals inside the window,
per stored frame: the time the card's stream spent on the body net, its
peaks and limb scores, from the moment it reached the op's first work to
the moment it finished its last (so with any starvation inside the op)."""

from portbench.metrics import _program

_program.install()

UNIT = "ms"


def read(run):
    return _program.ms_per_frame(run, ["stream:OpenPoseForward"])
