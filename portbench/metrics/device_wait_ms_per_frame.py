"""The program's ``host:wait_device`` spans inside the window, per stored
frame: the executor's thread blocked on a copy from the card (into a host
op, into a sink, or inside a host op that takes device values, as
OpenPoseDecode does)."""

from portbench.metrics import _program

_program.install()

UNIT = "ms"


def read(run):
    return _program.ms_per_frame(run, ["host:wait_device"])
