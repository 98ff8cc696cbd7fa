"""Frames stored by the sink in the window over its seconds: the window
opens at a packet stored in every column and closes at the first packet
stored ``--seconds`` or more later, so no packet is in flight at either
end."""

UNIT = "frames/s"


def read(run):
    return run.frames / run.seconds if run.frames else None
