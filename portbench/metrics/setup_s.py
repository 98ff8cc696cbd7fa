"""From the process's start to the end of the warm packet: imports, the
CUDA context, the kernels, the frames, the weights written as the program
reads them, one warm packet. The reference's own draw of the weights and
setting of the heads is timed apart and left out."""

UNIT = "s"


def read(run):
    return run.setup_s
