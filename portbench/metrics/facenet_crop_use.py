"""FaceNet's useful crops: the faces ``EmbedDecode`` kept over the crops
``FaceEmbedForward`` ran (the padded batch of ``faces_budget`` a frame),
counted by the program in the window, in percent."""

from portbench.metrics import _program

_program.install()

UNIT = "%"


def read(run):
    crops = _program.counted(run, "embed:crops")
    faces = _program.counted(run, "embed:faces")
    if not crops or faces is None:
        return None
    return 100.0 * faces / crops
