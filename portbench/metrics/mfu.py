"""The float32 operations the stored frames needed (the configuration's
counter: MTCNN's R- and O-Net on the candidates that passed the stage
before, FaceNet on the faces kept, never a padded slot), over the seconds
of the untraced window, as a share of the H100's 67 TFLOP/s outside the
tensor cores. Read in a traced run on a card only."""

from portbench.roofline import FP32_OPS_PER_S

UNIT = "%"


def read(run):
    if run.busy_s is None or not run.flops:
        return None
    return 100.0 * run.flops / run.seconds / FP32_OPS_PER_S
