"""The share of the traced window in which no kernel or copy ran on the
card, from torch.profiler's CUDA activity."""

UNIT = "%"


def read(run):
    if not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
