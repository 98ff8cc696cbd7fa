"""The program's ``source:read`` and ``source:upload`` spans (the ring
read and the host-to-device upload) inside the window, per stored frame."""

UNIT = "ms"


def read(run):
    inside = [min(e, run.t1) - max(s, run.t0)
              for name in ("source:read", "source:upload")
              for s, e in run.spans.get(name, [])
              if e > run.t0 and s < run.t1]
    if not run.frames or not inside:
        return None
    return sum(inside) * 1e3 / run.frames
