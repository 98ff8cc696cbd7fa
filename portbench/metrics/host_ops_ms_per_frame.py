"""The program's ``op:<name>`` spans of the configuration's host ops
(decodes, grouping) inside the window, per stored frame."""

UNIT = "ms"


def read(run):
    inside = [min(e, run.t1) - max(s, run.t0)
              for name in run.host_ops
              for s, e in run.spans.get(f"op:{name}", [])
              if e > run.t0 and s < run.t1]
    if not run.frames or not inside:
        return None
    return sum(inside) * 1e3 / run.frames
