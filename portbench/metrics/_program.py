"""The program's spans and counters that the harness's own list of names
leaves out: ``stream:<Op>`` (a device op's time on its CUDA stream),
``host:wait_device`` (the host blocked on a copy from the card),
``load:<Op>`` (an op's weights loaded at first use), and the counters
``embed:crops`` and ``embed:faces`` (FaceNet's crops run and faces kept).

A reader of these calls ``install`` as it is loaded, before the harness
collects the spans: ``harness._spans`` then also collects every span of
those names the program recorded, on the same clock, and ``run.spans``
gets a ``counters`` attribute, {name: [(time, n)]}. A program that records
none of them gives none, and the readers return None.

They describe the card (the host waiting for it, its streams, the weights
put on it), so they are read in a run on a card only.
"""

from __future__ import annotations

from portbench import harness

SPANS = ("stream:", "host:wait_device", "load:")
COUNTERS = ("embed:crops", "embed:faces")


class Spans(dict):
    """{name: [(start, end)]}, with ``counters``: {name: [(time, n)]}."""


def _widened(collect):
    def spans(sc, names, anchor_t, anchor_name):
        out = Spans(collect(sc, names, anchor_t, anchor_name))
        extra = [n for n in sc.profiler.counts()
                 if n.startswith(SPANS) and n not in out]
        out.update(collect(sc, extra, anchor_t, anchor_name))
        off = anchor_t - sc.profiler.intervals(anchor_name)[-1]["ts"] / 1e6
        out.counters = {name: [(off + iv["ts"] / 1e6, iv["meta"].get("n", 1))
                               for iv in sc.profiler.intervals(name)]
                        for name in COUNTERS}
        return out

    spans.widened = True
    return spans


def install() -> None:
    """Widen ``harness._spans`` once in this process."""
    if not getattr(harness._spans, "widened", False):
        harness._spans = _widened(harness._spans)


def ms_per_frame(run, names):
    """The spans of ``names`` clipped to the window, in ms per stored
    frame; None off the card or where the program recorded none."""
    inside = [min(e, run.t1) - max(s, run.t0)
              for name in names
              for s, e in run.spans.get(name, [])
              if e > run.t0 and s < run.t1]
    if run.busy_s is None or not run.frames or not inside:
        return None
    return sum(inside) * 1e3 / run.frames


def counted(run, name):
    """The ``n`` of the counter's events inside the window; None off the
    card or where the program counted none."""
    events = [n for t, n in getattr(run.spans, "counters", {}).get(name, [])
              if run.t0 <= t <= run.t1]
    if run.busy_s is None or not events:
        return None
    return sum(events)
