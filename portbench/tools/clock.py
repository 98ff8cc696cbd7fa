"""The clock check: do the program's ``stream:<Op>`` intervals, put on the
host's perf_counter clock by the program's own calibration, hold the
kernels that torch.profiler traced on the card in the same window?

    python3 -m portbench.tools.clock --workload pose_detection.crowd \
        --seed 3300000101 --seconds 30

runs one traced run of the cell through the harness and prints one JSON
line: the share of the traced window's kernel time that lies inside some
``stream:`` interval (the side stream's uploads and the copies to the
host, ``Memcpy HtoD`` and ``Memcpy DtoH``, left out), the median offset
between each interval's end and the end of the last kernel that starts
inside it, the seconds each of the program's spans covers in the window,
and the run's result (its per-layer metrics). Both clocks are
perf_counter's: the harness moves torch.profiler's timestamps there, the
program its CUDA events.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def check(events, spans, t0: float, t1: float) -> dict:
    """``events``: the trace's (name, start, seconds) in the window;
    ``spans``: the program's {name: [(start, end)]} on the same clock ->
    {"kernel_s", "inside_s", "share" (%), "intervals", "median_end_offset_us"
    (None without an interval that holds a kernel), "spans_s": {name:
    seconds inside the window}}."""
    kernels = [(s, s + d) for n, s, d in events
               if not n.startswith(COPIES) and t0 <= s < t1]
    streams = [(s, e) for name, ivs in spans.items()
               if name.startswith("stream:") for s, e in ivs
               if e > t0 and s < t1]
    union = _union(streams)
    starts = [s for s, _ in union]
    inside = 0.0
    for a, b in kernels:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(union) and union[i][0] < b:
            inside += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
            i += 1
    k_starts = [a for a, _ in kernels]
    offsets = []
    for s, e in streams:
        lo, hi = bisect.bisect_left(k_starts, s), bisect.bisect_right(
            k_starts, e)
        if hi > lo:
            offsets.append(e - max(b for _, b in kernels[lo:hi]))
    total = sum(b - a for a, b in kernels)
    spans_s = {name: sum(min(e, t1) - max(s, t0) for s, e in ivs
                         if e > t0 and s < t1)
               for name, ivs in spans.items()}
    return {"kernel_s": total, "inside_s": inside,
            "share": 100.0 * inside / total if total else None,
            "intervals": len(streams),
            "median_end_offset_us": statistics.median(offsets) * 1e6
            if offsets else None,
            "spans_s": {k: v for k, v in sorted(spans_s.items()) if v}}


def traced_run(bench, cell, seed, seconds, device="cuda", log=None):
    """One traced run -> (the clock check, the run's result)."""
    from portbench import harness
    from portbench.metrics import _program

    _program.install()
    seen = {}
    breakdown = harness._breakdown

    def keep(events, busy, spans, t0, t1):
        seen.update(events=events, spans=spans, t0=t0, t1=t1)
        return breakdown(events, busy, spans, t0, t1)

    harness._breakdown = keep
    try:
        out = harness.run_cell(bench, cell, seed, seconds, True, device,
                               log=log)
    finally:
        harness._breakdown = breakdown
    if not seen:
        raise RuntimeError("the traced window recorded no device activity")
    return check(seen["events"], seen["spans"], seen["t0"], seen["t1"]), \
        out["result"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.run import _env

    _env()
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    clock, result = traced_run(
        bench, args.workload, args.seed, args.seconds,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "clock": clock, "result": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
