"""Profiling: named host intervals + optional torch.profiler traces.

Reference parity: the engine Profiler threaded into kernels
(``profiler_->add_interval("caffe:net", ...)``, caffe_kernel.cpp:383-388) and
``sc.table(t).profiler().write_trace('x.tar.gz')``
(draft/scannertools_pytorch/tests/test_all.py:23). We keep the same interval
names where ops overlap (e.g. ``files_source:read:data``) and export
chrome-trace JSON readable by Perfetto; ``torch_trace`` wraps a run in a
torch.profiler trace for device-side timelines.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional


class Profiler:
    def __init__(self):
        self._intervals: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.add_interval(name, start, end, **meta)

    def add_interval(self, name: str, start: float, end: float, **meta) -> None:
        with self._lock:
            self._intervals.append(
                {
                    "name": name,
                    "ts": (start - self._t0) * 1e6,
                    "dur": (end - start) * 1e6,
                    "tid": threading.get_ident() % 100000,
                    "meta": meta,
                }
            )

    def count(self, name: str, **meta) -> None:
        """Record an event of no duration (read back by ``counts()``)."""
        now = time.perf_counter()
        self.add_interval(name, now, now, **meta)

    def totals(self) -> Dict[str, float]:
        """Total seconds per interval name."""
        out: Dict[str, float] = {}
        with self._lock:
            for iv in self._intervals:
                out[iv["name"]] = out.get(iv["name"], 0.0) + iv["dur"] / 1e6
        return out

    def counts(self) -> Dict[str, int]:
        """Number of intervals per interval name (events such as
        ``job:warm_failed`` are counted here)."""
        out: Dict[str, int] = {}
        with self._lock:
            for iv in self._intervals:
                out[iv["name"]] = out.get(iv["name"], 0) + 1
        return out

    def intervals(self, name: str) -> List[dict]:
        """Copies of the recorded intervals called ``name`` ({"ts", "dur"}
        in microseconds from the profiler's start, "meta"), in record
        order."""
        with self._lock:
            return [dict(iv) for iv in self._intervals if iv["name"] == name]

    def write_trace(self, path: str) -> None:
        """Chrome trace event format (open in Perfetto / chrome://tracing)."""
        with self._lock:
            events = [
                {
                    "name": iv["name"],
                    "ph": "X",
                    "ts": iv["ts"],
                    "dur": iv["dur"],
                    "pid": 0,
                    "tid": iv["tid"],
                    "args": iv["meta"],
                }
                for iv in self._intervals
            ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


@contextlib.contextmanager
def torch_trace(logdir: Optional[str]):
    """Optionally wrap a block in a torch.profiler trace, written to
    ``<logdir>/trace.json`` (chrome-trace format). CUDA activity is traced
    when a card is present."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
