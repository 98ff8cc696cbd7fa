"""Profiling: named host intervals, device-stream intervals on the same
clock, and optional torch.profiler traces.

Reference parity: the engine Profiler threaded into kernels
(``profiler_->add_interval("caffe:net", ...)``, caffe_kernel.cpp:383-388) and
``sc.table(t).profiler().write_trace('x.tar.gz')``
(draft/scannertools_pytorch/tests/test_all.py:23). We keep the same interval
names where ops overlap (e.g. ``files_source:read:data``) and export
chrome-trace JSON readable by Perfetto; ``torch_trace`` wraps a run in a
torch.profiler trace for device-side timelines.

Every interval is on this process's ``time.perf_counter`` clock. A device
op's time on its CUDA stream (``stream_span``) is a pair of CUDA events;
``calibrate`` ties a device's event timestamps to ``perf_counter``, and
``poll`` turns finished pairs into ordinary intervals without waiting for
the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple


def _track(device) -> Optional[str]:
    """A CUDA device -> its track name ``cuda:<n>``; None for any other."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return f"cuda:{index}"


class Profiler:
    def __init__(self):
        self._intervals: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        #: track -> (calibration event, its perf_counter time)
        self._cal: Dict[str, Tuple[object, float]] = {}
        #: stream spans whose events the card has not reached yet:
        #: (name, track, calibration, start event, end event, meta)
        self._pending: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.add_interval(name, start, end, **meta)

    def add_interval(self, name: str, start: float, end: float, **meta) -> None:
        self._append(name, start, end, meta)

    def _append(self, name: str, start: float, end: float, meta: dict,
                track: Optional[str] = None) -> None:
        iv = {
            "name": name,
            "ts": (start - self._t0) * 1e6,
            "dur": (end - start) * 1e6,
            "tid": threading.get_ident() % 100000,
            "meta": meta,
        }
        if track is not None:
            iv["track"] = track
        with self._lock:
            self._intervals.append(iv)

    def count(self, name: str, **meta) -> None:
        """Record an event of no duration (read back by ``counts()``)."""
        now = time.perf_counter()
        self.add_interval(name, now, now, **meta)

    # ------------------------------------------------------ device streams

    def calibrate(self, device) -> None:
        """Tie ``device``'s CUDA event clock to ``perf_counter``: record an
        event on its current stream, wait for it, read the host clock. The
        executor calls this at the start of each job, where the stream has
        little or nothing queued, so the wait is short. Nothing for a
        device that is not CUDA."""
        track = _track(device)
        if track is None:
            return
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(torch.device(track)))
        ev.synchronize()
        t = time.perf_counter()
        with self._lock:
            self._cal[track] = (ev, t)

    @contextlib.contextmanager
    def stream_span(self, name: str, device, **meta):
        """The time ``device``'s current stream spends on the block's work,
        recorded as the interval ``name`` once the card has done it.

        One event is recorded on the stream as the block starts, one as it
        ends; neither is waited for here (``poll`` and the read methods
        resolve them). The interval runs from the moment the stream
        reaches the block's first work to the moment it finishes its last,
        so it includes any time the stream starved inside the block (the
        host still enqueueing, or blocked on a copy). Work the block puts
        on other streams or devices is not in it. Its host time is
        ``t_cal + cal.elapsed_time(ev) / 1e3`` from the device's last
        ``calibrate`` (made here if there is none yet): event timestamps
        have about half a microsecond of resolution, and the elapsed time
        is a float32 number of milliseconds, a few microseconds coarse half
        a minute after the calibration. Nothing is recorded for a device
        that is not CUDA."""
        track = _track(device)
        if track is None:
            yield
            return
        import torch

        if track not in self._cal:
            self.calibrate(track)
        stream = torch.cuda.current_stream(torch.device(track))
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            with self._lock:
                self._pending.append(
                    (name, track, self._cal[track], start, end, meta))

    def poll(self) -> None:
        """Turn the stream spans the card has finished into intervals,
        without waiting for the others."""
        self._settle(wait=False)

    def _settle(self, wait: bool) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        left = []
        for entry in pending:
            name, track, (cal, t_cal), start, end, meta = entry
            if wait:
                end.synchronize()
            elif not end.query():
                left.append(entry)
                continue
            self._append(name, t_cal + cal.elapsed_time(start) / 1e3,
                         t_cal + cal.elapsed_time(end) / 1e3, meta, track)
        if left:
            with self._lock:
                self._pending[:0] = left

    # ------------------------------------------------------------- reading
    # Each read first resolves every pending stream span, waiting for the
    # card where it must: that is read time, not the hot path.

    def totals(self) -> Dict[str, float]:
        """Total seconds per interval name."""
        self._settle(wait=True)
        out: Dict[str, float] = {}
        with self._lock:
            for iv in self._intervals:
                out[iv["name"]] = out.get(iv["name"], 0.0) + iv["dur"] / 1e6
        return out

    def counts(self) -> Dict[str, int]:
        """Number of intervals per interval name (events such as
        ``job:warm_failed`` are counted here)."""
        self._settle(wait=True)
        out: Dict[str, int] = {}
        with self._lock:
            for iv in self._intervals:
                out[iv["name"]] = out.get(iv["name"], 0) + 1
        return out

    def intervals(self, name: str) -> List[dict]:
        """Copies of the recorded intervals called ``name`` ({"ts", "dur"}
        in microseconds from the profiler's start, "meta", and "track",
        the device, on a stream span), in record order."""
        self._settle(wait=True)
        with self._lock:
            return [dict(iv) for iv in self._intervals if iv["name"] == name]

    def write_trace(self, path: str) -> None:
        """Chrome trace event format (open in Perfetto / chrome://tracing):
        host spans under pid 0, one thread a track; stream spans under pid
        1, one track a device, named ``cuda:<n>``."""
        self._settle(wait=True)
        with self._lock:
            ivs = list(self._intervals)
        tracks = sorted({iv["track"] for iv in ivs if "track" in iv})
        events = [
            {
                "name": iv["name"],
                "ph": "X",
                "ts": iv["ts"],
                "dur": iv["dur"],
                "pid": 1 if "track" in iv else 0,
                "tid": int(iv["track"].split(":")[1]) if "track" in iv
                else iv["tid"],
                "args": iv["meta"],
            }
            for iv in ivs
        ]
        if tracks:
            events.append({"name": "process_name", "ph": "M", "pid": 1,
                           "args": {"name": "device streams"}})
            events += [{"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": int(t.split(":")[1]), "args": {"name": t}}
                       for t in tracks]
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
