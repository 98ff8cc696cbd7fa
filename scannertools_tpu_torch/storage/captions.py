"""Caption (SRT) storage: fixed time windows over a subtitle file.

Reference parity: CaptionStorage/CaptionStream (storage/caption.py:3-49) +
the C++ Captions source (captions_source.cpp:24-237): element count =
floor(max_time / window_size); element i = JSON array of the captions whose
*start* time falls in [i·ws, (i+1)·ws), each as
{"index": n, "start": s, "end": e, "line": text}. The uniform windowing
makes the element count predictable for zipping with audio streams.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import List, Optional

from .base import StorageBackend, StoredStream


@dataclasses.dataclass
class Caption:
    index: int
    start: float
    end: float
    line: str


_TS = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)")


def _parse_timestamp(s: str) -> float:
    m = _TS.search(s)
    if not m:
        raise ValueError(f"bad SRT timestamp: {s!r}")
    hh, mm, ss, ms = (int(g) for g in m.groups())
    return hh * 3600.0 + mm * 60.0 + ss + ms / 1000.0


def parse_srt(text: str) -> List[Caption]:
    """Parse SubRip format: blank-line-separated blocks of
    index / 'HH:MM:SS,mmm --> HH:MM:SS,mmm' / text lines."""
    captions: List[Caption] = []
    for block in re.split(r"\n\s*\n", text.replace("\r", "")):
        lines = [l for l in block.split("\n") if l.strip()]
        if len(lines) < 2:
            continue
        try:
            idx = int(lines[0].strip())
            time_i = 1
        except ValueError:
            idx = len(captions) + 1
            time_i = 0
        if "-->" not in lines[time_i]:
            continue
        a, b = lines[time_i].split("-->")
        start, end = _parse_timestamp(a), _parse_timestamp(b)
        line = " ".join(l.strip() for l in lines[time_i + 1:])
        captions.append(Caption(idx, start, end, line))
    return captions


class CaptionStorage(StorageBackend):
    pass


class CaptionStream(StoredStream):
    def __init__(self, path: str, window_size: float, max_time: float,
                 storage: Optional[CaptionStorage] = None):
        self._storage = storage or CaptionStorage()
        self._path = path
        self._window_size = float(window_size)
        self._max_time = float(max_time)
        self._captions: Optional[List[Caption]] = None

    def _load(self) -> List[Caption]:
        if self._captions is None:
            with open(self._path, "r", errors="replace") as f:
                self._captions = parse_srt(f.read())
        return self._captions

    def __len__(self) -> int:
        return int(math.floor(self._max_time / self._window_size))

    def load_bytes(self, rows=None):
        caps = self._load()
        idxs = range(len(self)) if rows is None else rows
        for i in idxs:
            start = i * self._window_size
            end = (i + 1) * self._window_size
            window = [
                {"index": c.index, "start": c.start, "end": c.end,
                 "line": c.line}
                for c in caps if start <= c.start < end
            ]
            yield json.dumps(window).encode("utf-8")

    def storage(self) -> CaptionStorage:
        return self._storage
