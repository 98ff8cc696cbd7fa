"""Host-side video decode.

Reference parity: the Scanner engine's decode thread + hwang indexed decode
(SURVEY §1 L0; old/video.py:39-46). TPU-native design: decode happens on the
host, producing fixed-shape RGB uint8 chunk arrays ``[T, H, W, 3]`` that the
prefetcher moves to HBM with double buffering.

Two backends behind one ``VideoDecoder`` interface:

* **native** (default when buildable) — the C++ libav demuxer/decoder
  (runtime/native/st_av.cpp via io/av.py). One GIL-releasing call decodes a
  whole chunk straight into the staging-ring slot, so decode overlaps the
  Python device-feed thread for real (cv2 holds the GIL around per-frame
  grab/retrieve).
* **cv2** — the OpenCV fallback, kept for environments without libav dev
  libraries and as the independent cross-check in tests.

Select with ``SCANNERTOOLS_TPU_DECODER=native|cv2|auto`` (default auto).

Seek plans: a sorted frame-index list is split into *runs* — maximal spans
where sequential decode beats a seek (the analog of hwang's keyframe-aware
index reads). One seek per run, sequential decode within (both backends).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# Decoding sequentially past <= this many unwanted frames is cheaper than a
# container seek (re-priming the decoder at the previous keyframe).
_SEEK_GAP = 32


@dataclasses.dataclass(frozen=True)
class VideoMetadata:
    path: str
    num_frames: int
    fps: float
    width: int
    height: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.fps if self.fps else 0.0


def _backend() -> str:
    import os

    mode = os.environ.get("SCANNERTOOLS_TPU_DECODER", "auto")
    if mode == "auto":
        from . import av

        return "native" if av.available() else "cv2"
    return mode


def probe(path: str) -> VideoMetadata:
    if _backend() == "native":
        from . import av

        dec = av.NativeVideoDecoder(path)
        try:
            return dec.meta
        finally:
            dec.close()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    meta = VideoMetadata(
        path=path,
        num_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        fps=float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
        width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
    )
    cap.release()
    return meta


def _runs(indices: Sequence[int]) -> List[List[int]]:
    """Split sorted indices into seek runs (gap > _SEEK_GAP starts a new run)."""
    runs: List[List[int]] = []
    for i in indices:
        if runs and 0 < i - runs[-1][-1] <= _SEEK_GAP:
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


def _single_decoder(path: str):
    if _backend() == "native":
        from . import av

        return av.NativeVideoDecoder(path)
    return Cv2VideoDecoder(path)


def _default_threads() -> int:
    """Decode threads: env override, else one per core up to 4 on the
    native backend (GIL-releasing), 1 for cv2 (grab/retrieve holds the GIL
    — threads would only add contention)."""
    import os

    env = os.environ.get("SCANNERTOOLS_TPU_DECODE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            import warnings

            warnings.warn(
                f"SCANNERTOOLS_TPU_DECODE_THREADS={env!r} is not an "
                "integer; using the default thread count")
    if _backend() != "native":
        return 1
    return max(1, min(4, os.cpu_count() or 1))


def VideoDecoder(path: str, threads: Optional[int] = None):
    """Decoder factory: native libav backend when available, else cv2.
    All variants expose ``.meta``, ``.read_frames(indices, out=)``,
    ``.close()``. With ``threads > 1`` (default: one per core up to 4 on
    multi-core hosts, native backend only) each chunk read is decoded by
    that many parallel sub-decoders over disjoint contiguous index spans —
    the engine's multi-threaded decode workers (SURVEY §1 L0)."""
    n = _default_threads() if threads is None else max(1, threads)
    if n <= 1:
        return _single_decoder(path)
    return ParallelVideoDecoder(path, n)


class ParallelVideoDecoder:
    """K sub-decoders over one container decode disjoint contiguous slices
    of every ``read_frames`` request concurrently (ROADMAP #9: host-side
    parallel decode). Each sub-decoder persistently owns the k-th quantile
    of each request, so its position advances monotonically across chunks
    — one forward seek per chunk, never a rewind. The native backend
    releases the GIL inside ``st_av_read``, so threads genuinely overlap.

    Splits respect seek-run boundaries when the request has several runs
    (a sparse Gather) so two threads never re-decode the same GOP; a
    single dense run is split into K equal spans (K-1 extra keyframe
    seeks, each amortized over 1/K of the chunk)."""

    def __init__(self, path: str, threads: int):
        from concurrent.futures import ThreadPoolExecutor

        self.path = path
        self._decs = [_single_decoder(path) for _ in range(threads)]
        self.meta = self._decs[0].meta
        d0 = self._decs[0]
        self.i420_supported = getattr(d0, "i420_supported", False)
        self.i420_full_range = getattr(d0, "i420_full_range", False)
        self.i420_bt709 = getattr(d0, "i420_bt709", False)
        self._pool = ThreadPoolExecutor(
            max_workers=threads, thread_name_prefix="st-decode")

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        for d in self._decs:
            d.close()

    def _split(self, indices: Sequence[int]) -> List[Tuple[int, int]]:
        """[(a, b)) position spans, one per worker, balanced by count and
        aligned to seek-run boundaries when possible."""
        k = min(len(self._decs), len(indices))
        runs = _runs(indices)
        bounds = [0]
        if len(runs) >= k:
            # cut between runs, balancing frames per group
            per = len(indices) / k
            pos = 0
            for r in runs[:-1]:
                pos += len(r)
                if pos >= per * len(bounds) and len(bounds) < k:
                    bounds.append(pos)
        else:
            bounds = [len(indices) * j // k for j in range(k)]
        bounds.append(len(indices))
        return [(bounds[j], bounds[j + 1]) for j in range(len(bounds) - 1)
                if bounds[j + 1] > bounds[j]]

    def read_frames(self, indices: Sequence[int],
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            out = np.empty(
                (len(indices), self.meta.height, self.meta.width, 3),
                np.uint8)
        if len(indices) == 0:
            return out
        spans = self._split(indices)
        futs = [
            self._pool.submit(
                self._decs[j].read_frames, list(indices[a:b]), out[a:b])
            for j, (a, b) in enumerate(spans)
        ]
        for f in futs:
            f.result()  # re-raises worker decode errors
        return out

    def read_frames_i420(self, indices: Sequence[int],
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            fb = self.meta.height * self.meta.width * 3 // 2
            out = np.empty((len(indices), fb), np.uint8)
        if len(indices) == 0:
            return out
        spans = self._split(indices)
        futs = [
            self._pool.submit(
                self._decs[j].read_frames_i420, list(indices[a:b]), out[a:b])
            for j, (a, b) in enumerate(spans)
        ]
        for f in futs:
            f.result()  # re-raises worker decode errors
        return out


class Cv2VideoDecoder:
    """Stateful sequential decoder over one container, optimized for sorted
    index streams (the executor always requests ascending indices)."""

    i420_supported = False  # cv2 only exposes BGR frames

    def __init__(self, path: str):
        if cv2 is None:
            raise RuntimeError("OpenCV is required for video decode")
        self.path = path
        self.meta = probe(path)
        self._cap = cv2.VideoCapture(path)
        self._pos = 0  # index of next frame read() would return
        self._lock = threading.Lock()

    def close(self) -> None:
        self._cap.release()

    def read_frames(self, indices: Sequence[int],
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode the given (ascending) frame indices -> [T, H, W, 3] RGB u8.
        ``out`` lets callers decode into pre-allocated staging (ring slots)."""
        if out is None:
            out = np.empty(
                (len(indices), self.meta.height, self.meta.width, 3), np.uint8
            )
        with self._lock:
            k = 0
            for run in _runs(indices):
                first = run[0]
                if first < self._pos or first - self._pos > _SEEK_GAP:
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, first)
                    self._pos = first
                want = set(run)
                last = run[-1]
                while self._pos <= last:
                    ok = self._cap.grab()
                    if not ok:
                        raise IOError(
                            f"decode failed at frame {self._pos} of {self.path}"
                        )
                    if self._pos in want:
                        ok, bgr = self._cap.retrieve()
                        if not ok:
                            raise IOError(
                                f"retrieve failed at frame {self._pos} of {self.path}"
                            )
                        out[k] = bgr[:, :, ::-1]  # BGR -> RGB
                        k += 1
                    self._pos += 1
        return out


def write_video(path: str, frames: Iterator[np.ndarray], fps: float = 24.0) -> int:
    """Encode RGB uint8 frames to mp4. Returns frame count."""
    writer = None
    n = 0
    for f in frames:
        if writer is None:
            h, w = f.shape[:2]
            writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
            )
            if not writer.isOpened():
                raise IOError(f"cannot open VideoWriter for {path}")
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
        n += 1
    if writer is not None:
        writer.release()
    return n
