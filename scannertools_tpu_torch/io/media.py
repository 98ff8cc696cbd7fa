"""Video/Audio file handles with metadata + random frame access.

Reference parity: old/video.py:5-178 — ``Video`` (hwang-backed metadata,
``frame(number|time)``, ``frames``, ``montage``) and ``Audio`` (path +
ffmpeg extract). Frame decode goes through io/video.py's backend dispatch
(native libav or cv2); ``Audio.extract`` uses the in-process libav module
instead of the reference's ffmpeg subprocess.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from .video import VideoDecoder, probe


class Audio:
    """Reference to an audio file on disk (old/video.py:5-18)."""

    def __init__(self, audio_path: str):
        self._path = audio_path

    def path(self) -> str:
        return self._path

    def extract(self, path=None, ext=".wav", segment=None):
        """Extract (a segment of) the audio track to ``path``.

        Reference parity: old/video.py's ffmpeg-subprocess extract; here the
        native libav module decodes + re-encodes in-process (io/av.py).
        ``segment`` is an (start_sec, end_sec) pair.
        """
        from . import av

        if not av.available():
            raise NotImplementedError(
                "Audio.extract needs the native libav module (st_av), "
                "which failed to build in this environment")
        samples, rate = av.decode_audio(self._path)
        if segment is not None:
            s, e = segment
            lo = max(0, min(len(samples), int(s * rate)))
            hi = max(lo, min(len(samples), int(e * rate)))
            samples = samples[lo:hi]
        if path is None:
            import tempfile

            with tempfile.NamedTemporaryFile(
                    delete=False, suffix=ext) as f:
                path = f.name
        elif ext and not path.endswith(ext):
            path = path + ext
        av.encode_audio(path, samples, rate)
        return Audio(path)


class Video:
    """Reference to a video file on disk (old/video.py:21-178)."""

    def __init__(self, path: str, scanner_name: Optional[str] = None):
        self._path = path
        self._meta = probe(path)
        self._decoder: Optional[VideoDecoder] = None
        self._scanner_name = scanner_name

    def path(self) -> str:
        return self._path

    def scanner_name(self) -> str:
        import os

        return self._scanner_name or os.path.basename(self._path)

    def width(self) -> int:
        return self._meta.width

    def height(self) -> int:
        return self._meta.height

    def fps(self) -> float:
        return self._meta.fps

    def num_frames(self) -> int:
        return self._meta.num_frames

    def duration(self) -> float:
        return self._meta.duration

    def _dec(self) -> VideoDecoder:
        if self._decoder is None:
            self._decoder = VideoDecoder(self._path)
        return self._decoder

    def frame(self, number: Optional[int] = None,
              time: Optional[float] = None) -> np.ndarray:
        if time is not None:
            number = int(round(time * self.fps()))
        if number is None:
            number = 0
        return self._dec().read_frames([number])[0]

    def frames(self, numbers: Optional[Sequence[int]] = None,
               times: Optional[Sequence[float]] = None) -> List[np.ndarray]:
        if times is not None:
            numbers = [int(round(t * self.fps())) for t in times]
        if numbers is None:
            numbers = list(range(self.num_frames()))
        order = np.argsort(numbers, kind="stable")
        decoded = self._dec().read_frames([numbers[i] for i in order])
        out = np.empty_like(decoded)
        out[order] = decoded
        return list(out)

    def montage(self, frames: Sequence[int], rows: Optional[int] = None,
                cols: Optional[int] = None) -> np.ndarray:
        """Tile the given frames into a grid (old/video.py:164-178)."""
        imgs = self.frames(numbers=list(frames))
        n = len(imgs)
        if cols is None:
            cols = int(math.ceil(math.sqrt(n))) if rows is None \
                else int(math.ceil(n / rows))
        if rows is None:
            rows = int(math.ceil(n / cols))
        h, w = imgs[0].shape[:2]
        grid = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i, img in enumerate(imgs):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
        return grid

    def extract(self, path=None, ext=".mp4", segment=None):
        """Re-encode a segment via OpenCV (the reference shells to ffmpeg)."""
        import os

        from .video import write_video

        if path is None:
            base, _ = os.path.splitext(self._path)
            path = base + "_extract" + ext
        start, end = (0, self.num_frames()) if segment is None else (
            int(segment[0] * self.fps()), int(segment[1] * self.fps()))
        frames = self.frames(numbers=list(range(start, min(end, self.num_frames()))))
        write_video(path, iter(frames), fps=self.fps())
        return path
