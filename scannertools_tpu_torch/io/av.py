"""ctypes bindings for the native libav decoder (runtime/native/st_av.cpp).

Reference parity: the Scanner engine's ffmpeg decode worker (SURVEY §1 L0)
and the C++ Audio source (audio_source.cpp:31-412). The video decoder keeps
``io/video.py``'s VideoDecoder contract (ascending indices, seek runs,
``out=`` staging buffers) but runs the whole demux→decode→RGB loop in one
GIL-releasing native call, so decode genuinely overlaps the Python thread
that drives the device.

Everything degrades: ``available()`` is False when the libav dev libraries
are not in the image, and callers fall back to cv2 / the WAV parser.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils import native as native_mod


def _lib():
    return native_mod.load("st_av")


def available() -> bool:
    return _lib() is not None


class NativeVideoDecoder:
    """libav-backed decoder with the VideoDecoder interface."""

    def __init__(self, path: str, threads: int = 0):
        """threads: libav decode threads; 0 = auto (min(4, host cores) —
        bulk decode scales with frame threading on multi-core hosts;
        ST_TPU_DECODE_THREADS overrides)."""
        lib = _lib()
        if lib is None:
            raise RuntimeError("st_av native library unavailable")
        self._lib = lib
        self.path = path
        if threads == 0:
            threads = int(os.environ.get("ST_TPU_DECODE_THREADS", "0"))
        self._h = lib.st_av_open_t(path.encode(), int(threads))
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        nf = ctypes.c_int64()
        lib.st_av_meta(self._h, ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(fps), ctypes.byref(nf))
        from .video import VideoMetadata  # local import: avoid cycle

        self.meta = VideoMetadata(
            path=path, num_frames=int(nf.value), fps=float(fps.value),
            width=int(w.value), height=int(h.value),
        )
        sup = ctypes.c_int()
        full = ctypes.c_int()
        bt709 = ctypes.c_int()
        lib.st_av_i420_info(self._h, ctypes.byref(sup), ctypes.byref(full),
                            ctypes.byref(bt709))
        #: stream decodes to packed I420 planes (YUV-planar source, even dims)
        self.i420_supported = bool(sup.value)
        self.i420_full_range = bool(full.value)
        self.i420_bt709 = bool(bt709.value)
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.st_av_close(self._h)
                self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass

    def read_frames(self, indices: Sequence[int],
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        n = len(indices)
        if out is None:
            out = np.empty(
                (n, self.meta.height, self.meta.width, 3), np.uint8)
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("out buffer must be C-contiguous")
        with self._lock:
            if not self._h:
                raise RuntimeError("decoder closed")
            got = self._lib.st_av_read(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, out.ctypes.data_as(ctypes.c_void_p))
            if got != n:
                err = self._lib.st_av_error(self._h).decode()
                raise IOError(
                    f"native decode returned {got}/{n} frames for "
                    f"{self.path}: {err}")
        return out

    def read_frames_i420(self, indices: Sequence[int],
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode ascending indices as packed I420 planes ->
        ``[n, H*W*3//2]`` uint8 (Y plane, then U, then V per frame). Half
        the bytes of RGB24 and no host colorspace math — the YUV->RGB
        conversion runs on-device inside the fused segment
        (utils/framechunk.py). Requires ``self.i420_supported``."""
        n = len(indices)
        fb = self.meta.height * self.meta.width * 3 // 2
        if out is None:
            out = np.empty((n, fb), np.uint8)
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("out buffer must be C-contiguous")
        with self._lock:
            if not self._h:
                raise RuntimeError("decoder closed")
            got = self._lib.st_av_read_i420(
                self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, out.ctypes.data_as(ctypes.c_void_p))
            if got != n:
                err = self._lib.st_av_error(self._h).decode()
                raise IOError(
                    f"native i420 decode returned {got}/{n} frames for "
                    f"{self.path}: {err}")
        return out


def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode any libav-supported audio file -> (mono float32, rate).

    Reference parity: audio_source.cpp's any-codec decode; downmix matches
    storage/audio.py's WAV channel-mean via swresample's default matrix.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("st_av native library unavailable")
    buf = ctypes.POINTER(ctypes.c_float)()
    rate = ctypes.c_int()
    n = lib.st_av_audio_decode(path.encode(), ctypes.byref(buf),
                               ctypes.byref(rate))
    if n < 0:
        raise IOError(f"cannot decode audio: {path}")
    try:
        samples = np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        lib.st_av_free(buf)
    return samples, int(rate.value)


def read_audio_window(path: str, start_sample: int,
                      n_samples: int) -> Tuple[np.ndarray, int]:
    """Sample-accurate windowed decode (reference audio_source.cpp:104-210:
    seek to the window, decode forward, trim, zero-fill past EOF) ->
    (mono float32 of exactly n_samples, rate). Avoids whole-file decode for
    long streams."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("st_av native library unavailable")
    out = np.zeros(n_samples, np.float32)
    rate = ctypes.c_int()
    got = lib.st_av_audio_read_window(
        path.encode(), int(start_sample), int(n_samples),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(rate))
    if got < 0:
        # -(written+1) marks a mid-stream decode error (corrupt/truncated
        # input) — distinct from legitimate EOF zero-fill, which returns n
        reached = -got - 1
        raise IOError(
            f"audio decode error in {path}: stream failed "
            f"{reached}/{n_samples} samples into the requested window")
    return out, int(rate.value)


def encode_audio(path: str, samples: np.ndarray, rate: int) -> None:
    """Encode mono float32 samples; codec chosen by container extension
    (.m4a/.mp4 -> AAC, .ogg -> Vorbis, .wav -> PCM)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("st_av native library unavailable")
    x = np.ascontiguousarray(samples, np.float32)
    rc = lib.st_av_audio_encode(
        path.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), int(rate))
    if rc != 0:
        raise IOError(f"cannot encode audio: {path}")
