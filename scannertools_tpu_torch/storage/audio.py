"""Audio storage: fixed-duration float32 sample frames from an audio file.

Reference parity: AudioStorage/AudioStream (storage/audio.py:4-40) + the C++
Audio source (audio_source.cpp:31-412): element count =
floor(duration / frame_size); element i = exactly
``frame_size * sample_rate`` float32 mono samples starting at
``i * frame_size`` seconds, zero-filled past EOF (audio_source.cpp:176-186).

WAV (PCM 8/16/32-bit) decodes through the pure-python parser below (exact,
no codec delay); every other container/codec goes through the native libav
module (io/av.py -> runtime/native/st_av.cpp), matching the reference's
any-codec support. The decode path stays pluggable — set
``AudioStream.DECODER`` to a callable returning (samples_f32_mono,
sample_rate) to override.
"""

from __future__ import annotations

import math
import wave
from typing import Callable, Optional, Tuple

import numpy as np

from .base import StorageBackend, StoredStream


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 mono samples in [-1,1], sample_rate)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        rate = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def _default_decoder(path: str) -> Tuple[np.ndarray, int]:
    if path.lower().endswith(".wav"):
        return decode_wav(path)
    from ..io import av

    if av.available():
        return av.decode_audio(path)
    raise NotImplementedError(
        f"cannot decode {path!r}: the native libav module failed to build "
        "and only WAV has a pure-python parser (set AudioStream.DECODER "
        "to plug in a codec)"
    )


class AudioStorage(StorageBackend):
    pass


class AudioStream(StoredStream):
    DECODER: Callable[[str], Tuple[np.ndarray, int]] = staticmethod(
        _default_decoder
    )

    def __init__(self, path: str, frame_size: float,
                 storage: Optional[AudioStorage] = None):
        self._storage = storage or AudioStorage()
        self._path = path
        self._frame_size = float(frame_size)
        self._cache: Optional[Tuple[np.ndarray, int]] = None

    def _decode(self) -> Tuple[np.ndarray, int]:
        if self._cache is None:
            self._cache = type(self).DECODER(self._path)
        return self._cache

    @property
    def sample_rate(self) -> int:
        return self._decode()[1]

    def duration(self) -> float:
        samples, rate = self._decode()
        return len(samples) / rate

    def __len__(self) -> int:
        return int(math.floor(self.duration() / self._frame_size))

    def type_name(self) -> str:
        return "array_f32"

    def load_bytes(self, rows=None):
        from .. import types as _types

        ser = _types.get_type("array_f32").serialize
        if rows is not None:
            rows = list(rows)
        # sparse row requests on a cold cache use the native windowed
        # decoder (sample-accurate seek, audio_source.cpp:104-210 parity;
        # bit-exact vs the full decode) instead of decoding the whole file
        if (rows is not None and len(rows) <= 8 and self._cache is None
                and not self._path.lower().endswith(".wav")
                and type(self).DECODER is _default_decoder):
            from ..io import av

            if av.available():
                rate = self.sample_rate_probe()
                per = int(self._frame_size * rate)
                for i in rows:
                    frame, _ = av.read_audio_window(
                        self._path, int(i * self._frame_size * rate), per)
                    yield ser(frame)
                return
        samples, rate = self._decode()
        per = int(self._frame_size * rate)
        idxs = range(len(self)) if rows is None else rows
        for i in idxs:
            start = int(i * self._frame_size * rate)
            frame = samples[start : start + per]
            if len(frame) < per:  # zero-fill at EOF (audio_source.cpp:176-186)
                frame = np.concatenate(
                    [frame, np.zeros(per - len(frame), np.float32)]
                )
            yield ser(frame.astype(np.float32))

    def sample_rate_probe(self) -> int:
        """Rate without a full decode (1-sample windowed read)."""
        from ..io import av

        _, rate = av.read_audio_window(self._path, 0, 1)
        return rate

    def storage(self) -> AudioStorage:
        return self._storage
