"""Misc ops: Pass, Discard, DiscardFrame, InfoFromFrame, ImageDecoder.

Reference parity: scannertools_cpp/misc/{pass,discard,info_from_frame}
_kernel.cpp and imgproc/image_decoder_kernel_cpu.cpp (32-thread cv::imdecode
pool + BGR→RGB). Pass/Discard are plumbing ops used by the storage tests
(tests/test_all.py:64-137); InfoFromFrame feeds original-frame dimensions to
detector output decoders (FacenetOutput/CPM2Output).
"""

from __future__ import annotations

import numpy as np

from .. import protobufs
from ..registry import register_op


@register_op("Pass", kind="host", outputs=("bytes",))
def pass_op(ctx, elements):
    """Identity on any column (pass_kernel.cpp:6-31)."""
    return elements


@register_op("PassFrame", kind="device", outputs=("frame",), row_local=True)
def pass_frame(ctx, frames):
    return frames


@register_op("Discard", kind="host", outputs=("bytes",))
def discard(ctx, elements):
    """Swallow input, emit 1-byte dummies (discard_kernel.cpp:26-28)."""
    return [b"\0" for _ in range(len(elements))]


@register_op("DiscardFrame", kind="host", outputs=("bytes",))
def discard_frame(ctx, frames):
    n = len(frames) if isinstance(frames, list) else frames.shape[0]
    return [b"\0"] * n


@register_op("InfoFromFrame", kind="host", outputs=("frame_info",))
def info_from_frame(ctx, frames):
    """Per-frame FrameInfo (info_from_frame_kernel.cpp:7-35)."""
    out = []
    n = len(frames) if isinstance(frames, list) else frames.shape[0]
    for i in range(n):
        f = frames[i]
        c = f.shape[2] if f.ndim == 3 else 1
        out.append(protobufs.FrameInfo(height=f.shape[0], width=f.shape[1],
                                       channels=c))
    return out


@register_op("ImageDecoder", kind="host", outputs=("frame",))
def image_decoder(ctx, encoded, image_type: str = "ANY"):
    """Decode JPEG/PNG bytes to RGB frames
    (image_decoder_kernel_cpu.cpp:18-30; threads replaced by the executor's
    prefetch pipeline — decode here is already off the device critical path)."""
    import cv2

    out = []
    for buf in encoded:
        arr = np.frombuffer(bytes(buf), np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("ImageDecoder: cv2.imdecode failed")
        out.append(img[:, :, ::-1].copy())  # BGR -> RGB, like the reference
    return out
