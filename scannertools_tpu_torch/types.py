"""Column type registry: serializers/parsers for op outputs.

Reference parity: scannertools/scannertools/types.py (byte parsers for
histograms/poses/flow/frame_info) and scannerpy.types (Histogram, BboxList,
UniformList, NumpyArrayFloat32, register_type).

A ColumnType knows how to
  * serialize one element (host object or numpy array) -> bytes, and
  * parse bytes -> host object,
so stored streams stay bit-stable and language-agnostic. Device ops exchange
arrays directly; serialization only happens at sinks / ``load()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np

from . import protobufs


@dataclasses.dataclass
class ColumnType:
    name: str
    serialize: Callable[[Any], bytes]
    parse: Callable[[bytes], Any]


_TYPES: Dict[str, ColumnType] = {}


def register_type(
    name: str,
    serialize: Callable[[Any], bytes],
    parse: Callable[[bytes], Any],
) -> ColumnType:
    """Reference: scannerpy.types.register_type (used by FacenetEmbeddings etc.)."""
    ty = ColumnType(name, serialize, parse)
    _TYPES[name] = ty
    return ty


def get_type(name: str) -> ColumnType:
    return _TYPES[name]


def has_type(name: str) -> bool:
    return name in _TYPES


# --- builtin types -----------------------------------------------------------

def _ser_bytes(x) -> bytes:
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, np.ndarray):
        return x.tobytes()
    raise TypeError(f"cannot serialize {type(x)} as bytes")


register_type("bytes", _ser_bytes, lambda b: b)

# Histogram: 3 channels x nbins int32 (reference types.py:23-27 parses with
# np.split(np.frombuffer(int32), 3)).
register_type(
    "histogram",
    lambda a: np.asarray(a, np.int32).tobytes(),
    lambda b: list(np.split(np.frombuffer(b, dtype=np.int32), 3)),
)

# Flow: H x W x 2 float32 with a small dims header so parse needs no context
# (reference types.py 'flow' knows dims from FrameType metadata instead).
# A float16 array serializes as f16 bytes under the same header (the compact
# sink encoding of OpticalFlow(out_dtype="float16") — 4× smaller elements);
# parse distinguishes by payload size and upcasts, so loads always return the
# reference's H×W×2 float32 contract (tests/test_all.py:173-177).
def _ser_flow(a) -> bytes:
    a = np.asarray(a)
    if a.dtype != np.float16:
        a = np.asarray(a, np.float32)
    h, w = a.shape[0], a.shape[1]
    return np.array([h, w], np.int32).tobytes() + a.tobytes()


def _parse_flow(b: bytes):
    h, w = np.frombuffer(b[:8], np.int32)
    body = b[8:]
    if len(body) == int(h) * int(w) * 2 * 2:  # f16 payload
        return np.frombuffer(body, np.float16).reshape(
            int(h), int(w), 2).astype(np.float32)
    return np.frombuffer(body, np.float32).reshape(int(h), int(w), 2)


register_type("flow", _ser_flow, _parse_flow)


# Frames (decoded images): dtype-u8 H x W x C with dims header.
def _ser_frame(a) -> bytes:
    a = np.ascontiguousarray(a)
    h, w = a.shape[0], a.shape[1]
    c = a.shape[2] if a.ndim == 3 else 1
    dt = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1}[a.dtype]
    return np.array([h, w, c, dt], np.int32).tobytes() + a.tobytes()


def _parse_frame(b: bytes):
    h, w, c, dt = np.frombuffer(b[:16], np.int32)
    dtype = [np.uint8, np.float32][int(dt)]
    arr = np.frombuffer(b[16:], dtype).reshape(int(h), int(w), int(c))
    return arr if c > 1 else arr[:, :, 0]


register_type("frame", _ser_frame, _parse_frame)


# Generic float32 numpy array with ndim/dims header
# (reference scannerpy.types.NumpyArrayFloat32).
def _ser_f32(a) -> bytes:
    a = np.asarray(a, np.float32)
    hdr = np.array([a.ndim] + list(a.shape), np.int32).tobytes()
    return hdr + a.tobytes()


def _parse_f32(b: bytes):
    ndim = int(np.frombuffer(b[:4], np.int32)[0])
    shape = tuple(np.frombuffer(b[4 : 4 + 4 * ndim], np.int32))
    return np.frombuffer(b[4 + 4 * ndim :], np.float32).reshape(shape)


register_type("array_f32", _ser_f32, _parse_f32)
register_type(
    "array_i32",
    lambda a: _ser_f32_like(a, np.int32),
    lambda b: _parse_f32_like(b, np.int32),
)


def _ser_f32_like(a, dtype) -> bytes:
    a = np.asarray(a, dtype)
    hdr = np.array([a.ndim] + list(a.shape), np.int32).tobytes()
    return hdr + a.tobytes()


def _parse_f32_like(b: bytes, dtype):
    ndim = int(np.frombuffer(b[:4], np.int32)[0])
    shape = tuple(np.frombuffer(b[4 : 4 + 4 * ndim], np.int32))
    return np.frombuffer(b[4 + 4 * ndim :], dtype).reshape(shape)


# Bounding boxes: length-prefixed BoundingBox records (reference types.py
# writers 'bboxes'; scannerpy.types.BboxList).
def _ser_bboxes(boxes) -> bytes:
    if isinstance(boxes, np.ndarray):
        # [N, >=5] array rows -> BoundingBox
        boxes = [
            protobufs.BoundingBox(
                x1=float(r[0]), y1=float(r[1]), x2=float(r[2]), y2=float(r[3]),
                score=float(r[4]) if len(r) > 4 else 0.0,
                label=int(r[5]) if len(r) > 5 else 0,
                track_id=int(r[6]) if len(r) > 6 else -1,
            )
            for r in boxes
        ]
    return protobufs.serialize_bbox_list(list(boxes))


register_type("bboxes", _ser_bboxes, protobufs.parse_bbox_list)

register_type(
    "frame_info",
    lambda fi: fi.SerializeToString(),
    protobufs.FrameInfo.FromString,
)


# Python objects (pickle) — used by PythonStorage and host ops with arbitrary
# outputs (reference python_source.cpp pickled elements).
import pickle as _pickle

register_type("object", lambda o: _pickle.dumps(o), lambda b: _pickle.loads(b))


# UniformList: fixed-stride concatenation of a scalar dtype, e.g. FaceNet
# embeddings = per-bbox 128-d f32 blocks (reference face_embedding.py:74-89,
# scannerpy.types.UniformList).
def uniform_list_type(name: str, dtype, stride: int) -> ColumnType:
    np_dtype = np.dtype(dtype)

    def ser(arr) -> bytes:
        a = np.asarray(arr, np_dtype).reshape(-1, stride)
        return a.tobytes()

    def parse(b: bytes):
        return np.frombuffer(b, np_dtype).reshape(-1, stride)

    return register_type(name, ser, parse)


uniform_list_type("facenet_embeddings", np.float32, 128)
