"""Lightweight message types replacing the reference's protobuf args.

The reference passes op arguments and structured outputs as protobuf messages
(scannertools_imgproc.proto, scannerpy's BoundingBox). We keep the same field
names/semantics but use plain dataclasses with a compact binary serialization,
so no protoc step is needed and arrays stay numpy-friendly.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List


@dataclasses.dataclass
class BoundingBox:
    """Reference: scannerpy protobufs.BoundingBox (used in face_detection.py:53-64).

    Coordinates are normalized [0,1] relative to the frame unless an op says
    otherwise (matching the reference's normalized MTCNN output).
    """

    x1: float = 0.0
    y1: float = 0.0
    x2: float = 0.0
    y2: float = 0.0
    score: float = 0.0
    label: int = 0
    track_id: int = -1

    _FMT = "<6fi"  # x1 y1 x2 y2 score label(track packed separately for compat)

    def SerializeToString(self) -> bytes:
        return struct.pack(
            "<5f2i", self.x1, self.y1, self.x2, self.y2, self.score,
            int(self.label), int(self.track_id),
        )

    @classmethod
    def FromString(cls, data: bytes) -> "BoundingBox":
        x1, y1, x2, y2, score, label, track_id = struct.unpack("<5f2i", data)
        return cls(x1, y1, x2, y2, score, label, track_id)

    ByteSize = lambda self: struct.calcsize("<5f2i")


@dataclasses.dataclass
class Point:
    """Reference: Point proto emitted by CPM2Output (cpm2_output_kernel_cpu.cpp)."""

    x: float = 0.0
    y: float = 0.0
    score: float = 0.0

    def SerializeToString(self) -> bytes:
        return struct.pack("<3f", self.x, self.y, self.score)

    @classmethod
    def FromString(cls, data: bytes) -> "Point":
        return cls(*struct.unpack("<3f", data))


@dataclasses.dataclass
class FrameInfo:
    """Reference: FrameInfo emitted by InfoFromFrame (info_from_frame_kernel.cpp)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def SerializeToString(self) -> bytes:
        return struct.pack("<3i", self.height, self.width, self.channels)

    @classmethod
    def FromString(cls, data: bytes) -> "FrameInfo":
        return cls(*struct.unpack("<3i", data))


def serialize_bbox_list(boxes: List[BoundingBox]) -> bytes:
    """Length-prefixed concatenation (reference types.py writers 'bboxes')."""
    out = bytearray()
    for b in boxes:
        payload = b.SerializeToString()
        out += struct.pack("<i", len(payload))
        out += payload
    return bytes(out)


def parse_bbox_list(data: bytes) -> List[BoundingBox]:
    boxes = []
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<i", data, off)
        off += 4
        boxes.append(BoundingBox.FromString(data[off : off + n]))
        off += n
    return boxes
