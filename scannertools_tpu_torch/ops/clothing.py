"""Clothing / hairstyle attribute detection (the esper news-anchor stack).

Reference parity — three pieces, each cited to the legacy modules:

* ``PrepareClothingBbox`` (old/clothing_detection.py:105-207): expand each
  face box to a torso crop window, then shrink its bottom to the first row
  that looks like an on-screen graphic boundary (dense Canny edges) or
  chyron text (dense horizontal contrast) and to the top of any person
  seated below — a deterministic CV algorithm, reproduced exactly
  (thresholds, scan order, malformed-box fallback included).
* ``DetectClothing`` (old/clothing_detection.py:212-260): 299×299
  ImageNet-normalized crops through a multi-head attribute classifier,
  argmax per head -> ``Clothing`` records over the exact 16-attribute
  vocabulary.
* ``DetectHairStyle`` (old/hairstyle_detection.py:56-120): the 3-head
  variant over face crops expanded by 3/4 of the larger box side.

The JAX package's ops/clothing.py (scannertools_tpu), host ops as there:
the window scan and the crops run on the host with cv2 (the crops'
INTER_LINEAR resize samples by another convention than the crop kernel,
so they stay where the JAX package cuts them); every crop of the chunk
then goes to the run's device in one copy, through the classifier in one
forward, and its predictions come back in one copy. The trunk lives in
``models/streetstyle.py``. Both classifiers declare their heads as
experts (``experts=``): under ``PerfParams(expert_shards=N)`` the heads
split over the reserved 'expert' devices
(``models/streetstyle.heads_apply_sharded``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import streetstyle
from ..models.streetstyle import (CLOTHING_ATTRIBUTES, HAIRSTYLE_ATTRIBUTES,
                                  INPUT_SIZE)
from ..registry import register_op
from .faces import (_crop_resize_host, _device_state, _host_crops,
                    _run_device, _to_f32_frames)

# detect_edge_text thresholds (old/clothing_detection.py:113-117)
_BOUNDARY_THRESH = 0.5
_CONTRAST_THRESH = 96
_TEXT_THRESH = 0.45
_HEAD_THRESH = 0.3
_CANNY = 80


@dataclasses.dataclass
class Clothing:
    """Per-person attribute predictions (old/clothing_detection.py:91-103):
    one predicted value index per attribute, decodable to names."""

    predictions: np.ndarray
    attributes: Tuple = CLOTHING_ATTRIBUTES

    def to_dict(self):
        return {key: vals[int(p)]
                for p, (key, vals) in zip(self.predictions, self.attributes)}

    def __str__(self):
        return "\n".join(f"{k}: {v}" for k, v in self.to_dict().items())


@dataclasses.dataclass
class HairStyle(Clothing):
    """old/hairstyle_detection.py:33-49 — same record over the hair vocab."""

    attributes: Tuple = HAIRSTYLE_ATTRIBUTES


def detect_edge_text(img: np.ndarray, start_y: int = 40) -> int:
    """First row (>= a head-clearance start) that is a graphic boundary or
    chyron text — old/clothing_detection.py:106-143, vectorized.

    A row is a *boundary* when more than half its pixels are Canny edges;
    it is *text* when >45% of its pixels differ by >96 brightness from a
    horizontal neighbor at offset ±1 or ±2. Returns the crop-relative row,
    or H when no such row exists. (The channel maximum is taken pairwise
    and differenced in int16: the JAX package's values, several times
    faster than numpy's reduction over a 3-wide axis.)"""
    import cv2

    edges = cv2.Canny(img, _CANNY, _CANNY)
    bright = np.maximum(np.maximum(img[..., 0], img[..., 1]),
                        img[..., 2]).astype(np.int16)
    H, W = bright.shape
    start_y = int((H - start_y) * _HEAD_THRESH + start_y)
    if start_y >= H:
        return H
    edge_rows = (edges != 0).sum(axis=1) / W > _BOUNDARY_THRESH

    grad = np.zeros((H, W), bool)
    for off in (-2, -1, 1, 2):
        if off > 0:
            d = np.abs(bright[:, off:] - bright[:, :-off])
            grad[:, :-off] |= d > _CONTRAST_THRESH
        else:
            d = np.abs(bright[:, :off] - bright[:, -off:])
            grad[:, -off:] |= d > _CONTRAST_THRESH
    text_rows = grad.sum(axis=1) / W > _TEXT_THRESH

    hits = np.nonzero(edge_rows[start_y:] | text_rows[start_y:])[0]
    return int(start_y + hits[0]) if len(hits) else H


def _prepare_one(frame: np.ndarray, bbs, i: int):
    """The reference window math for person i (clothing_detection.py:
    145-207), including its quirks: the body-bound overlap test is the
    'or' as written, and the final bottom row mixes the crop-relative
    detect_edge_text row with absolute left/top (visible only when the
    crop window is not clipped at the frame top)."""
    h, w = frame.shape[:2]
    bbox = bbs[i]
    x1, y1 = int(bbox.x1 * w), int(bbox.y1 * h)
    x2, y2 = int(bbox.x2 * w), int(bbox.y2 * h)
    crop_w = (x2 - x1) * 2
    crop_h = crop_w * 2
    X1 = int((x1 + x2) / 2 - crop_w / 2)
    X2 = X1 + crop_w
    Y1 = int((y1 + y2) / 2 - crop_h / 3)
    Y2 = Y1 + crop_h
    crop_x1, crop_x2 = max(0, X1), min(w - 1, X2)
    crop_y1, crop_y2 = max(0, Y1), min(h - 1, Y2)
    cropped = frame[crop_y1:crop_y2 + 1, crop_x1:crop_x2 + 1]

    body_bound = 1.0
    cx = (bbox.x1 + bbox.x2) / 2
    span_x1 = cx - (bbox.x2 - bbox.x1)
    span_x2 = cx + (bbox.x2 - bbox.x1)
    for j, other in enumerate(bbs):
        if i == j:
            continue
        if bbox.y2 < other.y1 and (other.x1 < span_x2 or other.x2 > span_x1):
            body_bound = other.y1

    neck_line = y2 - crop_y1
    bound_row = int(body_bound * h) - crop_y1
    crop_y = min(detect_edge_text(np.ascontiguousarray(cropped), neck_line),
                 bound_row)

    def inbound(c, lim):
        return 0 <= int(c) < lim

    if (abs(crop_x1 - crop_x2) < 20 or abs(crop_y1 - crop_y) < 20
            or crop_x1 >= crop_x2 or crop_y1 >= crop_y
            or not inbound(crop_x1, w) or not inbound(crop_x2, w)
            or not inbound(crop_y1, h) or not inbound(crop_y, h)):
        return bbox
    from ..protobufs import BoundingBox

    return BoundingBox(x1=crop_x1 / w, x2=crop_x2 / w,
                       y1=crop_y1 / h, y2=crop_y / h, score=bbox.score)


@register_op("PrepareClothingBbox", kind="host", outputs=("bboxes",))
def prepare_clothing_bbox(ctx, frame, bboxes):
    """Face boxes -> torso crop windows (see _prepare_one)."""
    frames = frame if isinstance(frame, np.ndarray) \
        and frame.dtype == np.uint8 else _to_f32_frames(frame).astype(
            np.uint8)
    return [
        [_prepare_one(frames[t], bbs, i) for i in range(len(bbs))]
        for t, bbs in enumerate(bboxes)
    ]


def _classify(ctx, frame, bboxes, model: str, predict, record_cls,
              weights_path, crop_fn, mesh=None):
    """Every box's crop on the host; all crops of the chunk to the run's
    device in one copy, ``predict`` over them in one forward (its heads
    split over ``mesh`` when given), the predictions back in one copy ->
    per-frame records."""
    frames = _to_f32_frames(frame)
    crops, src, out = _host_crops(frames, bboxes, crop_fn)
    n_attrs = len(record_cls.attributes)
    for row in out:  # degenerate crops: the zero prediction
        for j in range(len(row)):
            row[j] = record_cls(predictions=np.zeros(n_attrs, np.int32))
    if crops is not None:
        device = _run_device(ctx)
        preds = predict(_device_state(model, weights_path, device),
                        torch.from_numpy(crops).to(device),
                        mesh=mesh).cpu().numpy()
        for p, (i, j) in zip(preds, src):
            out[i][j] = record_cls(predictions=p.astype(np.int32))
    return out


def clothing_crop(frame: np.ndarray, bbox) -> Optional[np.ndarray]:
    return _crop_resize_host(frame, bbox, INPUT_SIZE)


@register_op("DetectClothing", kind="host", outputs=("object",),
             experts=lambda p: len(CLOTHING_ATTRIBUTES))
def detect_clothing(ctx, frame, bboxes, adjust_bboxes: bool = True,
                    weights_path: Optional[str] = None):
    """Multi-head clothing attributes per person box
    (old/clothing_detection.py:212-260). ``adjust_bboxes`` applies
    PrepareClothingBbox first, as the reference pipeline does
    (clothing_detection.py:291-297).

    Under ``PerfParams(expert_shards=N)`` the 16 attribute heads split one
    group per reserved device (experts = attribute heads;
    models/streetstyle.heads_apply_sharded)."""
    if adjust_bboxes:
        bboxes = prepare_clothing_bbox(ctx, frame, bboxes)
    # a caller outside an executor passes None or any object with a
    # ``device`` (no reserved axes)
    mesh = ctx.ep_mesh(len(CLOTHING_ATTRIBUTES)) \
        if hasattr(ctx, "ep_mesh") else None
    return _classify(ctx, frame, bboxes, "streetstyle_clothing",
                     streetstyle.predict_clothing, Clothing, weights_path,
                     clothing_crop, mesh=mesh)


def _hair_crop(frame: np.ndarray, bbox):
    """Face box -> square hair crop expanded by 3/4 of the larger side
    around the center (old/hairstyle_detection.py:83-95)."""
    import cv2

    H, W = frame.shape[:2]
    x1, y1 = int(bbox.x1 * W), int(bbox.y1 * H)
    x2, y2 = int(bbox.x2 * W), int(bbox.y2 * H)
    w = max(y2 - y1, x2 - x1) * 3 // 4
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    xa = cx - w if cx - w > 0 else 0
    xb = cx + w if cx + w < W else W
    ya = cy - w if cy - w > 0 else 0
    yb = cy + w if cy + w < H else H
    crop = frame[ya:yb, xa:xb]
    if crop.shape[0] == 0 or crop.shape[1] == 0:
        return None
    return cv2.resize(crop, (INPUT_SIZE, INPUT_SIZE))


@register_op("DetectHairStyle", kind="host", outputs=("object",),
             experts=lambda p: len(HAIRSTYLE_ATTRIBUTES))
def detect_hairstyle(ctx, frame, bboxes,
                     weights_path: Optional[str] = None):
    """3-head hair attributes per face box
    (old/hairstyle_detection.py:56-120). The 3 heads split over the
    'expert' mesh under expert_shards like DetectClothing."""
    mesh = ctx.ep_mesh(len(HAIRSTYLE_ATTRIBUTES)) \
        if hasattr(ctx, "ep_mesh") else None
    return _classify(ctx, frame, bboxes, "streetstyle_hairstyle",
                     streetstyle.predict_hairstyle, HairStyle, weights_path,
                     _hair_crop, mesh=mesh)
