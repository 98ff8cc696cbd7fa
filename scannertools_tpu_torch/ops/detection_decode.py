"""Detector-output decode ops: YoloOutput, FasterRCNNOutput, FacenetOutput,
BboxNMS — the reference's C++ post-processing kernels as host ops (a copy
of scannertools_tpu's ops/detection_decode.py: numpy only, so its outputs
equal the JAX package's exactly).

Reference parity:
  YoloOutput        yolo_output_kernel_cpu.cpp:11-175 — YOLOv1 decode:
                    7×7 grid, 2 boxes/cell, 20 VOC classes; score =
                    objectness × class confidence, threshold 0.5.
  FasterRCNNOutput  faster_rcnn_output_kernel_cpu.cpp:16-132 — per-ROI
                    argmax over 81 classes (skip background), score > 0.7,
                    best_nms 0.3 ('min' overlap), gathers the surviving
                    ROIs' 4096-d fc7 features.
  FacenetOutput     facenet_output_kernel_cpu.cpp:11-195 — anchor-template
                    face detector decode: sigmoid confidences over the
                    output grid, per-template box adjustments
                    (dcx, dcy, exp(dcw), exp(dch)), rescale to the original
                    frame via the InfoFromFrame column, best_nms 0.1.
  BboxNMS           old/bboxes.py:8-20 — standalone NMS over bbox lists.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .. import protobufs
from ..registry import register_op

VOC_CATEGORIES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def _nms_host(boxes: List[protobufs.BoundingBox], overlap: float,
              mode: str = "min") -> List[protobufs.BoundingBox]:
    """Host NMS matching the reference's best_nms: overlap = inter over the
    smaller box area, highest score wins."""
    order = sorted(boxes, key=lambda b: -b.score)
    kept: List[protobufs.BoundingBox] = []
    for b in order:
        area_b = max(b.x2 - b.x1, 0) * max(b.y2 - b.y1, 0)
        ok = True
        for k in kept:
            x1, y1 = max(b.x1, k.x1), max(b.y1, k.y1)
            x2, y2 = min(b.x2, k.x2), min(b.y2, k.y2)
            inter = max(x2 - x1, 0) * max(y2 - y1, 0)
            area_k = max(k.x2 - k.x1, 0) * max(k.y2 - k.y1, 0)
            denom = min(area_b, area_k) if mode == "min" else \
                (area_b + area_k - inter)
            if denom > 0 and inter / denom > overlap:
                ok = False
                break
        if ok:
            kept.append(b)
    return kept


@register_op("BboxNMS", kind="host", outputs=("bboxes",))
def bbox_nms(ctx, bboxes, threshold: float = 0.3, mode: str = "union"):
    """Standalone NMS op (old/bboxes.py:8-20)."""
    return [_nms_host(list(bl), threshold, mode) for bl in bboxes]


@register_op("YoloOutput", kind="host", outputs=("bboxes",))
def yolo_output(ctx, features, threshold: float = 0.5):
    """features: per-frame f32 vector of length 7·7·20 + 7·7·2 + 7·7·2·4
    (class confidences, objectness, box attrs) -> VOC bboxes in 448×448
    pixel coords (yolo_output_kernel_cpu.cpp layout)."""
    G, B, C, S = 7, 2, 20, 448
    cell = S // G
    n_conf = G * G * C
    n_obj = G * G * B
    out = []
    for feat in features:
        v = np.asarray(feat, np.float32).reshape(-1)
        conf = v[:n_conf].reshape(G * G, C)
        obj = v[n_conf : n_conf + n_obj].reshape(G * G, B)
        bb = v[n_conf + n_obj :].reshape(G * G, B, 4)
        boxes = []
        for yi in range(G):
            for xi in range(G):
                o = yi * G + xi
                for bi in range(B):
                    x = (xi + bb[o, bi, 0]) / G * S
                    y = (yi + bb[o, bi, 1]) / G * S
                    w = bb[o, bi, 2] ** 2 * S
                    h = bb[o, bi, 3] ** 2 * S
                    if w < 0 or h < 0:
                        continue
                    for c in range(C):
                        prob = float(obj[o, bi] * conf[o, c])
                        if prob < threshold:
                            continue
                        boxes.append(protobufs.BoundingBox(
                            x1=x - w / 2, y1=y - h / 2,
                            x2=x + w / 2, y2=y + h / 2,
                            score=prob, label=c))
        out.append(_nms_host(boxes, 0.3, mode="min"))
    return out


@register_op("FasterRCNNOutput", kind="host",
             outputs=("bboxes", "array_f32"))
def faster_rcnn_output(ctx, cls_prob, rois, fc7,
                       score_threshold: float = 0.7,
                       nms_threshold: float = 0.3):
    """cls_prob: [R,81]; rois: [R,5] (batch_idx, x1, y1, x2, y2);
    fc7: [R,4096] per frame -> (bboxes, features of survivors)."""
    out_boxes, out_feats = [], []
    for t in range(len(cls_prob)):
        probs = np.asarray(cls_prob[t], np.float32).reshape(-1, 81)
        r = np.asarray(rois[t], np.float32).reshape(-1, 5)
        feats = np.asarray(fc7[t], np.float32).reshape(-1, 4096)
        boxes = []
        for j in range(probs.shape[0]):
            cls = int(np.argmax(probs[j, 1:])) + 1  # skip background
            score = float(probs[j, cls])
            if score > score_threshold:
                boxes.append(protobufs.BoundingBox(
                    x1=float(r[j, 1]), y1=float(r[j, 2]),
                    x2=float(r[j, 3]), y2=float(r[j, 4]),
                    score=score, label=cls, track_id=j))
        best = _nms_host(boxes, nms_threshold, mode="min")
        out_boxes.append(best)
        if best:
            out_feats.append(np.stack([feats[b.track_id] for b in best]))
        else:
            out_feats.append(np.zeros((0, 4096), np.float32))
    return out_boxes, out_feats


def load_face_templates(path: str, n: int = 25) -> np.ndarray:
    """Parse the reference's BINARY template file
    (facenet_output_kernel_cpu.cpp:20-30): 25 templates × 4 little-endian
    float32 read in order — the artifact shipped next to the facenet
    caffemodel. Returns [n, 4] float32."""
    with open(path, "rb") as f:
        raw = f.read(n * 4 * 4)
    if len(raw) < n * 4 * 4:
        raise ValueError(
            f"template file {path!r} truncated: need {n * 4 * 4} bytes "
            f"({n} templates x 4 f32), got {len(raw)}")
    return np.frombuffer(raw, "<f4").reshape(n, 4).copy()


def default_face_templates(n: int = 25) -> np.ndarray:
    """[n, 4] (w, h) anchor templates spanning face scales/aspects — the
    reference loads these from a binary file next to the caffemodel
    (facenet_output_kernel_cpu.cpp:20-30); pass your own via the op param
    for bit-parity with a specific model."""
    ts = []
    for scale in np.linspace(16, 160, 5):
        for ratio in (0.7, 0.85, 1.0, 1.15, 1.3):
            ts.append((scale * ratio, scale / ratio, 0.0, 0.0))
    return np.asarray(ts[:n], np.float32)


@register_op("FacenetOutput", kind="host", outputs=("bboxes",))
def facenet_output(ctx, scores, frame_info, templates=None,
                   templates_path: str = "",
                   score_threshold: float = 0.5,
                   nms_threshold: float = 0.1, scale: float = 1.0):
    """scores: per-frame [gh, gw, 25 + 100] f32 maps — per-template logit
    confidences then (dcx, dcy, dcw, dch) adjustments; frame_info: original
    frame dims (InfoFromFrame column) for rescaling. ``templates_path``
    points at the reference's binary template artifact (the FacenetArgs
    templates_path, facenet_output_kernel_cpu.cpp:20-30); ``templates``
    passes a pre-parsed [25,4] array directly."""
    if templates is None and templates_path:
        templates = load_face_templates(templates_path)
    tpl = np.asarray(templates if templates is not None
                     else default_face_templates(), np.float32)
    n_t = tpl.shape[0]
    out = []
    for t in range(len(scores)):
        m = np.asarray(scores[t], np.float32)
        gh, gw = m.shape[0], m.shape[1]
        conf = 1.0 / (1.0 + np.exp(-m[..., :n_t]))
        adj = m[..., n_t : n_t * 5].reshape(gh, gw, n_t, 4)
        fi = frame_info[t]
        stride = 8.0 / scale  # grid cell size in original pixels
        boxes = []
        ys, xs, ks = np.nonzero(conf > score_threshold)
        for y, x, k in zip(ys, xs, ks):
            w0, h0 = float(tpl[k, 0]), float(tpl[k, 1])
            cx = (x + 0.5) * stride + float(adj[y, x, k, 0]) * w0
            cy = (y + 0.5) * stride + float(adj[y, x, k, 1]) * h0
            # clip exponents: untrained/garbage adjustments must not
            # produce boxes outside the frame
            w = w0 * math.exp(min(max(float(adj[y, x, k, 2]), -4.0), 4.0))
            h = h0 * math.exp(min(max(float(adj[y, x, k, 3]), -4.0), 4.0))
            x1 = min(max(cx - w / 2, 0.0), float(fi.width))
            y1 = min(max(cy - h / 2, 0.0), float(fi.height))
            x2 = min(max(cx + w / 2, 0.0), float(fi.width))
            y2 = min(max(cy + h / 2, 0.0), float(fi.height))
            if x2 <= x1 or y2 <= y1:
                continue  # degenerate after clamping
            boxes.append(protobufs.BoundingBox(
                x1=x1, y1=y1, x2=x2, y2=y2, score=float(conf[y, x, k])))
        out.append(_nms_host(boxes, nms_threshold, mode="min"))
    return out
