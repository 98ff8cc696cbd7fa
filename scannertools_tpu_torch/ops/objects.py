"""Object detection ops: SSD-MobileNetV1 and Mask R-CNN.

Reference parity: ``DetectObjects`` (object_detection.py:13-75) — the TF
frozen graph emits 100 (box, score, class) rows per frame; boxes are
normalized with (x1=box[1], y1=box[0], x2=box[3], y2=box[2]).
``MaskRCNNDetectObjects`` (maskrcnn_detection.py:27-330) — confidence filter
0.5, instance masks stored downscaled ×4.

The structure is the JAX package's (scannertools_tpu's ops/objects.py,
same as ops/faces.py): each composite expands into a device-kind forward
emitting fixed-shape padded arrays and a host decode that wraps protos or
pastes masks. Weights enter the forward as the op's aux tree (a state_dict
of tensors the executor moves to the device once); ``weights_path`` names
an npz in the JAX package's layout, and without one the port draws its own
weights from a ``torch.Generator`` seeded 0.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import protobufs
from ..graph import NodeOutput, OpNode
from ..models import maskrcnn as mr
from ..models import ssd as ssd_lib
from ..registry import register_composite, register_op
from ..utils.framechunk import as_hwc_f32
from ..utils.numerics import recip
from .faces import _get_params


def _ssd_aux(ctx, params):
    return _get_params("ssd", params.get("weights_path"))


@register_op("SSDForward", kind="device", aux=_ssd_aux,
             outputs=("array_f32", "array_f32", "array_i32"))
def ssd_forward(ctx, aux, frame, weights_path: Optional[str] = None):
    """SSD-MobileNetV1 + decode + NMS on device: frames -> normalized boxes
    [T,100,4], scores [T,100], classes [T,100] (models/ssd.py)."""
    return ssd_lib.detect(aux, as_hwc_f32(frame))


@register_op("DetectObjectsDecode", kind="host", outputs=("bboxes",))
def detect_objects_decode(ctx, boxes, scores, classes):
    """All 100 rows become protos (reference keeps the fixed 100,
    object_detection.py:47)."""
    out: List[List[protobufs.BoundingBox]] = []
    for nb, s, c in zip(boxes, scores, classes):
        out.append([
            protobufs.BoundingBox(
                x1=float(nb[k, 0]), y1=float(nb[k, 1]),
                x2=float(nb[k, 2]), y2=float(nb[k, 3]),
                score=float(s[k]), label=int(c[k]),
            )
            for k in range(ssd_lib.NUM_OUT)
        ])
    return out


@register_composite("DetectObjects")
def _build_detect_objects(inputs, params, device):
    fwd = OpNode("SSDForward", dict(inputs), dict(params), device=device)
    return OpNode("DetectObjectsDecode", {
        "boxes": NodeOutput(fwd, 0),
        "scores": NodeOutput(fwd, 1),
        "classes": NodeOutput(fwd, 2),
    }, {})


# ------------------------------------------------------------- Mask R-CNN


def _maskrcnn_aux(ctx, params):
    return _get_params("maskrcnn", params.get("weights_path"),
                       params.get("arch", "R-50-FPN"))


@register_op("MaskRCNNForward", kind="device", aux=_maskrcnn_aux,
             outputs=("array_f32", "array_f32", "array_i32", "array_f32",
                      "array_i32"))
def maskrcnn_forward(ctx, aux, frame, weights_path: Optional[str] = None,
                     arch: str = "R-50-FPN", min_size: int = -1,
                     max_size: int = -1, pre_nms: int = -1,
                     post_nms: int = -1, max_det: int = -1):
    """Backbone+FPN+RPN+heads on device over the aspect-preserving
    min-side-800 letterbox (maskrcnn_detection.py:27-30; models/maskrcnn.py
    preprocess). Boxes come back mapped through the letterbox to NORMALIZED
    original-frame coords. Outputs: (boxes [T,MAX_DET,4] normalized, scores,
    labels, masks [T,MAX_DET,28,28], dims [T,2] = (h, w) of the source
    frames for the decode's mask canvases). ``min_size``/``max_size``
    override the reference's 800/1333 and ``pre_nms``/``post_nms``/
    ``max_det`` its caps (tests use small canvases)."""
    x = as_hwc_f32(frame)
    t, h, w, _ = x.shape
    images, scale = mr.preprocess(
        x, min_size if min_size > 0 else mr.MIN_SIZE,
        max_size if max_size > 0 else mr.MAX_SIZE)
    boxes, scores, labels, masks = mr.infer(
        aux, images, arch, pre_nms if pre_nms > 0 else mr.PRE_NMS,
        post_nms if post_nms > 0 else mr.POST_NMS,
        max_det if max_det > 0 else mr.MAX_DET)
    # canvas px -> normalized original-frame coords (the inverse
    # letterbox), the division a product with the float32 reciprocals as
    # jitted XLA divides by a constant
    inv = torch.tensor([recip(v) for v in (w * scale, h * scale) * 2],
                       dtype=torch.float32, device=boxes.device)
    nboxes = torch.clamp(boxes * inv, 0.0, 1.0)
    dims = torch.tensor([h, w], dtype=torch.int32,
                        device=boxes.device).repeat(t, 1)
    return nboxes, scores, labels, masks, dims


@register_op("MaskRCNNDecode", kind="host", outputs=("object",))
def maskrcnn_decode(ctx, boxes, scores, labels, masks, dims,
                    confidence_threshold: float = 0.5,
                    mask_downscale: int = 4):
    """Threshold + mask pasting (maskrcnn_detection.py:27-330). Output per
    frame: list of dicts {bbox: BoundingBox (normalized), mask: canvas f32}.
    ``dims``: per-row (h, w) from the forward, sizing the mask canvases."""
    import cv2

    out = []
    for i in range(len(boxes)):
        h, w = int(dims[i][0]), int(dims[i][1])
        mh = max(h // mask_downscale, 1)
        mw = max(w // mask_downscale, 1)
        dets = []
        for k in range(len(scores[i])):
            if scores[i][k] < confidence_threshold:
                continue
            nb = np.asarray(boxes[i][k], np.float32)  # already normalized
            bb = protobufs.BoundingBox(
                x1=float(nb[0]), y1=float(nb[1]),
                x2=float(nb[2]), y2=float(nb[3]),
                score=float(scores[i][k]), label=int(labels[i][k]))
            canvas = np.zeros((mh, mw), np.float32)
            # clamp the paste origin inside the canvas: a detection at the
            # content edge has normalized x1/y1 == 1.0, and int(1.0*mw)
            # would make a zero-width slice (broadcast crash)
            x1 = min(int(bb.x1 * mw), mw - 1)
            y1 = min(int(bb.y1 * mh), mh - 1)
            x2 = min(max(int(bb.x2 * mw), x1 + 1), mw)
            y2 = min(max(int(bb.y2 * mh), y1 + 1), mh)
            m = cv2.resize(np.asarray(masks[i][k], np.float32),
                           (x2 - x1, y2 - y1))
            canvas[y1:y2, x1:x2] = m
            dets.append({"bbox": bb, "mask": canvas})
        out.append(dets)
    return out


@register_composite("MaskRCNNDetectObjects")
def _build_maskrcnn(inputs, params, device):
    fwd_params = {k: v for k, v in params.items()
                  if k in ("weights_path", "arch", "min_size", "max_size",
                           "pre_nms", "post_nms", "max_det")}
    dec_params = {k: v for k, v in params.items()
                  if k in ("confidence_threshold", "mask_downscale")}
    fwd = OpNode("MaskRCNNForward", dict(inputs), fwd_params, device=device)
    return OpNode("MaskRCNNDecode", {
        "boxes": NodeOutput(fwd, 0),
        "scores": NodeOutput(fwd, 1),
        "labels": NodeOutput(fwd, 2),
        "masks": NodeOutput(fwd, 3),
        "dims": NodeOutput(fwd, 4),
    }, dec_params)
