"""Object detection ops: SSD-MobileNetV1.

Reference parity: ``DetectObjects`` (object_detection.py:13-75) — the TF
frozen graph emits 100 (box, score, class) rows per frame; boxes are
normalized with (x1=box[1], y1=box[0], x2=box[3], y2=box[2]).

The structure is the JAX package's (scannertools_tpu's ops/objects.py,
same as ops/faces.py): the composite expands into a device-kind forward
emitting fixed-shape padded arrays and a host decode that wraps protos.
Weights enter the forward as the op's aux tree (a state_dict of tensors
the executor moves to the device once); ``weights_path`` names an npz in
the JAX package's layout, and without one the port draws its own weights
from a ``torch.Generator`` seeded 0. The JAX module's Mask R-CNN ops wait
for their own slice.
"""

from __future__ import annotations

from typing import List, Optional

from .. import protobufs
from ..graph import NodeOutput, OpNode
from ..models import ssd as ssd_lib
from ..registry import register_composite, register_op
from ..utils.framechunk import as_hwc_f32
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
