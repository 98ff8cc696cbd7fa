"""Labelled-detection visualization.

Reference parity: the vendored tf_vis_utils.py (PIL boxes/labels/colors,
514 LoC from the TF object-detection API) and maskrcnn_detection.py's
``visualize_labels`` + ``TorchDrawBoxes`` op + COCO ``CATEGORIES`` table.
Re-implemented compactly with PIL, as in the JAX package (a copy of
scannertools_tpu's ops/vis_labels.py; PIL is imported where it draws).
"""

from __future__ import annotations

import colorsys
from typing import Dict, Optional, Sequence

import numpy as np

from ..registry import register_op

# COCO category names indexed by the 1..90 detection label ids (the table
# maskrcnn_detection.py carries; ids with gaps per the COCO spec).
COCO_CATEGORIES: Dict[int, str] = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 13: "stop sign", 14: "parking meter", 15: "bench",
    16: "bird", 17: "cat", 18: "dog", 19: "horse", 20: "sheep", 21: "cow",
    22: "elephant", 23: "bear", 24: "zebra", 25: "giraffe", 27: "backpack",
    28: "umbrella", 31: "handbag", 32: "tie", 33: "suitcase", 34: "frisbee",
    35: "skis", 36: "snowboard", 37: "sports ball", 38: "kite",
    39: "baseball bat", 40: "baseball glove", 41: "skateboard",
    42: "surfboard", 43: "tennis racket", 44: "bottle", 46: "wine glass",
    47: "cup", 48: "fork", 49: "knife", 50: "spoon", 51: "bowl",
    52: "banana", 53: "apple", 54: "sandwich", 55: "orange", 56: "broccoli",
    57: "carrot", 58: "hot dog", 59: "pizza", 60: "donut", 61: "cake",
    62: "chair", 63: "couch", 64: "potted plant", 65: "bed",
    67: "dining table", 70: "toilet", 72: "tv", 73: "laptop", 74: "mouse",
    75: "remote", 76: "keyboard", 77: "cell phone", 78: "microwave",
    79: "oven", 80: "toaster", 81: "sink", 82: "refrigerator", 84: "book",
    85: "clock", 86: "vase", 87: "scissors", 88: "teddy bear",
    89: "hair drier", 90: "toothbrush",
}


def _color_for(label: int) -> tuple:
    h = (label * 0.61803398875) % 1.0  # golden-ratio hue spacing
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
    return (int(r * 255), int(g * 255), int(b * 255))


def visualize_boxes_and_labels_on_image_array(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: Sequence[int],
    scores: Optional[Sequence[float]] = None,
    category_index: Optional[Dict[int, str]] = None,
    min_score_thresh: float = 0.5,
    line_thickness: int = 2,
    use_normalized_coordinates: bool = True,
) -> np.ndarray:
    """tf_vis_utils-compatible entry point: draws boxes [N,4] (y1,x1,y2,x2
    when normalized, matching the TF convention) with class/score labels."""
    from PIL import Image, ImageDraw

    cat = category_index if category_index is not None else COCO_CATEGORIES
    img = Image.fromarray(image)
    draw = ImageDraw.Draw(img)
    h, w = image.shape[:2]
    for i in range(len(boxes)):
        score = 1.0 if scores is None else float(scores[i])
        if score < min_score_thresh:
            continue
        y1, x1, y2, x2 = [float(v) for v in boxes[i]]
        if use_normalized_coordinates:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        label = int(classes[i])
        color = _color_for(label)
        for k in range(line_thickness):
            draw.rectangle([x1 - k, y1 - k, x2 + k, y2 + k], outline=color)
        name = cat.get(label, f"id:{label}")
        text = f"{name}: {int(score * 100)}%"
        tw = draw.textlength(text) if hasattr(draw, "textlength") else 7 * len(text)
        draw.rectangle([x1, max(y1 - 12, 0), x1 + tw + 4, max(y1, 12)],
                       fill=color)
        draw.text((x1 + 2, max(y1 - 12, 0)), text, fill=(0, 0, 0))
    np.copyto(image, np.asarray(img))
    return image


def visualize_labels(frame: np.ndarray, bboxes, min_score: float = 0.5,
                     category_index: Optional[Dict[int, str]] = None
                     ) -> np.ndarray:
    """maskrcnn_detection.py's ``visualize_labels`` analog over BoundingBox
    lists (normalized xyxy)."""
    out = np.ascontiguousarray(frame).copy()
    if not bboxes:
        return out
    boxes = np.array([[b.y1, b.x1, b.y2, b.x2] for b in bboxes], np.float32)
    classes = [b.label for b in bboxes]
    scores = [b.score for b in bboxes]
    return visualize_boxes_and_labels_on_image_array(
        out, boxes, classes, scores, category_index,
        min_score_thresh=min_score,
    )


@register_op("TorchDrawBoxes", kind="host", outputs=("frame",))
def torch_draw_boxes(ctx, frame, bboxes, min_score: float = 0.5):
    """Draw labelled boxes (maskrcnn_detection.py's TorchDrawBoxes op;
    'Torch' kept for reference API parity — no torch involved here)."""
    out = []
    for i in range(len(bboxes)):
        out.append(visualize_labels(np.asarray(frame[i]), bboxes[i],
                                    min_score))
    return out
