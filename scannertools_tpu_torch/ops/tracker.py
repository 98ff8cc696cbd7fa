"""Object tracking op — stateful track management over per-frame detections.

Reference parity: ``TrackObjects`` (tracker.py:12-80, bounded_state=5):
detections are merged into existing tracks when IoU > 0.25; unmerged
detections start a new cv2 MIL tracker; tracks unmerged for > 10 frames are
dropped; per-frame output is the current track boxes. ``reset()`` supports
out-of-order scheduling.

Single-object appearance trackers are sequential host work in the
reference; here, as in the JAX package (scannertools_tpu's ops/tracker.py),
the same track-management logic runs per frame with a pluggable
single-frame tracker. By default OpenCV MIL is used (like the reference);
where it cannot start on a detection, a constant-position tracker keeps
the dataflow semantics (detection merging, aging, drops) intact, and the
port warns, naming the exception (the JAX package falls back silently).
Track identity is exposed via ``track_id`` so downstream ops can join
per-track data — a capability the reference lacks.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np

from .. import protobufs
from ..registry import register_op

IOU_MERGE = 0.25   # tracker.py:36
MAX_AGE = 10       # tracker.py:55


def _iou(a: protobufs.BoundingBox, b: protobufs.BoundingBox) -> float:
    x1 = max(a.x1, b.x1)
    y1 = max(a.y1, b.y1)
    x2 = min(a.x2, b.x2)
    y2 = min(a.y2, b.y2)
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    area_a = max(a.x2 - a.x1, 0) * max(a.y2 - a.y1, 0)
    area_b = max(b.x2 - b.x1, 0) * max(b.y2 - b.y1, 0)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


class _MILTracker:
    def __init__(self, frame: np.ndarray, box: protobufs.BoundingBox):
        import cv2

        self._t = cv2.TrackerMIL_create()
        self._t.init(np.ascontiguousarray(frame),
                     (int(box.x1), int(box.y1),
                      int(box.x2 - box.x1), int(box.y2 - box.y1)))

    def update(self, frame: np.ndarray) -> Optional[protobufs.BoundingBox]:
        ok, (x, y, w, h) = self._t.update(np.ascontiguousarray(frame))
        if not ok:
            return None
        return protobufs.BoundingBox(x1=x, y1=y, x2=x + w, y2=y + h)


class _StaticTracker:
    """Fallback: holds the detection box (tests / no-cv2 environments)."""

    def __init__(self, frame, box: protobufs.BoundingBox):
        self._box = box

    def update(self, frame) -> Optional[protobufs.BoundingBox]:
        return self._box


def _make_tracker(kind: str, frame, box):
    if kind == "mil":
        try:
            return _MILTracker(frame, box)
        except Exception as e:  # cv2 raises cv2.error, or a missing API
            warnings.warn(
                f"TrackObjects: the MIL tracker failed on a detection "
                f"({type(e).__name__}: {e}); holding its box instead",
                stacklevel=2)
            return _StaticTracker(frame, box)
    return _StaticTracker(frame, box)


def _track_init(ctx):
    return {"trackers": [], "last_merge": [], "ids": [],
            "prev_bboxes": [], "next_id": 0}


@register_op("TrackObjects", kind="stateful", outputs=("bboxes",),
             init_state=_track_init)
def track_objects(ctx, state, frames, bboxes, tracker: str = "mil"):
    """frames: [T,H,W,3] u8; bboxes: per-frame BoundingBox lists (absolute
    pixel coords, like the reference's usage)."""
    out: List[List[protobufs.BoundingBox]] = []
    t = len(bboxes)
    for i in range(t):
        frame = np.asarray(frames[i])
        detections = bboxes[i] or []
        # merge detections into existing tracks (tracker.py:30-47)
        for det in detections:
            merged = False
            for k, prev in enumerate(state["prev_bboxes"]):
                if prev is not None and _iou(prev, det) > IOU_MERGE:
                    state["last_merge"][k] = 0
                    merged = True
                    break
            if not merged:
                state["trackers"].append(_make_tracker(tracker, frame, det))
                state["last_merge"].append(0)
                state["ids"].append(state["next_id"])
                state["next_id"] += 1

        # advance all live tracks (tracker.py:49-75)
        new_trackers, new_merge, new_ids, boxes_now = [], [], [], []
        for k, trk in enumerate(state["trackers"]):
            state["last_merge"][k] += 1
            if state["last_merge"][k] > MAX_AGE:
                continue
            box = trk.update(frame)
            if box is None:
                continue
            box.track_id = state["ids"][k]
            new_trackers.append(trk)
            new_merge.append(state["last_merge"][k])
            new_ids.append(state["ids"][k])
            boxes_now.append(box)
        state["trackers"] = new_trackers
        state["last_merge"] = new_merge
        state["ids"] = new_ids
        state["prev_bboxes"] = boxes_now
        out.append(boxes_now)
    return state, out
