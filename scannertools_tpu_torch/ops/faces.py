"""Face ops: MTCNNDetectFaces, EmbedFaces, DetectGender.

Reference parity: face_detection.py:8-68 (MTCNN cascade + margins +
normalized BoundingBox output), face_embedding.py:10-89 (crop → 160×160 →
prewhiten → FaceNet → 128-d; zero vector for degenerate crops),
gender_detection.py:10-29 (crop → rude-carnie gender labels).

The structure is the JAX package's (scannertools_tpu's ops/faces.py): each
user-facing op is a *composite* that expands into a device-kind forward
(fixed-shape padded box/embedding arrays) plus a thin host decode that
wraps the padded arrays into per-frame proto/array lists. Model weights
enter the forwards as the op's aux tree, {net: state_dict} of tensors that
the executor moves to the device once; the forwards run the nets with
those weights (``models.common.apply_net``).

When ``EmbedFaces``/``DetectGender`` receive their ``bboxes`` from
``MTCNNDetectFaces``, the composite rewires the *device* box arrays straight
from the MTCNN forward — frames and boxes never leave the device between
the detectors and the crop nets. Any other bbox source goes through the
``BboxesToPadded`` host adapter.

Weights: ``weights_path`` names an npz in the JAX package's layout (what
its ``models/weights.save_params`` writes, or this package's); the same
file gives both packages the same weights. Without one, each model is
initialized from a ``torch.Generator`` seeded with 0: deterministic, but
not the JAX package's random values (those come from ``jax.random``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import protobufs
from ..graph import NodeOutput, OpNode
from ..models import facenet as facenet_lib
from ..models import facenet_detector as facenet_detector_lib
from ..models import faster_rcnn as faster_rcnn_lib
from ..models import gender as gender_lib
from ..models import maskrcnn as maskrcnn_lib
from ..models import mtcnn as mtcnn_lib
from ..models import pose as pose_lib
from ..models import ssd as ssd_lib
from ..models import streetstyle as streetstyle_lib
from ..models import weights as weights_lib
from ..models.common import crop_and_resize
from ..parallel import expert as expert_lib
from ..registry import register_composite, register_op
from ..runtime.executor import _tree_to
from ..utils.framechunk import FrameChunk, as_hwc_f32

_MODEL_CACHE: Dict[Any, Any] = {}

MAX_FACES = mtcnn_lib.MAX_FACES

# name -> the model's module (init_params, from_flax, to_flax), for every
# op that loads weights (the detection ops of objects.py and nn_generic.py,
# the pose, attribute and landmark ops too). The face and hand crop nets
# share OpenPoseCrop but never their weights, nor do the two attribute
# head sets: each has its own name, so its own cache entry. "moe" takes
# its (n_experts, d_model, d_hidden) as its arch.
_MODELS = {"mtcnn": mtcnn_lib, "facenet": facenet_lib, "gender": gender_lib,
           "ssd": ssd_lib, "faster_rcnn": faster_rcnn_lib,
           "maskrcnn": maskrcnn_lib, "openpose": pose_lib,
           "openpose_face": pose_lib.FACE_NET,
           "openpose_hand": pose_lib.HAND_NET,
           "facenet_detector": facenet_detector_lib,
           "streetstyle_clothing": streetstyle_lib.CLOTHING,
           "streetstyle_hairstyle": streetstyle_lib.HAIRSTYLE,
           "moe": expert_lib.MOE}


def _get_params(model: str, weights_path: Optional[str], arch=None):
    """The model's weights as torch tensors on the CPU, once per (model,
    weights_path), and per arch for a model built in several (Mask R-CNN:
    the arch name fixes the tree; MoE: its dims)."""
    key = (model, weights_path) if arch is None else (model, weights_path,
                                                      arch)
    if key not in _MODEL_CACHE:
        lib = _MODELS[model]
        extra = () if arch is None else (arch,)
        if weights_path:
            _MODEL_CACHE[key] = lib.from_flax(
                weights_lib.load_params(weights_path), *extra)
        else:
            _MODEL_CACHE[key] = lib.init_params(0, *extra)
    return _MODEL_CACHE[key]


def _device_state(model: str, weights_path, device: torch.device,
                  arch=None):
    """A model's weights (``_get_params``) on ``device``, once per (model,
    file, device). The executor resolves ``aux`` weight trees for device
    ops only, so host ops that run a net (the pose decode's crop nets, the
    attribute classifiers, the landmarks) move its weights themselves."""
    key = ("device", model, weights_path, arch, str(device))
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = _tree_to(_get_params(model, weights_path, arch),
                                     device)
    return _MODEL_CACHE[key]


def _run_device(ctx) -> torch.device:
    """The run's device (the CPU where a caller gives no context)."""
    dev = getattr(ctx, "device", None)
    return torch.device(dev) if dev is not None else torch.device("cpu")


# ------------------------------------------------------ host frames, crops

def _to_f32_frames(frames) -> np.ndarray:
    """A host op's frames (uint8 [T, H, W, 3] or a host FrameChunk) ->
    float32 numpy [T, H, W, 3]."""
    if isinstance(frames, FrameChunk):
        return frames.host().hwc_u8().astype(np.float32)
    return np.asarray(frames).astype(np.float32)


def _crop_resize_host(frame: np.ndarray, bbox, out_size: int
                      ) -> Optional[np.ndarray]:
    """Reference crop semantics (face_embedding.py:64-72): int-truncated
    normalized coords, cv2 resize (INTER_LINEAR, half-pixel centres); None
    for degenerate crops. The host crop of the attribute classifiers,
    ``CropClassify`` and the landmarks, as in the JAX package: the crop
    kernel samples by another convention (``crop_and_resize``), so these
    crops stay on the host."""
    import cv2

    h, w = frame.shape[:2]
    crop = frame[int(bbox.y1 * h):int(bbox.y2 * h),
                 int(bbox.x1 * w):int(bbox.x2 * w)]
    if crop.shape[0] == 0 or crop.shape[1] == 0:
        return None
    return cv2.resize(crop, (out_size, out_size))


def _host_crops(frames: np.ndarray, bboxes, crop_fn):
    """Every box's crop of the chunk -> (crops [K, ...] float32, or None
    when there is none; src, the (frame, box) of each crop; out, per-frame
    lists of None, a slot a box, for the caller to fill).
    ``crop_fn(frame, bbox)`` returns None for a degenerate box."""
    crops, src = [], []
    out = [[None] * len(bboxes[i]) for i in range(len(bboxes))]
    for i, bbs in enumerate(bboxes):
        for j, bbox in enumerate(bbs):
            c = crop_fn(frames[i], bbox)
            if c is not None:
                crops.append(c)
                src.append((i, j))
    stacked = np.stack(crops).astype(np.float32, copy=False) if crops \
        else None
    return stacked, src, out


# --------------------------------------------------------------- MTCNN

def _mtcnn_aux(ctx, params):
    return _get_params("mtcnn", params.get("weights_path"))


@register_op("MTCNNForward", kind="device", aux=_mtcnn_aux,
             outputs=("array_f32", "array_f32", "array_i32"))
def mtcnn_forward(ctx, aux, frame, weights_path: Optional[str] = None,
                  thresholds=mtcnn_lib.THRESHOLDS):
    """Full MTCNN cascade on device: [T,H,W,3] frames -> margin-expanded
    normalized boxes [T,MAX_FACES,4], scores [T,MAX_FACES], valid mask
    (validity already folds the reference's score>=0.1 filter)."""
    x = as_hwc_f32(frame)
    _, h, w, _ = x.shape
    boxes, scores, valid = mtcnn_lib.detect_batch(aux, x, tuple(thresholds))
    return mtcnn_lib.margins_normalize_device(boxes, scores, valid, h, w)


@register_op("MTCNNDecode", kind="host", outputs=("bboxes",))
def mtcnn_decode(ctx, nboxes, scores, valid):
    """Padded device arrays -> per-frame BoundingBox proto lists
    (face_detection.py:53-64 output contract)."""
    out: List[List[protobufs.BoundingBox]] = []
    for nb, s, v in zip(nboxes, scores, valid):
        out.append([
            protobufs.BoundingBox(x1=float(b[0]), y1=float(b[1]),
                                  x2=float(b[2]), y2=float(b[3]),
                                  score=float(sc))
            for b, sc, vv in zip(nb, s, v) if vv
        ])
    return out


@register_composite("MTCNNDetectFaces")
def _build_mtcnn(inputs, params, device):
    fwd = OpNode("MTCNNForward", dict(inputs), dict(params), device=device)
    return OpNode("MTCNNDecode", {
        "nboxes": NodeOutput(fwd, 0),
        "scores": NodeOutput(fwd, 1),
        "valid": NodeOutput(fwd, 2),
    }, {})


# ------------------------------------------------- bbox adapter (fallback)

@register_op("BboxesToPadded", kind="host",
             outputs=("array_f32", "array_i32"))
def bboxes_to_padded(ctx, bboxes, max_boxes: int = MAX_FACES):
    """Per-frame BoundingBox proto lists -> padded device arrays
    (nboxes [T,K,4], valid [T,K]) for crop-net forwards whose boxes did not
    come from an in-graph detector. Raises (rather than silently dropping
    boxes) when a frame exceeds ``max_boxes`` — pass a bigger cap on the
    consuming op (EmbedFaces/DetectGender ``max_boxes=``)."""
    t = len(bboxes)
    over = max((len(lst) for lst in bboxes), default=0)
    if over > max_boxes:
        raise ValueError(
            f"a frame carries {over} bboxes but the padded crop capacity "
            f"is max_boxes={max_boxes}; raise max_boxes on the op")
    nb = np.zeros((t, max_boxes, 4), np.float32)
    v = np.zeros((t, max_boxes), bool)
    for i, lst in enumerate(bboxes):
        for j, b in enumerate(lst):
            nb[i, j] = (b.x1, b.y1, b.x2, b.y2)
            v[i, j] = True
    return nb, v


def _device_boxes(bb: NodeOutput, max_boxes: int = MAX_FACES):
    """Rewire to the MTCNN forward's device arrays when ``bboxes`` comes from
    MTCNNDetectFaces; otherwise adapt host protos to padded arrays."""
    if isinstance(bb.node, OpNode) and bb.node.name == "MTCNNDecode":
        return bb.node.inputs["nboxes"], bb.node.inputs["valid"]
    conv = OpNode("BboxesToPadded", {"bboxes": bb},
                  {"max_boxes": max_boxes})
    return NodeOutput(conv, 0), NodeOutput(conv, 1)


def _crop_px_boxes(nb: torch.Tensor, h: int, w: int):
    """Reference crop semantics (face_embedding.py:64-72): int-truncated
    pixel corners; degenerate when the truncated span is empty. nb: [.., 4]
    normalized -> (px [.., 4], ok [..])."""
    x1 = torch.trunc(nb[..., 0] * w)
    y1 = torch.trunc(nb[..., 1] * h)
    x2 = torch.trunc(nb[..., 2] * w)
    y2 = torch.trunc(nb[..., 3] * h)
    ok = (x2 > x1) & (y2 > y1)
    return torch.stack([x1, y1, x2, y2], dim=-1), ok


# --------------------------------------------------------------- EmbedFaces

def _compact_crops(x, nboxes, valid, size: int, budget_per_frame: int):
    """Cross-frame crop compaction: instead of running T×MAX_FACES padded
    crops through the net (≥16× padded-compute waste at typical ≤2
    faces/frame), select the first B = T·budget valid slots across the
    WHOLE chunk (a stable sort of the validity mask, as the JAX package's
    top_k keeps index order among ties), extract just those crops in one
    launch (a frame index per box), and return scatter metadata to map net
    outputs back to [T, MAX_FACES] slots. Slots beyond the budget
    (chunk-average > ``budget`` faces/frame) fall back to the
    degenerate-crop output; pass ``faces_budget=MAX_FACES`` for
    exactness."""
    t, h, w, _ = x.shape
    k = nboxes.shape[1]
    B = min(t * k, max(1, budget_per_frame) * t)
    px, ok = _crop_px_boxes(nboxes, h, w)  # [T,K,4], [T,K]
    want = (valid & ok).reshape(t * k)
    # first B valid slots in frame-major order, then invalid ones
    sel = torch.sort(want.to(torch.float32), descending=True,
                     stable=True).indices[:B]
    sel_ok = want[sel]
    crops = crop_and_resize(x, px.reshape(t * k, 4)[sel], (size, size),
                            torch.div(sel, k, rounding_mode="floor"))
    return crops, sel, sel_ok, valid & ok


def _scatter_rows(vals, sel, sel_ok, t: int, k: int):
    """[B, D] net outputs -> [T, K, D], zeros elsewhere."""
    d = vals.shape[-1]
    flat = vals.new_zeros((t * k, d))
    flat[sel] = torch.where(sel_ok[:, None], vals, 0)
    return flat.reshape(t, k, d)


def _overflow_rows(sel, sel_ok, want, t: int, k: int):
    """Per-frame count of valid crops NOT selected under the budget — the
    decode stage surfaces these instead of letting budget overflow
    masquerade as the degenerate-crop zero sentinel."""
    emb = torch.zeros(t * k, dtype=torch.bool, device=sel.device)
    emb[sel] = sel_ok
    return (want.reshape(t, k).sum(dim=1)
            - emb.reshape(t, k).sum(dim=1)).to(torch.int32)


def _facenet_aux(ctx, params):
    return _get_params("facenet", params.get("weights_path"))


@register_op("FaceEmbedForward", kind="device", aux=_facenet_aux,
             outputs=("array_f32", "array_i32", "array_i32"))
def face_embed_forward(ctx, aux, frame, nboxes, valid,
                       weights_path: Optional[str] = None,
                       minibatch: int = 5, faces_budget: int = 8):
    """Crop + 160x160 resize + prewhiten + FaceNet on device:
    -> (embs [T,MAX_FACES,128], valid [T,MAX_FACES], overflow [T]).
    Degenerate crops emit the reference's zero vector
    (face_embedding.py:70). ``minibatch`` is accepted for API parity; the
    crop batch is compacted across the chunk to ``faces_budget``·T crops
    (see _compact_crops); ``overflow`` counts valid faces per frame beyond
    that budget (zero-embedded; the decode stage warns)."""
    x = as_hwc_f32(frame)
    t = x.shape[0]
    k = nboxes.shape[1]
    crops, sel, sel_ok, want = _compact_crops(x, nboxes, valid, 160,
                                              faces_budget)
    embs = facenet_lib.embed(aux, crops)  # [B, 128]
    return (_scatter_rows(embs, sel, sel_ok, t, k), valid,
            _overflow_rows(sel, sel_ok, want, t, k))


@register_op("EmbedDecode", kind="host", outputs=("facenet_embeddings",))
def embed_decode(ctx, embs, valid, overflow=None):
    n_over = int(np.sum(overflow)) if overflow is not None else 0
    if n_over:
        import warnings

        warnings.warn(
            f"EmbedFaces: {n_over} valid faces beyond faces_budget got the "
            "zero-vector sentinel; pass faces_budget=<max faces/frame> to "
            "EmbedFaces for exhaustive embedding", stacklevel=2)
    out = []
    for E, V in zip(embs, valid):
        rows = [e for e, v in zip(E, V) if v]
        out.append(np.stack(rows).astype(np.float32) if rows
                   else np.zeros((0, 128), np.float32))
    return out


@register_composite("EmbedFaces")
def _build_embed(inputs, params, device):
    params = dict(params)
    mb = params.pop("max_boxes", MAX_FACES)
    nboxes, valid = _device_boxes(inputs["bboxes"], mb)
    fwd = OpNode("FaceEmbedForward",
                 {"frame": inputs["frame"], "nboxes": nboxes, "valid": valid},
                 params, device=device)
    return OpNode("EmbedDecode", {"embs": NodeOutput(fwd, 0),
                                  "valid": NodeOutput(fwd, 1),
                                  "overflow": NodeOutput(fwd, 2)}, {})


# ------------------------------------------------------------- DetectGender

def _gender_aux(ctx, params):
    return _get_params("gender", params.get("weights_path"))


@register_op("GenderForward", kind="device", aux=_gender_aux,
             outputs=("array_i32", "array_i32", "array_i32"))
def gender_forward(ctx, aux, frame, nboxes, valid,
                   weights_path: Optional[str] = None,
                   faces_budget: int = 8):
    """Crop + 227x227 resize + Levi–Hassner on device -> (labels
    [T,MAX_FACES] int32, valid, overflow [T]). Degenerate crops label 0
    ('M'), matching the host path's LABELS[0] fallback. Crop batch
    compacted across the chunk (see _compact_crops); ``overflow`` counts
    valid faces beyond the budget (the decode stage warns)."""
    x = as_hwc_f32(frame)
    t = x.shape[0]
    k = nboxes.shape[1]
    crops, sel, sel_ok, want = _compact_crops(x, nboxes, valid,
                                              gender_lib.INPUT_SIZE,
                                              faces_budget)
    labels = gender_lib.classify(aux, crops)  # [B] int32
    out = _scatter_rows(labels[:, None], sel, sel_ok, t, k)[..., 0]
    return out, valid, _overflow_rows(sel, sel_ok, want, t, k)


@register_op("GenderDecode", kind="host", outputs=("object",))
def gender_decode(ctx, labels, valid, overflow=None):
    n_over = int(np.sum(overflow)) if overflow is not None else 0
    if n_over:
        import warnings

        warnings.warn(
            f"DetectGender: {n_over} valid faces beyond faces_budget got "
            "label 'M' by budget truncation; pass faces_budget=<max faces/"
            "frame> for exhaustive classification", stacklevel=2)
    return [
        [gender_lib.LABELS[int(l)] for l, v in zip(L, V) if v]
        for L, V in zip(labels, valid)
    ]


@register_composite("DetectGender")
def _build_gender(inputs, params, device):
    params = dict(params)
    mb = params.pop("max_boxes", MAX_FACES)
    nboxes, valid = _device_boxes(inputs["bboxes"], mb)
    fwd = OpNode("GenderForward",
                 {"frame": inputs["frame"], "nboxes": nboxes, "valid": valid},
                 params, device=device)
    return OpNode("GenderDecode", {"labels": NodeOutput(fwd, 0),
                                   "valid": NodeOutput(fwd, 1),
                                   "overflow": NodeOutput(fwd, 2)}, {})
