"""Pose ops + Pose type.

Reference parity: the ``OpenPose`` op (openpose_kernel.cpp:14-233 — packs
per-person floats [score, 18·3 pose, 70·3 face, 2·21·3 hands]) and the
``Pose`` registered type (scannertools_caffe/pose_detection.py:3-157:
normalized keypoints, face/body bbox derivation, draw pairs/colors,
``distance_to`` median-keypoint metric, PoseList uniform list).

The JAX package's ops/pose.py on torch: ``OpenPoseForward`` (the body net,
``find_peaks`` and the limb integrals on the device) and
``OpenPoseDecode`` (the grouping on the host, then, with
``compute_face``/``compute_hands``, the face and hand crop nets on crops
cut on the device from the chunk's frames by the crop kernel's gray mode),
joined by the ``OpenPose`` composite; and the CPM2 name-parity chain
``CPM2Input`` → ``CPM2`` → ``CPM2Output``.

Two departures from the JAX package, each tested:
``OpenPose`` passes ``pose_upsample`` on to its forward (the JAX composite
drops it, so there its cubic option is reached only through
``OpenPoseForward``), and the crop nets run on the crops as they come, with
no padding of the batch to a multiple of 4 (a shape cache of jit's).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graph import NodeOutput, OpNode
from ..models import pose as pose_lib
from ..models.common import crop_and_resize
from ..registry import register_composite, register_op
from ..types import register_type
from ..utils.framechunk import FrameChunk, as_hwc_f32
from ..utils.numerics import div, resize_hw
from .faces import _device_state, _get_params, _run_device


class Pose:
    POSE_KEYPOINTS = 18
    POSE_SCORES = 1
    FACE_KEYPOINTS = 70
    HAND_KEYPOINTS = 21

    (Nose, Neck, RShoulder, RElbow, RWrist, LShoulder, LElbow, LWrist,
     RHip, RKnee, RAnkle, LHip, LKnee, LAnkle, REye, LEye, REar,
     LEar) = range(18)
    Background = 18

    DRAW_PAIRS = [[1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8],
                  [8, 9], [9, 10], [1, 11], [11, 12], [12, 13], [1, 0],
                  [0, 14], [14, 16], [0, 15], [15, 17]]

    DRAW_COLORS = [[255, 0, 85], [255, 0, 0], [255, 85, 0], [255, 170, 0],
                   [255, 255, 0], [170, 255, 0], [85, 255, 0], [0, 255, 0],
                   [0, 255, 85], [0, 255, 170], [0, 255, 255], [0, 170, 255],
                   [0, 85, 255], [0, 0, 255], [255, 0, 170], [170, 0, 255],
                   [255, 0, 255], [85, 0, 255]]

    def __init__(self, score: float, kp: np.ndarray):
        self._score = float(score)
        self._kp = np.asarray(kp, np.float32)  # [130, 3] normalized

    # --- (de)serialization: [score] + 130x3 f32, fixed stride ----------
    @classmethod
    def kp_count(cls) -> int:
        return cls.POSE_KEYPOINTS + cls.FACE_KEYPOINTS + 2 * cls.HAND_KEYPOINTS

    @classmethod
    def kp_size(cls) -> int:
        return cls.kp_count() * 3 + cls.POSE_SCORES  # floats per person

    def serialize(self) -> bytes:
        arr = np.concatenate([[self._score], self._kp.reshape(-1)])
        return arr.astype(np.float32).tobytes()

    @classmethod
    def deserialize(cls, buf: bytes) -> "Pose":
        arr = np.frombuffer(buf, np.float32)
        return cls(arr[0], arr[1:].reshape(cls.kp_count(), 3))

    # --- accessors (pose_detection.py:59-71) ----------------------------
    def pose_keypoints(self) -> np.ndarray:
        return self._kp[: self.POSE_KEYPOINTS]

    def face_keypoints(self) -> np.ndarray:
        return self._kp[self.POSE_KEYPOINTS:
                        self.POSE_KEYPOINTS + self.FACE_KEYPOINTS]

    def hand_keypoints(self):
        base = self._kp[self.POSE_KEYPOINTS + self.FACE_KEYPOINTS:]
        return [base[: self.HAND_KEYPOINTS], base[self.HAND_KEYPOINTS:]]

    # --- derived boxes (pose_detection.py:73-113) ------------------------
    def face_bbox(self):
        """The face box from the eyes, ears and nose. As in the JAX package
        (and the reference), its height is the width of x normalized by W
        laid along y normalized by H: square only on a square frame."""
        p = self.pose_keypoints()
        pts = [p[i] for i in (self.REye, self.LEye, self.REar, self.LEar,
                              self.Nose)]
        valid = [pt for pt in pts if pt[2] > 0.05]
        if not valid:
            return [(0, 0), (0, 0), 0]
        face = np.array(valid, ndmin=2)
        xmin, xmax = face[:, 0].min(), face[:, 0].max()
        width = xmax - xmin
        xmin -= width * 0.1
        xmax += width * 0.1
        yavg = float(np.mean(face[:, 1]))
        score = min(p[self.REar, 2], p[self.LEar, 2], p[self.Nose, 2])
        return [(xmin, yavg - width), (xmax, yavg + width), score]

    def body_bbox(self):
        p = self.pose_keypoints()
        return [(p[:, 0].min(), p[:, 1].min()),
                (p[:, 0].max(), p[:, 1].max()), float(np.mean(p[:, 2]))]

    def draw(self, img, thickness: int = 5, draw_threshold: float = 0.05):
        import cv2

        def to_pt(i):
            x, y = self._kp[i, 0], self._kp[i, 1]
            if not (0 <= x < 1 and 0 <= y < 1 and x == x and y == y):
                return None
            return (int(x * img.shape[1]), int(y * img.shape[0]))

        for (a, b), color in zip(self.DRAW_PAIRS, self.DRAW_COLORS):
            if self._kp[a, 2] > draw_threshold and \
                    self._kp[b, 2] > draw_threshold:
                pa, pb = to_pt(a), to_pt(b)
                if pa is not None and pb is not None:
                    cv2.line(img, pa, pb, color, thickness)
        return img

    def distance_to(self, pose: "Pose",
                    confidence_threshold: float = 0.2) -> float:
        kp, other = self.pose_keypoints(), pose.pose_keypoints()
        ds = [
            math.hypot(other[i, 0] - kp[i, 0], other[i, 1] - kp[i, 1])
            for i in range(self.POSE_KEYPOINTS)
            if kp[i, 2] > confidence_threshold
            and other[i, 2] > confidence_threshold
        ]
        return float(np.median(ds)) if ds else float("inf")


_STRIDE = Pose.kp_size() * 4  # bytes per person


def _ser_pose_list(poses: List[Pose]) -> bytes:
    return b"".join(p.serialize() for p in poses)


def _parse_pose_list(buf: bytes) -> List[Pose]:
    return [Pose.deserialize(buf[i : i + _STRIDE])
            for i in range(0, len(buf), _STRIDE)]


register_type("pose_list", _ser_pose_list, _parse_pose_list)


def _hand_box(pose: Pose, wrist: int, elbow: int):
    """Hand rectangle from forearm keypoints — the wrapper's handDetector
    heuristic (center = wrist extended 1/3 past the elbow→wrist direction,
    side ∝ forearm length; openpose src/openpose/hand/handDetector.cpp).
    Normalized coords in, normalized (x0, y0, x1, y1, score) out. As in the
    JAX package, the side is a length of mixed units (x normalized by W, y
    by H) laid along both axes."""
    p = pose.pose_keypoints()
    w_, e_ = p[wrist], p[elbow]
    if w_[2] < 0.05 or e_[2] < 0.05:
        return None
    cx = w_[0] + 0.33 * (w_[0] - e_[0])
    cy = w_[1] + 0.33 * (w_[1] - e_[1])
    side = 1.2 * float(np.hypot(w_[0] - e_[0], w_[1] - e_[1]))
    if side <= 0:
        return None
    return (cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2,
            float(min(w_[2], e_[2])))


def crop_boxes(items: torch.Tensor, h: int, w: int):
    """items [K, 5] float32 rows of (frame_idx, x0, y0, x1, y1) with
    normalized boxes -> (pixel boxes [K, 4] float32, frame indices [K]
    int64). The corners round to whole pixels as the host crop did: x0 =
    round(x0n * W), bw = max(round(x1n * W) - x0, 1) (half to even, as
    ``jnp.round``), the box (x0, y0, x0 + bw, y0 + bh)."""
    x0 = torch.round(items[:, 1] * w)
    y0 = torch.round(items[:, 2] * h)
    bw = torch.clamp_min(torch.round(items[:, 3] * w) - x0, 1.0)
    bh = torch.clamp_min(torch.round(items[:, 4] * h) - y0, 1.0)
    return (torch.stack([x0, y0, x0 + bw, y0 + bh], dim=1).contiguous(),
            items[:, 0].to(torch.int64))


def crop_batch(frames: torch.Tensor, items: torch.Tensor,
               size: int) -> torch.Tensor:
    """frames [T, H, W, 3] float32, items [K, 5] (``crop_boxes``) -> [K,
    size, size, 3] crops in [-0.5, 0.5] (the JAX package's
    ``_crop_batch_device``): the crop kernel's gray mode on the rounded
    pixel boxes, taps outside the frame reading gray (128)."""
    boxes, frame_idx = crop_boxes(items, *frames.shape[1:3])
    return crop_and_resize(frames, boxes, (size, size), frame_idx,
                           gray=True)


def _run_crop_net(tag: str, weights_path, n_kp: int, frames: torch.Tensor,
                  items: List, size: int) -> np.ndarray:
    """The crops of ``items`` cut from the chunk's frames on their device,
    and the crop net ``tag`` over them in one call -> [len(items), n_kp,
    3] crop-normalized keypoints (numpy)."""
    state = _device_state(tag, weights_path, frames.device)
    it = torch.as_tensor(np.asarray(items, np.float32), device=frames.device)
    crops = crop_batch(frames, it, size)
    return pose_lib.crop_keypoints(state, crops, n_kp).cpu().numpy()


def _write_back(kp_full: np.ndarray, slot: int, n_kp: int, box,
                crop_kp: np.ndarray) -> None:
    """Map crop-normalized keypoints into frame-normalized Pose slots."""
    x0, y0, x1, y1 = box[:4]
    kp_full[slot:slot + n_kp, 0] = x0 + crop_kp[:, 0] * (x1 - x0)
    kp_full[slot:slot + n_kp, 1] = y0 + crop_kp[:, 1] * (y1 - y0)
    kp_full[slot:slot + n_kp, 2] = crop_kp[:, 2]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on_device(ctx, x) -> torch.Tensor:
    """An array, a list of per-frame arrays or a tensor -> a float32
    tensor on the run's device (a tensor stays where it is)."""
    if isinstance(x, FrameChunk):
        x = x.hwc_f32()
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    if isinstance(x, list):
        x = np.stack([np.asarray(a, np.float32) for a in x])
    return torch.as_tensor(np.asarray(x)).to(_run_device(ctx),
                                             torch.float32).contiguous()


def _openpose_aux(ctx, params):
    return _get_params("openpose", params.get("weights_path"))


@register_op("OpenPoseForward", kind="device", aux=_openpose_aux,
             outputs=("array_f32", "array_i32", "array_f32", "array_i32"))
def openpose_forward(ctx, aux, frame, weights_path: Optional[str] = None,
                     pose_num_scales: int = 1, pose_scale_gap: float = 0.1,
                     pose_upsample: str = "linear"):
    """Body network + peak finding + PAF line integrals on the device.
    ``pose_num_scales``/``pose_scale_gap`` follow the reference op's
    multi-scale knobs (openpose_kernel.cpp:94-141): each scale runs the
    net at its own resolution and the raw outputs merge at the largest
    scale's net-output grid (models/pose.merge_scale_maps).
    ``pose_upsample`` "cubic" applies OpenPose's wrapper resize to the
    grid-to-frame upsample and the merge's last resize. Outputs: peaks
    [T,18,P,3] (padded-pixel coords), valid, limb scores, dims [T,2] = (h,
    w) unpadded."""
    x = as_hwc_f32(frame)
    t, h, w, _ = x.shape
    # pad with zeros to a multiple of 8 (the network's stride)
    x = F.pad(x, (0, 0, 0, (-w) % 8, 0, (-h) % 8))
    scales = tuple(
        max(0.1, 1.0 - i * pose_scale_gap) for i in range(pose_num_scales)
    )
    peaks, valid, scores = pose_lib.device_stage(aux, x, scales,
                                                 upsample=pose_upsample)
    dims = torch.tensor([[h, w]], dtype=torch.int32,
                        device=x.device).repeat(t, 1)
    return peaks, valid, scores, dims


@register_op("OpenPoseDecode", kind="host", outputs=("pose_list",),
             device_inputs=True)
def openpose_decode(ctx, peaks, valid, scores, dims, frame=None,
                    compute_face: bool = False, compute_hands: bool = False,
                    face_weights_path: Optional[str] = None,
                    hand_weights_path: Optional[str] = None,
                    crop_net_size: int = 368, batch: int = 0):
    """PAF grouping + Pose assembly on the host; keypoints are emitted
    normalized to [0,1] like the reference Pose type expects.

    ``compute_face``/``compute_hands`` run the CMU crop sub-networks
    (openpose_kernel.cpp:108-141): face crops from the body-derived face
    box, hand crops from the forearm heuristic, each decoded by per-channel
    argmax and written into the 130-keypoint layout's face/hand slots. The
    crops are cut on the device from the chunk's frames (``frame`` comes in
    as the device's value: ``device_inputs``), one crop-net call per net
    and chunk. ``crop_net_size`` is the crop resolution (the wrapper's
    368×368); ``batch`` is accepted for API parity."""
    peaks, valid, scores, dims = (_host(a) for a in (peaks, valid, scores,
                                                     dims))
    t = peaks.shape[0]

    out: List[List[Pose]] = []
    for i in range(t):
        h, w = int(dims[i][0]), int(dims[i][1])
        people = pose_lib.group_people(peaks[i], valid[i], scores[i])
        poses = []
        for score, kp in people:
            full = np.zeros((Pose.kp_count(), 3), np.float32)
            body = kp.copy()
            body[:, 0] /= w  # normalize like the reference Pose type
            body[:, 1] /= h
            full[: Pose.POSE_KEYPOINTS] = body
            poses.append(Pose(score, full))
        out.append(poses)

    if compute_face or compute_hands:
        if frame is None:
            raise ValueError(
                "OpenPose compute_face/compute_hands need the frame input")
        FK, HK = Pose.FACE_KEYPOINTS, Pose.HAND_KEYPOINTS
        face_slot = Pose.POSE_KEYPOINTS
        lhand_slot = face_slot + FK
        rhand_slot = lhand_slot + HK
        # gather (pose, slot, box) work items across the whole chunk
        face_items, hand_items = [], []
        for i, poses in enumerate(out):
            for p in poses:
                if compute_face:
                    (fx0, fy0), (fx1, fy1), fs = p.face_bbox()
                    if fs > 0.05 and fx1 > fx0:
                        face_items.append((p, (fx0, fy0, fx1, fy1), i))
                if compute_hands:
                    for slot, wrist, elbow in (
                            (lhand_slot, Pose.LWrist, Pose.LElbow),
                            (rhand_slot, Pose.RWrist, Pose.RElbow)):
                        hb = _hand_box(p, wrist, elbow)
                        if hb is not None:
                            hand_items.append((p, slot, hb, i))
        if face_items or hand_items:
            frames = _on_device(ctx, frame)
        if face_items:
            kps = _run_crop_net(
                "openpose_face", face_weights_path, FK, frames,
                [(i, *box) for _, box, i in face_items], crop_net_size)
            for (p, box, _), ckp in zip(face_items, kps):
                _write_back(p._kp, face_slot, FK, box, ckp)
        if hand_items:
            kps = _run_crop_net(
                "openpose_hand", hand_weights_path, HK, frames,
                [(i, *box[:4]) for _, _, box, i in hand_items],
                crop_net_size)
            for (p, slot, box, _), ckp in zip(hand_items, kps):
                _write_back(p._kp, slot, HK, box, ckp)
    return out


@register_composite("OpenPose")
def _build_openpose(inputs, params, device):
    fwd_params = {k: params[k] for k in
                  ("weights_path", "pose_num_scales", "pose_scale_gap",
                   "pose_upsample")
                  if k in params}
    dec_params = {k: params[k] for k in
                  ("compute_face", "compute_hands", "face_weights_path",
                   "hand_weights_path", "crop_net_size", "batch")
                  if k in params}
    fwd = OpNode("OpenPoseForward", dict(inputs), fwd_params, device=device)
    dec_inputs = {
        "peaks": NodeOutput(fwd, 0),
        "valid": NodeOutput(fwd, 1),
        "scores": NodeOutput(fwd, 2),
        "dims": NodeOutput(fwd, 3),
    }
    if dec_params.get("compute_face") or dec_params.get("compute_hands"):
        dec_inputs["frame"] = inputs["frame"]
    return OpNode("OpenPoseDecode", dec_inputs, dec_params)


# ----------------------------------------------- CPM2 name-parity surface

@register_op("CPM2Input", kind="device", outputs=("array_f32",))
def cpm2_input(ctx, frame, scale: float = 1.0):
    """CPM2 preprocessing (cpm2_input_kernel_gpu.cpp:97-141): scale
    (linear, without antialiasing), pad W/H to a multiple of 8 with
    gray(128), map to [-0.5, 0.5] f32. [T, H, W, 3] -> [T, H', W', 3]."""
    x = as_hwc_f32(frame)
    _, h, w, _ = x.shape
    if scale != 1.0:
        h, w = int(round(h * scale)), int(round(w * scale))
        x = resize_hw(x, 1, h, w, "linear")
    x = F.pad(x, (0, 0, 0, (-w) % 8, 0, (-h) % 8), value=128.0)
    return div(x, 256.0) - 0.5


@register_op("CPM2", kind="device", aux=_openpose_aux,
             outputs=("array_f32", "array_f32"))
def cpm2(ctx, aux, cpm2_input, weights_path: Optional[str] = None):
    """CPM2 network forward (cpm2_kernel.cpp:13-52): heat maps [T, H, W,
    19] and PAF maps [T, H, W, 38] (the JAX package's layout), linearly
    resized to the input's resolution (the ImResizeLayer contract)."""
    x = torch.as_tensor(cpm2_input).to(torch.float32)
    _, h, w, _ = x.shape
    heat, paf = pose_lib.infer_maps(aux, x.permute(0, 3, 1, 2), (h, w))
    return (heat.permute(0, 2, 3, 1).contiguous(),
            paf.permute(0, 2, 3, 1).contiguous())


@register_op("CPM2Output", kind="host", outputs=("pose_list",),
             device_inputs=True)
def cpm2_output(ctx, cpm2_resized_map, cpm2_joints, original_frame_info,
                threshold: float = pose_lib.THRE_PEAK):
    """PAF grouping over precomputed maps (cpm2_output_kernel_cpu.cpp:
    115-773 semantics; see models/pose.py). cpm2_resized_map: heat maps
    [T, H, W, 19], cpm2_joints: PAF maps [T, H, W, 38], on the run's
    device (they move there if they come from the host), where
    ``find_peaks`` and ``limb_scores`` run for the chunk;
    original_frame_info: FrameInfo for normalization. ``threshold`` is
    accepted for API parity: the peaks take THRE_PEAK, as in the JAX
    package."""
    heat = _on_device(ctx, cpm2_resized_map).permute(0, 3, 1, 2).contiguous()
    paf = _on_device(ctx, cpm2_joints).permute(0, 3, 1, 2).contiguous()
    peaks, valid = pose_lib.find_peaks(heat)
    scores = pose_lib.limb_scores(paf, peaks, valid)
    peaks, valid, scores = _host(peaks), _host(valid), _host(scores)
    out = []
    for t in range(peaks.shape[0]):
        people = pose_lib.group_people(peaks[t], valid[t], scores[t])
        fi = original_frame_info[t]
        poses = []
        for score, kp in people:
            full = np.zeros((Pose.kp_count(), 3), np.float32)
            body = kp.copy()
            body[:, 0] /= max(fi.width, 1)
            body[:, 1] /= max(fi.height, 1)
            full[: Pose.POSE_KEYPOINTS] = body
            poses.append(Pose(score, full))
        out.append(poses)
    return out
