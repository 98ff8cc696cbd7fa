"""Faster R-CNN (VGG16 backbone).

Reference parity: the ``FasterRCNN`` Caffe op (faster_rcnn_kernel.cpp:6-33)
runs a py-faster-rcnn VGG16 network (81 COCO classes — the decode kernel
hardcodes CLASSES 81, faster_rcnn_output_kernel_cpu.cpp:11) with an
``im_info`` blob of (height, width, scale=1) and emits three blobs per
frame: ``cls_prob`` [R,81], ``rois`` [R,5] (batch, x1, y1, x2, y2 in input
pixels), ``fc7`` [R,4096]. The topology is the JAX package's
(scannertools_tpu's models/faster_rcnn.py): VGG16 conv1_1..conv5_3 → RPN
(rpn_conv/3x3, rpn_cls_score, rpn_bbox_pred) → proposal decode → RoIAlign
→ fc6/fc7 → cls_score softmax, as an ``nn.Module`` whose parameter names
follow the flax tree (``vgg.conv1_1``, ``rpn_conv``, ``fc6``), in full
float32 (``common.full_f32``), on NHWC input.

Its static shapes are the JAX package's: the proposal layer keeps the top
``pre_nms`` anchors by foreground score, greedy NMS keeps ``num_rois`` rows
padded with invalid ones, and padded rows emit cls_prob = one-hot
background (the decode can never select them). The whole chunk is batched:
one ``nms`` launch for all frames' proposals, one ``crop_and_resize``
launch for all frames' RoIs (a frame index per box) at 7x7 on the conv5_3
map, C = 512. Where the anchors are fewer than ``num_rois`` the JAX
package's ``nms`` returns num_rois + 1 rows (its discard slot, one-hot
background after the forward); this returns num_rois.

Layouts: the RPN's channels are read NHWC as flax lays them out
(``rpn_cls_score``'s 18 as [2, 9]: bg, fg; ``rpn_bbox_pred``'s 36 as
[9, 4]); fc6 reads the crops' HWC flatten, which is the layout the crop
kernel writes, so it takes the flax kernel transposed (the caffe CHW
permutation stays in ``porting_maps.faster_rcnn_mapping`` for caffe
weights). ``bbox_pred`` is held but unused: the reference decode consumes
raw rois (faster_rcnn_output_kernel_cpu.cpp:44-47).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import porting_maps
from . import weights as weights_lib
from .common import (_skeleton, apply_net, crop_and_resize, nms,
                     topk_stable)

NUM_CLASSES = 81          # COCO 80 + background
NUM_ROIS = 300            # py-faster-rcnn TEST.RPN_POST_NMS_TOP_N
PRE_NMS = 2048            # the JAX package's static pre-NMS pool
RPN_NMS_THRESH = 0.7      # TEST.RPN_NMS_THRESH
MIN_SIZE = 16.0           # TEST.RPN_MIN_SIZE
STRIDE = 16               # VGG16 conv5_3 stride
ANCHOR_SCALES = (8.0, 16.0, 32.0)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
POOL = 7                  # RoI pool output 7x7
FEAT = 512                # conv5_3 channels


def anchors_for(h: int, w: int) -> np.ndarray:
    """[h*w*9, 4] anchors (x1,y1,x2,y2), py-faster-rcnn generation: base
    16x16 box reshaped per ratio (round-per-ratio), scaled per scale,
    shifted by STRIDE per cell."""
    base = 16.0
    ws, hs = [], []
    size = base * base
    for r in ANCHOR_RATIOS:
        w_r = np.round(np.sqrt(size / r))
        h_r = np.round(w_r * r)
        for s in ANCHOR_SCALES:
            ws.append(w_r * s)
            hs.append(h_r * s)
    ws = np.asarray(ws)
    hs = np.asarray(hs)
    cx = (base - 1) / 2.0
    cy = (base - 1) / 2.0
    base_anchors = np.stack(
        [cx - (ws - 1) / 2, cy - (hs - 1) / 2,
         cx + (ws - 1) / 2, cy + (hs - 1) / 2], axis=1)  # [9,4]
    sx = np.arange(w) * STRIDE
    sy = np.arange(h) * STRIDE
    shift = np.stack(np.meshgrid(sx, sy), axis=-1).reshape(-1, 2)  # [h*w,2]
    shift = np.concatenate([shift, shift], axis=1)  # x1 y1 x2 y2
    return (shift[:, None, :] + base_anchors[None, :, :]).reshape(-1, 4)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Standard R-CNN box transform inverse (bbox_transform_inv); anchors
    [A, 4], deltas [.., A, 4]."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = dx * aw + acx
    cy = dy * ah + acy
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], dim=-1)


def propose_boxes(anchors, fg, deltas, H: int, W: int, pre_nms: int,
                  num_rois: int):
    """Static-shape RPN proposal layer for T frames: fg [T, A], deltas
    [T, A, 4] -> (boxes [T, num_rois, 4], valid [T, num_rois]): decode,
    clip, min-size filter, top-``pre_nms`` pool, greedy NMS to exactly
    ``num_rois`` rows (py-faster-rcnn TEST config semantics,
    faster_rcnn_kernel.cpp:6-25), one ``nms`` launch for all frames."""
    boxes = decode_deltas(anchors, deltas)
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.stack([x1.clamp(0, W - 1), y1.clamp(0, H - 1),
                         x2.clamp(0, W - 1), y2.clamp(0, H - 1)], dim=-1)
    bw = boxes[..., 2] - boxes[..., 0] + 1
    bh = boxes[..., 3] - boxes[..., 1] + 1
    score = torch.where((bw >= MIN_SIZE) & (bh >= MIN_SIZE), fg, -1.0)
    k = min(pre_nms, score.shape[-1])
    top, idx = topk_stable(score, k)
    cand = boxes.gather(-2, idx[..., None].expand(*idx.shape, 4))
    kb, _, valid = nms(cand.contiguous(), top.contiguous(), RPN_NMS_THRESH,
                       num_rois, score_thresh=0.0)
    return kb, valid


class VGG16(nn.Module):
    """conv1_1..conv5_3 (pool after blocks 1-4; conv5 keeps stride 16)."""

    CFG = [(2, 64, "conv1"), (2, 128, "conv2"), (3, 256, "conv3"),
           (3, 512, "conv4"), (3, 512, "conv5")]

    def __init__(self):
        super().__init__()
        cin = 3
        for reps, feats, name in self.CFG:
            for i in range(reps):
                self.add_module(f"{name}_{i + 1}",
                                nn.Conv2d(cin, feats, 3, padding=1))
                cin = feats

    def forward(self, x):  # NCHW
        for bi, (reps, _, name) in enumerate(self.CFG):
            for i in range(reps):
                x = torch.relu(getattr(self, f"{name}_{i + 1}")(x))
            if bi < 4:
                x = F.max_pool2d(x, 2, 2)
        return x


class FasterRCNN(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.vgg = VGG16()
        self.rpn_conv = nn.Conv2d(FEAT, 512, 3, padding=1)
        # 2 softmax logits per anchor (bg, fg) and 4 deltas per anchor
        self.rpn_cls_score = nn.Conv2d(512, 2 * 9, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, 4 * 9, 1)
        self.fc6 = nn.Linear(POOL * POOL * FEAT, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.cls_score = nn.Linear(4096, num_classes)
        # in the state for checkpoint totality; the decode ignores it
        self.bbox_pred = nn.Linear(4096, 4 * num_classes)

    def forward(self, x, num_rois: int, pre_nms: int):
        """x: [N, H, W, 3] float32 (BGR, caffe mean-subtracted upstream by
        NNInput). Returns (cls_prob [N,R,81], rois [N,R,5], fc7
        [N,R,4096])."""
        n, H, W, _ = x.shape
        feat = self.vgg(x.permute(0, 3, 1, 2))  # [N, 512, H/16, W/16]
        fh, fw = feat.shape[2], feat.shape[3]
        rpn = torch.relu(self.rpn_conv(feat))
        cls_logit = self.rpn_cls_score(rpn).permute(0, 2, 3, 1)
        bbox_delta = self.rpn_bbox_pred(rpn).permute(0, 2, 3, 1)
        anchors = torch.from_numpy(anchors_for(fh, fw).astype(np.float32)) \
            .to(x.device)
        # a cell's 18 channels are [9 bg, 9 fg] (NHWC): fg score = softmax
        # over (logit[a], logit[9 + a])
        cls_logit = cls_logit.reshape(n, fh * fw, 2, 9)
        fg = torch.softmax(cls_logit, dim=2)[:, :, 1, :].reshape(n, -1)
        deltas = bbox_delta.reshape(n, fh * fw * 9, 4)
        boxes, valid = propose_boxes(anchors, fg, deltas, H, W, pre_nms,
                                     num_rois)  # [N,R,4], [N,R]
        r = boxes.shape[1]

        # RoIAlign over conv5_3: crop_and_resize takes pixel coords in the
        # given map, here the stride-16 one, so the input-pixel rois / 16
        feat_hwc = feat.permute(0, 2, 3, 1).contiguous()
        frame_idx = torch.arange(n, device=x.device).repeat_interleave(r)
        pooled = crop_and_resize(feat_hwc, (boxes / STRIDE).reshape(-1, 4),
                                 (POOL, POOL), frame_idx)  # [N*R,7,7,512]
        h6 = torch.relu(self.fc6(pooled.reshape(n, r, -1)))  # HWC flatten
        fc7 = torch.relu(self.fc7(h6))
        cls_prob = torch.softmax(self.cls_score(fc7), dim=-1)

        # padded/suppressed rows -> one-hot background (decode skips them)
        bg = torch.zeros_like(cls_prob)
        bg[..., 0] = 1.0
        v = valid[..., None]
        cls_prob = torch.where(v, cls_prob, bg)
        boxes = torch.where(v, boxes, 0.0)
        rois = torch.cat([boxes.new_zeros((n, r, 1)), boxes], dim=-1)
        return cls_prob, rois, torch.where(v, fc7, 0.0)


def apply(state, x: torch.Tensor, num_rois: int = NUM_ROIS,
          pre_nms: int = PRE_NMS):
    """The forward with ``state``'s weights."""
    return apply_net(FasterRCNN, state, x, num_rois, pre_nms)


# ------------------------------------------------------------ weights

def torch_mapping() -> Dict[str, Tuple[str, str]]:
    """{flax path: (torch key, kind)} over porting_maps.faster_rcnn_mapping's
    flax paths: the flax scopes are the module names; convs HWIO -> OIHW,
    every dense kernel (fc6 too: it reads the HWC flatten) transposed."""
    out = {}
    for path, (_, kind) in porting_maps.faster_rcnn_mapping().items():
        scopes = path.split("/")[1:]
        leaf = "weight" if scopes[-1] == "kernel" else "bias"
        if leaf == "bias":
            kind = "raw"
        elif kind != "conv":
            kind = "linear"
        out[path] = (".".join(scopes[:-1] + [leaf]), kind)
    return out


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's Faster R-CNN variables ({'params': ...}) -> a
    FasterRCNN state_dict."""
    return weights_lib.flax_to_torch(variables, torch_mapping())


def to_flax(state) -> Dict:
    return weights_lib.torch_to_flax(state, torch_mapping())


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of deterministic random weights from a
    ``torch.Generator`` seeded with ``seed`` (weights.init_state); not the
    JAX package's values."""
    shapes = {k: tuple(v.shape) for k, v in
              _skeleton(FasterRCNN).state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))
