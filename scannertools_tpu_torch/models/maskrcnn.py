"""Mask R-CNN: a ResNet/ResNeXt backbone with FPN, the RPN, RoIAlign, and
the box and mask heads.

Reference parity: ``MaskRCNNDetectObjects`` (maskrcnn_detection.py:27-462)
wraps a maskrcnn-benchmark checkpoint (X-101-32x8d-FPN by default): the
min-side-800 letterbox (``preprocess``), the forward, a confidence filter
and masks pasted at a quarter of the frame's size. The architecture,
constants and static shapes are the JAX package's (scannertools_tpu's
models/maskrcnn.py), as ``nn.Module``s on NCHW inside and NHWC at the
edges, in full float32 (``common.full_f32``), whose parameter names are the
flax tree's scopes (``backbone.layer1b0.conv1``, ``rpn.cls_logits``,
``box.fc6``, ``mask.conv5_mask``). As flax computes them:

  * the bottleneck puts its stride in the 1x1 (for every arch, as the JAX
    model does), with groups for ResNeXt; frozen BatchNorm with eps 0 in
    flax's order (``common.batch_norm``); the stem is a 7x7 stride-2
    convolution padded (3, 3), then a 3x3 stride-2 max pool padded 1;
  * the FPN's top-down path upsamples with ``resize_hw(..., "nearest")``,
    JAX's half-pixel rule; P6 is a 1x1 stride-2 max pool of P5;
  * the RPN's logits and deltas are read NHWC, (y, x, anchor), the order of
    the anchors;
  * fc6 reads the crop's HWC flatten, the layout the crop kernel writes, so
    it takes the flax kernel transposed (as faster_rcnn.py); ``conv5_mask``
    is a ``ConvTranspose2d`` whose kernel is flax's mirrored
    (``weights.from_torch_conv_transpose``).

``infer`` batches the JAX package's per-image ``vmap`` over the chunk:

  * proposals: a sigmoid, the top ``pre_nms`` anchors, decode and clip, a
    level at a time; then the five levels of all T frames in one ``nms``
    launch, each level padded to the largest level's rows with score-0 rows
    (invalid at score_thresh 0, so they suppress nothing), each level's
    ``keep_l`` rows sliced and concatenated in level order, and the best
    ``post_nms`` across levels;
  * RoIAlign 7x7: one ``crop_and_resize_levels`` launch for every RoI of
    the chunk, each on the level the canonical heuristic gives it (the JAX
    package crops every level and keeps one by a one-hot sum);
  * the box head, the softmax, the best non-background class and its
    refined box;
  * ``select_detections``: one ``nms(..., index=True)`` launch on the boxes
    shifted by class; the kept index gathers the unshifted boxes, scores and
    labels. The JAX package walks the same greedy keep set in a K-step
    ``lax.scan``;
  * masks: one ``crop_and_resize_levels`` launch at 14x14 on the finals
    (the zero rows too), the mask head, the label's channel, a sigmoid.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.numerics import div, resize_hw
from . import jax_random, porting_maps
from . import weights as weights_lib
from .common import (FPN_STRIDES, _skeleton, batch_norm,
                     crop_and_resize_levels, full_f32, nms, topk_stable)

NUM_CLASSES = 81   # COCO + background
MIN_SIZE = 800     # aspect-preserving min side (maskrcnn_detection.py:27-30)
MAX_SIZE = 1333    # maskrcnn-benchmark's cap on the max side
PAD_MULT = 32      # the canvas is padded to the backbone's stride
# maskrcnn-benchmark's TEST regime: FPN_PRE_NMS_TOP_N_TEST a level,
# POST_NMS_TOP_N_TEST proposals, DETECTIONS_PER_IMG finals, SCORE_THRESH
PRE_NMS = 1000
POST_NMS = 1000
MAX_DET = 100
SCORE_THRESH = 0.05
RPN_NMS_THRESH = 0.7
DET_NMS_THRESH = 0.5
MASK_RES = 28
# the canonical FPN level (FPN eq. 1; maskrcnn-benchmark LevelMapper):
# floor(4 + log2(sqrt(wh) / 224 + 1e-6)), clamped to P2..P5
_CANONICAL_SCALE = 224.0
_CANONICAL_LEVEL = 4.0
_LVL_EPS = 1e-6
PIXEL_MEAN = (102.9801, 115.9465, 122.7717)  # BGR255
STRIDES = FPN_STRIDES + (64,)  # P2..P6
FEAT = 256  # FPN channels

ARCHS = {
    # name -> (blocks, groups, width_per_group)
    "R-50-FPN": ((3, 4, 6, 3), 1, 64),
    "R-101-FPN": ((3, 4, 23, 3), 1, 64),
    "X-101-32x8d-FPN": ((3, 4, 23, 3), 32, 8),
}


def _frozen_bn(c: int) -> nn.BatchNorm2d:
    """maskrcnn-benchmark's FrozenBatchNorm2d: the running statistics, no
    epsilon."""
    return nn.BatchNorm2d(c, eps=0.0)


class Bottleneck(nn.Module):
    """1x1 (with the stride) -> 3x3 (grouped) -> 1x1, frozen BatchNorm."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1, stride, bias=False)
        self.bn1 = _frozen_bn(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, groups=groups,
                               bias=False)
        self.bn2 = _frozen_bn(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = _frozen_bn(out)
        self.project = cin != out or stride != 1
        if self.project:
            self.downsample_conv = nn.Conv2d(cin, out, 1, stride, bias=False)
            self.downsample_bn = _frozen_bn(out)

    def forward(self, x):
        y = torch.relu(batch_norm(self.bn1, self.conv1(x)))
        y = torch.relu(batch_norm(self.bn2, self.conv2(y)))
        y = batch_norm(self.bn3, self.conv3(y))
        r = batch_norm(self.downsample_bn, self.downsample_conv(x)) \
            if self.project else x
        return torch.relu(y + r)


class BackboneFPN(nn.Module):
    """ResNet/ResNeXt C2..C5 (``body``) and FPN P2..P6 (``fpn``), NCHW."""

    def __init__(self, blocks: Tuple[int, ...], groups: int,
                 width_per_group: int):
        super().__init__()
        self.blocks = tuple(blocks)
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.stem_bn = _frozen_bn(64)
        cin = 64
        for si, nb in enumerate(self.blocks):
            mid = groups * width_per_group * 2 ** si
            out = 256 * 2 ** si
            for bi in range(nb):
                self.add_module(f"layer{si + 1}b{bi}", Bottleneck(
                    cin, mid, out, 2 if bi == 0 and si > 0 else 1, groups))
                cin = out
        for i in range(4):
            self.add_module(f"fpn_inner{i + 1}",
                            nn.Conv2d(256 * 2 ** i, FEAT, 1))
            self.add_module(f"fpn_layer{i + 1}",
                            nn.Conv2d(FEAT, FEAT, 3, padding=1))

    def body(self, x):
        x = torch.relu(batch_norm(self.stem_bn, self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        cs = []
        for si, nb in enumerate(self.blocks):
            for bi in range(nb):
                x = getattr(self, f"layer{si + 1}b{bi}")(x)
            cs.append(x)
        return cs

    def fpn(self, cs):
        lat = [getattr(self, f"fpn_inner{i + 1}")(c) for i, c in enumerate(cs)]
        ps = lat[3:]
        for i in (2, 1, 0):
            up = resize_hw(ps[0], 2, lat[i].shape[2], lat[i].shape[3],
                           "nearest")
            ps.insert(0, lat[i] + up)
        ps = [getattr(self, f"fpn_layer{i + 1}")(p) for i, p in enumerate(ps)]
        return ps + [F.max_pool2d(ps[3], 1, 2)]  # LastLevelMaxPool

    def forward(self, x):
        return self.fpn(self.body(x))


class RPNHead(nn.Module):
    def __init__(self, n_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(FEAT, FEAT, 3, padding=1)
        self.cls_logits = nn.Conv2d(FEAT, n_anchors, 1)
        self.bbox_pred = nn.Conv2d(FEAT, 4 * n_anchors, 1)

    def forward(self, feat):
        """NCHW map -> (logits [T, H*W*A], deltas [T, H*W*A, 4]), in (y, x,
        anchor) order."""
        t = torch.relu(self.conv(feat))
        n = feat.shape[0]
        return (self.cls_logits(t).permute(0, 2, 3, 1).reshape(n, -1),
                self.bbox_pred(t).permute(0, 2, 3, 1).reshape(n, -1, 4))


class BoxHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc6 = nn.Linear(7 * 7 * FEAT, 1024)
        self.fc7 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, NUM_CLASSES)
        self.bbox_pred = nn.Linear(1024, NUM_CLASSES * 4)

    def forward(self, roi_feats):
        """[R, 7, 7, 256] crops -> (class logits [R, 81], deltas [R, 324])."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)  # the HWC flatten
        x = torch.relu(self.fc7(torch.relu(self.fc6(x))))
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}",
                            nn.Conv2d(FEAT, FEAT, 3, padding=1))
        self.conv5_mask = nn.ConvTranspose2d(FEAT, FEAT, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(FEAT, NUM_CLASSES, 1)

    def forward(self, roi_feats):
        """[R, 14, 14, 256] crops -> mask logits [R, 81, 28, 28]."""
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.mask_fcn_logits(torch.relu(self.conv5_mask(x)))


# ------------------------------------------------------------ geometry


def anchors_for(level_hw: Tuple[int, int], stride: int) -> np.ndarray:
    """[H*W*3, 4] xyxy anchors of a level, in (y, x, ratio) order: one
    scale (8 * stride), ratios 0.5, 1, 2; in float64, then float32, as the
    JAX package's ``_anchors_for`` computes them a cell at a time."""
    h, w = level_hw
    size = 8.0 * stride
    r = np.array([0.5, 1.0, 2.0])
    aw, ah = size * np.sqrt(r), size / np.sqrt(r)
    cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride,
                         (np.arange(w) + 0.5) * stride, indexing="ij")
    cx, cy = cx[..., None], cy[..., None]
    out = np.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2],
                   axis=-1)
    return out.reshape(-1, 4).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _anchors_on(h: int, w: int, stride: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(anchors_for((h, w), stride)).to(device)


def fpn_level_for(boxes: torch.Tensor) -> torch.Tensor:
    """[B, 4] canvas boxes -> [B] int64 in 0..3 (P2..P5): the canonical
    heuristic, the division by 224 a product with its reciprocal as under
    ``jax.jit``."""
    w = torch.clamp_min(boxes[:, 2] - boxes[:, 0], 0.0)
    h = torch.clamp_min(boxes[:, 3] - boxes[:, 1], 0.0)
    s = torch.sqrt(w * h)
    lvl = torch.floor(_CANONICAL_LEVEL
                      + torch.log2(div(s, _CANONICAL_SCALE) + _LVL_EPS))
    return torch.clamp(lvl, 2.0, 5.0).to(torch.int64) - 2


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """[.., 4] boxes and (dx, dy, dw, dh) deltas -> [.., 4] boxes; dw, dh
    clipped to [-4, 4]."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w * 0.5
    cy = boxes[..., 1] + h * 0.5
    ncx = cx + deltas[..., 0] * w
    ncy = cy + deltas[..., 1] * h
    nw = w * torch.exp(torch.clamp(deltas[..., 2], -4, 4))
    nh = h * torch.exp(torch.clamp(deltas[..., 3], -4, 4))
    return torch.stack([ncx - nw * 0.5, ncy - nh * 0.5,
                        ncx + nw * 0.5, ncy + nh * 0.5], dim=-1)


def _clip(boxes: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.clamp_min(boxes, 0.0), hi)


def letterbox_geometry(h: int, w: int, min_size: int = MIN_SIZE,
                       max_size: int = MAX_SIZE):
    """The reference transform's sizing (maskrcnn-benchmark
    Resize.get_size): the min side to ``min_size`` unless the max side
    would pass ``max_size``. -> (scale, (target_h, target_w), (canvas_h,
    canvas_w)), the canvas rounded up to PAD_MULT."""
    s = min_size / min(h, w)
    if s * max(h, w) > max_size:
        s = max_size / max(h, w)
    th, tw = int(round(h * s)), int(round(w * s))
    ch = -(-th // PAD_MULT) * PAD_MULT
    cw = -(-tw // PAD_MULT) * PAD_MULT
    return s, (th, tw), (ch, cw)


def preprocess(frames: torch.Tensor, min_size: int = MIN_SIZE,
               max_size: int = MAX_SIZE):
    """[T, H, W, 3] RGB in [0, 255] -> (canvas [T, CH, CW, 3] BGR255 less
    PIXEL_MEAN, the content at the top left and zeros around it, scale):
    the resize is ``jax.image.resize(..., "linear")``'s."""
    _, h, w, _ = frames.shape
    s, (th, tw), (ch, cw) = letterbox_geometry(int(h), int(w), min_size,
                                               max_size)
    x = resize_hw(frames, 1, th, tw, "linear").flip(-1)
    x = x - torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=x.device)
    return F.pad(x, (0, 0, 0, cw - tw, 0, ch - th)), s


# ------------------------------------------------------------ inference


def propose(scores, deltas, anchors, H: int, W: int, pre_nms: int,
            post_nms: int) -> torch.Tensor:
    """The RPN's proposals for T frames. scores: per level [T, A_l] (the
    logits' sigmoid), deltas [T, A_l, 4], anchors [A_l, 4] -> [T, P, 4]
    canvas boxes, P = min(post_nms, sum of keep_l): per level the top
    k_l = min(pre_nms, A_l), decoded and clipped, greedy NMS 0.7 keeping
    keep_l = min(post_nms, k_l) rows (every level of every frame in one
    ``nms`` call), then the best P across the levels, ties in level order."""
    t = scores[0].shape[0]
    hi = torch.tensor([W, H, W, H], dtype=torch.float32,
                      device=scores[0].device)
    ks = [min(pre_nms, s.shape[1]) for s in scores]
    keeps = [min(post_nms, k) for k in ks]
    kmax = max(ks)
    cand_b, cand_s = [], []
    for s, d, a, k in zip(scores, deltas, anchors, ks):
        top, idx = topk_stable(s, k)
        bx = apply_deltas(a[idx], d.gather(1, idx[..., None].expand(t, k, 4)))
        cand_b.append(F.pad(_clip(bx, hi), (0, 0, 0, kmax - k)))
        cand_s.append(F.pad(top, (0, kmax - k)))
    n, m = len(scores), max(keeps)
    pb, ps, _ = nms(torch.cat(cand_b).contiguous(),
                    torch.cat(cand_s).contiguous(), RPN_NMS_THRESH, m)
    pb, ps = pb.view(n, t, m, 4), ps.view(n, t, m)
    boxes = torch.cat([pb[i, :, :k] for i, k in enumerate(keeps)], dim=1)
    sc = torch.cat([ps[i, :, :k] for i, k in enumerate(keeps)], dim=1)
    _, idx = topk_stable(sc, min(post_nms, sc.shape[1]))
    return boxes.gather(1, idx[..., None].expand(*idx.shape, 4))


def roi_align(maps, boxes: torch.Tensor, out_hw) -> torch.Tensor:
    """[T, K, 4] canvas boxes over the NHWC levels P2..P5 -> [T * K, oh,
    ow, C], each box on its canonical level, in one launch."""
    t, k, _ = boxes.shape
    flat = boxes.reshape(t * k, 4).contiguous()
    fi = torch.arange(t, device=boxes.device).repeat_interleave(k)
    return crop_and_resize_levels(maps, flat, fpn_level_for(flat), fi,
                                  out_hw)


def select_detections(refined: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, diag: float, max_det: int,
                      iou_thresh: float = DET_NMS_THRESH,
                      score_thresh: float = SCORE_THRESH):
    """The finals of T frames: greedy NMS per class (boxes shifted by label
    * diag never overlap across classes) over the rows scoring above
    ``score_thresh``, the first ``max_det`` kept in score order. refined
    [T, K, 4], scores [T, K], labels [T, K] int32 -> (boxes [T, max_det,
    4], scores, labels), zeros in the rows not kept."""
    shifted = refined + labels[..., None].to(torch.float32) * diag
    _, ks, _, ki = nms(shifted.contiguous(), scores.contiguous(), iou_thresh,
                       max_det, score_thresh=score_thresh, index=True)
    kept = ki >= 0
    src = ki.clamp(min=0)
    boxes = refined.gather(1, src[..., None].expand(*src.shape, 4))
    return (torch.where(kept[..., None], boxes, 0.0), ks,
            torch.where(kept, labels.gather(1, src), 0))


class MaskRCNN(nn.Module):
    def __init__(self, arch: str = "R-50-FPN"):
        super().__init__()
        blocks, groups, width_per_group = ARCHS[arch]
        self.backbone = BackboneFPN(blocks, groups, width_per_group)
        self.rpn = RPNHead()
        self.box = BoxHead()
        self.mask = MaskHead()

    def forward(self, images, pre_nms: int, post_nms: int, max_det: int):
        """images: [T, H, W, 3] canvases (``preprocess``) -> (boxes [T,
        max_det, 4] canvas px, scores [T, max_det], labels int32, masks [T,
        max_det, 28, 28])."""
        t, H, W, _ = images.shape
        fpn = self.backbone(images.permute(0, 3, 1, 2))
        rpn = [self.rpn(f) for f in fpn]
        props = propose(
            [torch.sigmoid(logits) for logits, _ in rpn],
            [deltas for _, deltas in rpn],
            [_anchors_on(f.shape[2], f.shape[3], s, images.device)
             for f, s in zip(fpn, STRIDES)], H, W, pre_nms, post_nms)
        maps = [f.permute(0, 2, 3, 1).contiguous() for f in fpn[:4]]
        p = props.shape[1]
        cls, bdeltas = self.box(roi_align(maps, props, (7, 7)))
        best, label = torch.softmax(cls, dim=-1)[:, 1:].max(dim=1)
        label = label + 1
        sel = bdeltas.view(-1, NUM_CLASSES, 4).gather(
            1, label[:, None, None].expand(-1, 1, 4))[:, 0]
        hi = torch.tensor([W, H, W, H], dtype=torch.float32,
                          device=images.device)
        refined = _clip(apply_deltas(props.reshape(-1, 4), sel), hi)
        fb, fs, fl = select_detections(
            refined.view(t, p, 4), best.view(t, p),
            label.to(torch.int32).view(t, p), 2.0 * max(W, H), max_det)
        logits = self.mask(roi_align(maps, fb, (14, 14)))
        m = logits.gather(1, fl.reshape(-1, 1, 1, 1).long().expand(
            -1, 1, MASK_RES, MASK_RES))
        return fb, fs, fl, torch.sigmoid(m).view(t, max_det, MASK_RES,
                                                  MASK_RES)


def infer(state, images: torch.Tensor, arch: str = "R-50-FPN",
          pre_nms: int = PRE_NMS, post_nms: int = POST_NMS,
          max_det: int = MAX_DET):
    """The forward of ``arch`` with ``state``'s weights (a state_dict on the
    images' device), in full float32."""
    with full_f32():
        return torch.func.functional_call(
            _skeleton(MaskRCNN, arch), dict(state),
            (images, pre_nms, post_nms, max_det))


# ------------------------------------------------------------ weights

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def torch_mapping(arch: str = "R-50-FPN") -> Dict[str, Tuple[str, str]]:
    """{flax path: (torch key, kind)} over porting_maps.maskrcnn_mapping's
    flax paths: the trunk's scopes are the backbone's and the RPN's module
    names, the heads' under ``box`` and ``mask``; every dense kernel is
    transposed (fc6 too: it reads the HWC flatten)."""
    out = {}
    for path, (_, kind) in porting_maps.maskrcnn_mapping(arch).items():
        parts = path.split("/")
        scopes = parts[2:-1] if parts[0] == "trunk" else [parts[0]] + \
            parts[2:-1]
        if parts[-1] != "kernel":
            kind = "raw"
        elif kind.startswith("linear"):
            kind = "linear"
        out[path] = (".".join(scopes + [_LEAF[parts[-1]]]), kind)
    return out


def from_flax(variables, arch: str = "R-50-FPN") -> Dict[str, torch.Tensor]:
    """The JAX package's MaskRCNNModel variables ({'trunk', 'box',
    'mask'}) -> a MaskRCNN state_dict (BatchNorm's ``num_batches_tracked``
    0)."""
    extra = {k: torch.zeros((), dtype=torch.int64)
             for k in _skeleton(MaskRCNN, arch).state_dict()
             if k.endswith(".num_batches_tracked")}
    return weights_lib.flax_to_torch(variables, torch_mapping(arch), extra)


def to_flax(state, arch: str = "R-50-FPN") -> Dict:
    return weights_lib.torch_to_flax(state, torch_mapping(arch))


def init_shapes(arch: str = "X-101-32x8d-FPN") -> Dict:
    """The JAX package's ``MaskRCNNModel`` variables tree ({'trunk', 'box',
    'mask'}) as shapes with no data: each leaf a tensor on the meta device
    in the flax layout (what the JAX package's ``init_shapes`` gives as
    shape structs)."""
    shapes = weights_lib.flax_shapes(torch_mapping(arch),
                                     _skeleton(MaskRCNN, arch).state_dict())
    return weights_lib._unflatten({p: torch.empty(s, device="meta")
                                   for p, s in shapes.items()})


def default_tree(key: torch.Tensor, arch: str = "R-50-FPN") -> Dict:
    """The JAX package's ``MaskRCNNModel(key, arch).variables``, drawn in
    torch on the key's device: the trunk ``init`` on ``key``, the box and
    mask heads on the two keys of ``split(key)``."""
    shapes = weights_lib.flax_shapes(torch_mapping(arch),
                                     _skeleton(MaskRCNN, arch).state_dict())
    k_box, k_mask = jax_random.split(key)
    out = {}
    for part, root in (("trunk", key), ("box", k_box), ("mask", k_mask)):
        out[part] = weights_lib.draw_flax(root, {
            p.split("/", 1)[1]: s for p, s in shapes.items()
            if p.split("/", 1)[0] == part})
    return out


class MaskRCNNModel:
    """The JAX package's parameter container: ``variables`` is its tree
    ({'trunk', 'box', 'mask'}, flax layout: what ``save_params`` writes
    and ``weights_path`` reads), drawn as the JAX package draws it from
    ``rng`` (a ``jax_random`` key, or an int seed for
    ``jax_random.prng_key``) on ``device`` (None: the card, as a
    ``Client``'s; a key is drawn on its own device); ``infer`` runs the
    port's forward on a variables tree."""

    def __init__(self, rng=0, arch: str = "R-50-FPN",
                 pre_nms: int = PRE_NMS, post_nms: int = POST_NMS,
                 max_det: int = MAX_DET, device=None):
        from ..client import _resolve_device

        key = rng if isinstance(rng, torch.Tensor) else \
            jax_random.prng_key(rng, _resolve_device(device))
        self.arch = arch
        self.pre_nms, self.post_nms = int(pre_nms), int(post_nms)
        self.max_det = int(max_det)
        self.variables = default_tree(key, arch)

    def infer(self, variables, images: torch.Tensor):
        """images: [B, H, W, 3] canvases (``preprocess``) -> (boxes [B,
        max_det, 4] canvas px, scores, labels, masks [B, max_det, 28,
        28])."""
        return infer(from_flax(variables, self.arch), images, self.arch,
                     self.pre_nms, self.post_nms, self.max_det)


def init_params(seed: int = 0,
                arch: str = "R-50-FPN") -> Dict[str, torch.Tensor]:
    """A state_dict of deterministic random weights from a ``torch.Generator``
    seeded with ``seed`` (weights.init_state): the port's own seeded set
    (phases 4-11 of chip_smoke.py are tuned to it); a model's default weights,
    what an op draws without a ``weights_path``, are the JAX package's draw
    (``default_tree``)."""
    shapes = {k: tuple(v.shape) for k, v in
              _skeleton(MaskRCNN, arch).state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))
