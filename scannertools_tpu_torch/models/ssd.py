"""SSD-MobileNetV1 object detector.

Reference parity: ``DetectObjects`` (object_detection.py:13-75) runs the TF
frozen graph ``ssd_mobilenet_v1_coco_2017_11_17`` and emits exactly 100
boxes per frame as (x1=box[1], y1=box[0], x2=box[3], y2=box[2], score,
label) with normalized coords. The network (MobileNetV1 backbone + 6 SSD
heads, Liu et al. 2016 / Howard et al. 2017), the anchors and the box
decoding are the JAX package's (scannertools_tpu's models/ssd.py), per the
TF Object Detection API conventions (scale 0.2→0.95, ratios {1, 2, ½, 3,
⅓}, reduced 3-anchor lowest layer, box codes scaled by 10/10/5/5).

The net is an ``nn.Module`` in NCHW whose parameter names follow the flax
tree (``conv0.conv``, ``ds1.dw``, ``ds1.pw_bn``, ``extra0_a.conv``,
``loc0``, ``cls0``), in full float32 (``common.full_f32``), on NHWC input
as the JAX package takes it. As flax computes them:

  * padding is flax's ``"SAME"``: at stride 2 on an even side it is (0, 1),
    not torch's symmetric (1, 1), so every convolution pads explicitly
    (``common.same_pad``);
  * BatchNorm uses its running statistics with eps 1e-3 in flax's order
    (``common.batch_norm``), ReLU6 is ``min(relu(x), 6)``;
  * the heads' ``[b, -1, 4]`` and ``[b, -1, 91]`` reshapes run over NHWC, so
    the anchors of a cell stay together.

Postprocess: the top 512 anchors by their best class, then one greedy NMS
over boxes shifted by class (cross-class pairs never overlap) keeping 100
rows, for all frames of a chunk in one ``nms`` launch; its kept-index
output gathers the unshifted boxes and the labels (subtracting the shift
again would not give back the boxes' bits).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.numerics import div, resize_hw
from . import porting_maps
from . import weights as weights_lib
from .common import (_skeleton, apply_net, batch_norm, nms, same_pad,
                     topk_stable)

NUM_CLASSES = 90  # COCO labels 1..90
NUM_OUT = 100     # object_detection.py:47 reads fixed 100 boxes
INPUT_SIZE = 300
PREFILTER = 512
IOU_THRESH = 0.6
BN_EPS = 1e-3


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(torch.relu(x), 6.0)


class ConvBNReLU6(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.conv = nn.Conv2d(cin, cout, k, stride, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        x = self.conv(same_pad(x, self.k, self.stride))
        return _relu6(batch_norm(self.bn, x))


class DepthwiseSeparable(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.dw = nn.Conv2d(cin, cin, 3, stride, groups=cin, bias=False)
        self.dw_bn = nn.BatchNorm2d(cin, eps=BN_EPS)
        self.pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.pw_bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        x = _relu6(batch_norm(self.dw_bn,
                              self.dw(same_pad(x, 3, self.stride))))
        return _relu6(batch_norm(self.pw_bn, self.pw(x)))


_MOBILENET = [  # (features, stride)
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]
_EXTRAS = [(256, 512), (128, 256), (128, 256), (64, 128)]
_N_ANCHORS = [3, 6, 6, 6, 6, 6]


class SSDMobileNetV1(nn.Module):
    """[B, 300, 300, 3] in [-1, 1] NHWC -> (loc [B, 1917, 4], class logits
    [B, 1917, 91])."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.num_classes = num_classes
        self.conv0 = ConvBNReLU6(3, 32, 3, 2)
        cin = 32
        for i, (f, s) in enumerate(_MOBILENET):
            self.add_module(f"ds{i + 1}", DepthwiseSeparable(cin, f, s))
            cin = f
        feats = [512, 1024]
        for j, (mid, out) in enumerate(_EXTRAS):
            self.add_module(f"extra{j}_a", ConvBNReLU6(cin, mid, 1))
            self.add_module(f"extra{j}_b", ConvBNReLU6(mid, out, 3, 2))
            cin = out
            feats.append(out)
        for k, (c, na) in enumerate(zip(feats, _N_ANCHORS)):
            # 1x1 predictor convs (ssd_mobilenet_v1_coco.config's
            # convolutional_box_predictor { kernel_size: 1 })
            self.add_module(f"loc{k}", nn.Conv2d(c, na * 4, 1))
            self.add_module(f"cls{k}", nn.Conv2d(c, na * (num_classes + 1),
                                                 1))

    def forward(self, x):
        x = self.conv0(x.permute(0, 3, 1, 2))
        feats: List[torch.Tensor] = []
        for i in range(len(_MOBILENET)):
            x = getattr(self, f"ds{i + 1}")(x)
            if i == 10:          # conv11 -> 19x19x512
                feats.append(x)
        feats.append(x)          # conv13 -> 10x10x1024
        for j in range(len(_EXTRAS)):
            x = getattr(self, f"extra{j}_b")(getattr(self, f"extra{j}_a")(x))
            feats.append(x)
        b = x.shape[0]
        locs, clss = [], []
        for k, f in enumerate(feats):
            # the heads' channels are the anchors of a cell: reshape NHWC
            locs.append(getattr(self, f"loc{k}")(f).permute(0, 2, 3, 1)
                        .reshape(b, -1, 4))
            clss.append(getattr(self, f"cls{k}")(f).permute(0, 2, 3, 1)
                        .reshape(b, -1, self.num_classes + 1))
        return torch.cat(locs, dim=1), torch.cat(clss, dim=1)


@functools.lru_cache(maxsize=4)
def anchor_boxes(input_size: int = INPUT_SIZE) -> np.ndarray:
    """[N, 4] (cy, cx, h, w) normalized anchors, TF ssd_anchor_generator
    semantics: 6 layers, scales linear 0.2..0.95, ratios {1,2,.5,3,1/3} +
    interpolated sqrt(s_k s_{k+1}) for ratio 1; lowest layer reduced to
    3 anchors with scales (0.1, 0.2, 0.2) and ratios (1, 2, 0.5)."""
    grids = [19, 10, 5, 3, 2, 1]
    m = len(grids)
    scales = [0.2 + (0.95 - 0.2) * k / (m - 1) for k in range(m)] + [1.0]
    out = []
    for k, g in enumerate(grids):
        s = scales[k]
        if k == 0:
            specs = [(0.1, 1.0), (s, 2.0), (s, 0.5)]
        else:
            specs = [(s, 1.0), (s, 2.0), (s, 0.5), (s, 3.0), (s, 1.0 / 3.0),
                     (math.sqrt(s * scales[k + 1]), 1.0)]
        for y in range(g):
            for x in range(g):
                cy = (y + 0.5) / g
                cx = (x + 0.5) / g
                for scale, ratio in specs:
                    r = math.sqrt(ratio)
                    out.append((cy, cx, scale / r, scale * r))
    return np.array(out, np.float32)


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """TF box coder: (ty,tx,th,tw) scaled by (10,10,5,5) -> xyxy normalized;
    loc [.., N, 4], anchors [N, 4]."""
    ty, tx, th, tw = loc.unbind(-1)
    acy, acx, ah, aw = anchors.unbind(-1)
    cy = div(ty, 10.0) * ah + acy
    cx = div(tx, 10.0) * aw + acx
    h = torch.exp(div(th, 5.0)) * ah
    w = torch.exp(div(tw, 5.0)) * aw
    return torch.stack([cx - div(w, 2.0), cy - div(h, 2.0),
                        cx + div(w, 2.0), cy + div(h, 2.0)], dim=-1)


def _prefilter(loc: torch.Tensor, cls_logits: torch.Tensor):
    """loc [T, N, 4], logits [T, N, 91] -> the top PREFILTER anchors by
    their best class: (boxes [T, 512, 4], scores [T, 512], labels [T, 512]
    int32 in 1..90), ties in anchor order as ``lax.top_k`` keeps them."""
    anchors = torch.from_numpy(anchor_boxes()).to(loc.device)
    boxes = decode_boxes(loc, anchors)
    probs = torch.sigmoid(cls_logits[..., 1:])
    best, label = probs.max(dim=-1)
    top, idx = topk_stable(best, PREFILTER)
    b = boxes.gather(-2, idx[..., None].expand(*idx.shape, 4))
    return b, top, (label.gather(-1, idx) + 1).to(torch.int32)


def _postprocess_explicit(b: torch.Tensor, s: torch.Tensor, l: torch.Tensor,
                          iou_thresh: float = IOU_THRESH):
    """[T, K] prefiltered rows -> (boxes [T, 100, 4] xyxy normalized, scores
    [T, 100], classes [T, 100] int32): greedy NMS on class-shifted boxes,
    rows with score > 0 valid; the unshifted boxes and labels of the kept
    rows gathered by their source index, zeros in rows not kept."""
    shifted = b + l[..., None].to(torch.float32) * 4.0
    _, ks, _, ki = nms(shifted.contiguous(), s.contiguous(), iou_thresh,
                       NUM_OUT, score_thresh=0.0, index=True)
    kept = ki >= 0
    src = ki.clamp(min=0)
    boxes = b.gather(-2, src[..., None].expand(*src.shape, 4))
    boxes = torch.where(kept[..., None], boxes, 0.0)
    return boxes, ks, torch.where(kept, l.gather(-1, src), 0)


def detect(state, frames_f32: torch.Tensor):
    """frames: [T, H, W, 3] raw [0,255] -> (boxes [T,100,4] xyxy normalized,
    scores [T,100], classes [T,100] int32)."""
    x = resize_hw(frames_f32, 1, INPUT_SIZE, INPUT_SIZE, "linear")
    x = x * (2.0 / 255.0) - 1.0
    loc, cls_logits = apply_net(SSDMobileNetV1, state, x)
    return _postprocess_explicit(*_prefilter(loc, cls_logits))


# ------------------------------------------------------------ weights

_LEAF = {"kernel": ("weight", "conv"), "scale": ("weight", "raw"),
         "bias": ("bias", "raw"), "mean": ("running_mean", "raw"),
         "var": ("running_var", "raw")}


def torch_mapping() -> Dict[str, Tuple[str, str]]:
    """{flax path: (torch key, kind)} over porting_maps.ssd_mapping's flax
    paths: the flax scopes are the module names. A depthwise kernel
    [3, 3, 1, C] takes kind "conv" to torch's [C, 1, 3, 3]."""
    out = {}
    for path in porting_maps.ssd_mapping():
        scopes = path.split("/")[1:]
        leaf, kind = _LEAF[scopes[-1]]
        out[path] = (".".join(scopes[:-1] + [leaf]), kind)
    return out


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's SSD variables ({'params', 'batch_stats'}) -> an
    SSDMobileNetV1 state_dict (BatchNorm's ``num_batches_tracked`` 0)."""
    extra = {k: torch.zeros((), dtype=torch.int64)
             for k in _skeleton(SSDMobileNetV1).state_dict()
             if k.endswith(".num_batches_tracked")}
    return weights_lib.flax_to_torch(variables, torch_mapping(), extra)


def to_flax(state) -> Dict:
    return weights_lib.torch_to_flax(state, torch_mapping())


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of deterministic random weights from a
    ``torch.Generator`` seeded with ``seed`` (weights.init_state); not the
    JAX package's values."""
    shapes = {k: tuple(v.shape) for k, v in
              _skeleton(SSDMobileNetV1).state_dict().items()}
    return weights_lib.init_state(shapes, torch.Generator().manual_seed(seed))
