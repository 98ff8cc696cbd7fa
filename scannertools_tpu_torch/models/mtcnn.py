"""MTCNN face detector (P-Net / R-Net / O-Net cascade).

Reference parity: ``MTCNNDetectFaces`` (face_detection.py:8-68) drives the
facenet repo's TF1 ``align.detect_face.bulk_detect_face`` with
thresholds [0.45, 0.6, 0.7], pyramid factor 0.709, window ratio 0.2, then
applies margins (v=0.2582651..., h=0.3449094...) and normalizes boxes by
frame size. The network architecture and cascade are from Zhang et al.,
"Joint Face Detection and Alignment using Multi-task Cascaded Convolutional
Networks" (2016).

The cascade is the JAX package's (scannertools_tpu's models/mtcnn.py), on
fixed-size padded box arrays with validity masks: per pyramid scale the
P-Net probability grid yields its top-K cells; scales concatenate into one
padded array; R/O-Net stages crop a fixed number of patches and mask out
invalid rows. Where the JAX package vmaps ``detect_single`` over frames,
``detect_batch`` carries a frame axis through every stage, so each NMS
call is one launch of the ``nms`` kernel for all T frames (4 a chunk: the
pyramid scales' calls batched into one, then the cross-scale, R-Net and
O-Net calls) and each crop stage one launch of ``crop_and_resize``.

The nets are ``nn.Module``s with facenet-pytorch's parameter names
(models/porting_maps.py), computing in NCHW on NHWC inputs, in full
float32 (``common.full_f32``). Where torch differs from flax:

  * flax ``max_pool(..., padding="SAME")`` pads with -inf by lax's rule,
    (0, 1) at even sizes for 2x2/s2 and 3x3/s2 and (1, 1) for 3x3/s2 at odd
    sizes; ``F.max_pool2d``'s padding is symmetric, so
    ``common.max_pool_same`` pads explicitly and pools VALID;
  * flax flattens NHWC before ``Dense``; these nets flatten NCHW, and the
    converter permutes the first dense kernel (kind ``linear_conv``,
    models/weights.py);
  * a division by a constant is a product with its float32 reciprocal
    (``utils.numerics.div``), as under ``jax.jit``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.numerics import div, resize_hw
from . import jax_random, porting_maps
from . import weights as weights_lib
from .common import (_skeleton, apply_net, crop_and_resize, max_pool_same, nms,
                     topk_boxes, topk_stable)

# cascade capacities (padded sizes)
MAX_CELLS_PER_SCALE = 128
MAX_STAGE1 = 256
MAX_STAGE2 = 96
MAX_FACES = 32

THRESHOLDS = (0.45, 0.6, 0.7)  # face_detection.py:29
FACTOR = 0.709
WINDOW_RATIO = 0.2
VMARGIN = 0.2582651235637604
HMARGIN = 0.3449094129917718


class _PReLU(nn.Module):
    """where(x > 0, x, alpha * x), alpha per channel (dim 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        alpha = self.weight.view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x > 0, x, alpha * x)


def _softmax1(x: torch.Tensor) -> torch.Tensor:
    """The second class of jax.nn.softmax over dim 1: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return (e / e.sum(dim=1, keepdim=True))[:, 1]


class PNet(nn.Module):
    """Fully-convolutional proposal net: stride 2, cell size 12. NHWC in;
    prob [B, GH, GW] and reg [B, GH, GW, 4] out."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = _PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = _PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = _PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = max_pool_same(self.prelu1(self.conv1(x)), 2, 2)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return (_softmax1(self.conv4_1(x)),
                self.conv4_2(x).permute(0, 2, 3, 1))


class RNet(nn.Module):
    """[K, 24, 24, 3] -> prob [K], reg [K, 4]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = _PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = _PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = _PReLU(64)
        self.dense4 = nn.Linear(64 * 3 * 3, 128)
        self.prelu4 = _PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = max_pool_same(self.prelu1(self.conv1(x)), 3, 2)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(x.reshape(x.shape[0], -1)))  # CHW
        return _softmax1(self.dense5_1(x)), self.dense5_2(x)


class ONet(nn.Module):
    """[K, 48, 48, 3] -> prob [K], reg [K, 4], landmarks [K, 10]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = _PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = _PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = _PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = _PReLU(128)
        self.dense5 = nn.Linear(128 * 3 * 3, 256)
        self.prelu5 = _PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = max_pool_same(self.prelu1(self.conv1(x)), 3, 2)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2)
        x = max_pool_same(self.prelu3(self.conv3(x)), 2, 2)
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(x.reshape(x.shape[0], -1)))  # CHW
        return (_softmax1(self.dense6_1(x)), self.dense6_2(x),
                self.dense6_3(x))


NETS = {"pnet": PNet, "rnet": RNet, "onet": ONet}


# ------------------------------------------------------------ weights

def torch_mapping(net: str) -> Dict[str, Tuple[str, str]]:
    """{flax path of the JAX package's init_params tree: (torch key of
    ``net``, kind)}, from porting_maps.mtcnn_mapping."""
    return {path: tk for path, tk in porting_maps.mtcnn_mapping().items()
            if path.split("/")[0] == net}


def from_flax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's MTCNN tree ({'pnet': ..., 'rnet': ..., 'onet':
    ...}, as ``save_params`` writes it) -> {net: state_dict}."""
    return {net: weights_lib.flax_to_torch(tree, torch_mapping(net))
            for net in NETS}


def to_flax(state) -> Dict:
    """{net: state_dict} -> the JAX package's MTCNN tree."""
    out: Dict = {}
    for net in NETS:
        out.update(weights_lib.torch_to_flax(state[net], torch_mapping(net)))
    return out


def default_tree(key: torch.Tensor) -> Dict:
    """The JAX package's ``init_params(key)``, drawn in torch on the key's
    device: P-, R- and O-Net each ``init`` on one of ``split(key, 3)``,
    their params alone."""
    out = {}
    for net_key, (net, cls) in zip(jax_random.split(key, 3), NETS.items()):
        shapes = weights_lib.flax_shapes(torch_mapping(net),
                                         _skeleton(cls).state_dict())
        out[net] = weights_lib.draw_flax(
            net_key, {p.split("/", 1)[1]: s for p, s in shapes.items()},
            collections=False)
    return out


def init_params(seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: state_dict} of deterministic random weights from a
    ``torch.Generator`` seeded with ``seed`` (weights.init_state): the port's
    own seeded set (phases 4-11 of chip_smoke.py are tuned to it); a model's
    default weights, what an op draws without a ``weights_path``, are the JAX
    package's draw (``default_tree``)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for net, cls in NETS.items():
        shapes = {k: tuple(v.shape) for k, v in
                  cls().state_dict().items()}
        out[net] = weights_lib.init_state(shapes, gen)
    return out


# ------------------------------------------------------------ cascade

def pyramid_scales(h: int, w: int, window_ratio: float = WINDOW_RATIO,
                   factor: float = FACTOR) -> List[float]:
    minsize = max(12.0, window_ratio * min(h, w))
    m = 12.0 / minsize
    minl = min(h, w) * m
    scales = []
    while minl >= 12.0:
        scales.append(m * factor ** len(scales))
        minl *= factor
    return scales


def _normalize(img_f32: torch.Tensor) -> torch.Tensor:
    return (img_f32 - 127.5) * 0.0078125


def _square(boxes: torch.Tensor) -> torch.Tensor:
    """Expand to squares around the center (the cascade's 'rerec')."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    half = div(side, 2)
    return torch.stack([cx - half, cy - half, cx + half, cy + half], dim=-1)


def _calibrate(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Apply bbox regression offsets (fractions of box size)."""
    w = boxes[..., 2:3] - boxes[..., 0:1]
    h = boxes[..., 3:4] - boxes[..., 1:2]
    return boxes + reg * torch.cat([w, h, w, h], dim=-1)


def pyramid_layout(h: int, w: int) -> List[Tuple[float, int, int, int]]:
    """Static canvas layout for the fused pyramid: per level
    (scale, hs, ws, y_offset). Offsets stay EVEN so every level's P-Net
    cell grid (stride 2) aligns with the canvas grid, and levels are
    separated by >= one full 12-px receptive field of zeros so no window
    that we read spans two levels."""
    layout = []
    oy = 0
    for s in pyramid_scales(h, w):
        hs, ws = int(np.ceil(h * s)), int(np.ceil(w * s))
        layout.append((s, hs, ws, oy))
        oy += hs + (12 if hs % 2 == 0 else 13)
    return layout


def _stage1_fused(state, x: torch.Tensor, t1: float):
    """P-Net over ALL pyramid levels of [T, H, W, 3] in one forward: levels
    are pasted into a single tall canvas and the fully-convolutional net
    runs once. Per-level cells are then sliced back off the shared grid
    (only cells whose 12-px window lies fully inside their level, so values
    match the per-level forward; the per-level edge cells that SAME-pool
    padding would fabricate are dropped). -> (boxes [T, N, 4], scores
    [T, N]) or None."""
    t, H, W, _ = x.shape
    layout = pyramid_layout(H, W)
    if not layout:
        return None
    Hc = layout[-1][3] + layout[-1][1]
    Wc = max(ws for _, _, ws, _ in layout)
    canvas = x.new_zeros((t, Hc, Wc, 3))
    for s, hs, ws, oy in layout:
        # jax.image.resize(x, (hs, ws, 3), "linear", antialias=False)
        canvas[:, oy:oy + hs, :ws] = resize_hw(x, 1, hs, ws, "linear")
    prob, reg = apply_net(PNet, state["pnet"], canvas)

    cells = []
    for s, hs, ws, oy in layout:
        g0 = oy // 2
        gh = (hs - 12) // 2 + 1
        gw = (ws - 12) // 2 + 1
        if gh <= 0 or gw <= 0:
            continue
        flat_p = prob[:, g0:g0 + gh, :gw].reshape(t, -1)
        sub_r = reg[:, g0:g0 + gh, :gw].reshape(t, -1, 4)
        k = min(MAX_CELLS_PER_SCALE, flat_p.shape[1])
        top_p, idx = topk_stable(flat_p, k)
        gy = torch.div(idx, gw, rounding_mode="floor").to(torch.float32)
        gx = (idx % gw).to(torch.float32)
        # cell -> box in original coords (stride 2, cell 12)
        b = torch.stack([div(gx * 2 + 1, s), div(gy * 2 + 1, s),
                         div(gx * 2 + 12, s), div(gy * 2 + 12, s)],
                        dim=-1)
        b = _calibrate(b, sub_r.gather(1, idx[..., None].expand(t, k, 4)))
        score = torch.where(top_p > t1, top_p, 0.0)
        cells.append((b, score))
    if not cells:
        return None
    return _nms_per_scale(cells)


def _nms_per_scale(cells):
    """The per-scale NMS (0.5) of each scale's [T, k_s, 4] boxes and [T,
    k_s] scores (k_s <= MAX_CELLS_PER_SCALE, scores >= 0), in one ``nms``
    call: each scale padded to MAX_CELLS_PER_SCALE rows of score 0, which
    are invalid and come after every real row in the stable order, so the
    kept rows do not change; the scales stacked on the frame axis. ->
    (boxes [T, sum k_s, 4], scores [T, sum k_s]), each scale's k_s rows
    as its own call would give them, with invalid rows' scores 0."""
    n, t = len(cells), cells[0][1].shape[0]
    m = MAX_CELLS_PER_SCALE
    bs, ss, vs = nms(
        torch.cat([F.pad(b, (0, 0, 0, m - b.shape[1])) for b, _ in cells]),
        torch.cat([F.pad(s, (0, m - s.shape[1])) for _, s in cells]),
        0.5, m)
    bs, ss, vs = bs.view(n, t, m, 4), ss.view(n, t, m), vs.view(n, t, m)
    ks = [s.shape[1] for _, s in cells]
    return (torch.cat([bs[i, :, :k] for i, k in enumerate(ks)], dim=1),
            torch.cat([torch.where(vs[i, :, :k], ss[i, :, :k], 0.0)
                       for i, k in enumerate(ks)], dim=1))


def _crops(x: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """[T, K, 4] boxes of [T, H, W, 3] frames -> [T * K, size, size, 3], in
    one crop launch."""
    t, k, _ = boxes.shape
    fi = torch.arange(t, device=x.device).repeat_interleave(k)
    return crop_and_resize(x, boxes.reshape(t * k, 4).contiguous(),
                           (size, size), fi)


def detect_batch(state, frames_f32: torch.Tensor,
                 thresholds: Tuple[float, float, float] = THRESHOLDS):
    """frames: [T, H, W, 3] float32 in [0,255] -> (boxes [T, MAX_FACES, 4]
    pixel xyxy, scores [T, MAX_FACES], valid [T, MAX_FACES]). ``state``:
    {net: state_dict} on the frames' device."""
    t, H, W, _ = frames_f32.shape
    x = _normalize(frames_f32)
    t1, t2, t3 = thresholds

    # ---- stage 1: P-Net, all pyramid levels in one fused forward -------
    stage1 = _stage1_fused(state, x, t1)
    if stage1 is None:
        z = x.new_zeros((t, MAX_FACES))
        return (x.new_zeros((t, MAX_FACES, 4)), z,
                torch.zeros((t, MAX_FACES), dtype=torch.bool,
                            device=x.device))
    boxes, scores = topk_boxes(*stage1, MAX_STAGE1)
    scores = torch.where(torch.isfinite(scores), scores, 0.0)
    boxes, scores, valid = nms(boxes, scores, 0.7, MAX_STAGE1)  # cross-scale
    boxes = _square(boxes)

    # ---- stage 2: R-Net -------------------------------------------------
    boxes2, scores2 = topk_boxes(boxes, torch.where(valid, scores, 0.0),
                                 MAX_STAGE2)
    scores2 = torch.where(torch.isfinite(scores2), scores2, 0.0)
    p2, r2 = apply_net(RNet, state["rnet"], _crops(x, boxes2, 24))
    p2, r2 = p2.reshape(t, MAX_STAGE2), r2.reshape(t, MAX_STAGE2, 4)
    s2 = torch.where((p2 > t2) & (scores2 > 0), p2, 0.0)
    boxes2 = _calibrate(boxes2, r2)
    boxes2, s2, valid2 = nms(boxes2, s2, 0.7, MAX_STAGE2)
    boxes2 = _square(boxes2)

    # ---- stage 3: O-Net -------------------------------------------------
    k3 = MAX_FACES * 2
    boxes3, scores3 = topk_boxes(boxes2, torch.where(valid2, s2, 0.0), k3)
    scores3 = torch.where(torch.isfinite(scores3), scores3, 0.0)
    p3, r3, _lmk = apply_net(ONet, state["onet"], _crops(x, boxes3, 48))
    p3, r3 = p3.reshape(t, k3), r3.reshape(t, k3, 4)
    s3 = torch.where((p3 > t3) & (scores3 > 0), p3, 0.0)
    boxes3 = _calibrate(boxes3, r3)
    return nms(boxes3, s3, 0.7, MAX_FACES, mode="min")


def detect_single(state, img_f32: torch.Tensor,
                  thresholds: Tuple[float, float, float] = THRESHOLDS):
    """img_f32: [H, W, 3] in [0,255] -> (boxes [MAX_FACES,4] pixel xyxy,
    scores [MAX_FACES], valid [MAX_FACES])."""
    b, s, v = detect_batch(state, img_f32[None], thresholds)
    return b[0], s[0], v[0]


def margins_normalize_device(boxes: torch.Tensor, scores: torch.Tensor,
                             valid: torch.Tensor, h: int, w: int):
    """Device twin of ``apply_margins_and_normalize`` (face_detection.py:
    50-64): margin expansion with int-truncated pixel margins (trunc ≡
    python int()), clamp to the frame, normalize by frame dims, and fold the
    score>=0.1 filter into the validity mask. boxes: [.., K, 4] pixel xyxy
    -> (nboxes [.., K, 4] normalized, scores [.., K], valid [.., K])."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    vmargin = torch.trunc((x2 - x1) * VMARGIN)  # reference uses det[2]-det[0]
    hmargin = torch.trunc((y2 - y1) * HMARGIN)  # and det[3]-det[1]
    nb = torch.stack([
        div(torch.clamp_min(x1 - div(hmargin, 2), 0.0), w),
        div(torch.clamp_min(y1 - div(vmargin, 2), 0.0), h),
        div(torch.clamp_max(x2 + div(hmargin, 2), float(w)), w),
        div(torch.clamp_max(y2 + div(vmargin, 2), float(h)), h),
    ], dim=-1)
    ok = valid & (scores >= 0.1)
    return (torch.where(ok[..., None], nb, 0.0),
            torch.where(ok, scores, 0.0), ok)


def apply_margins_and_normalize(boxes: np.ndarray, scores: np.ndarray,
                                valid: np.ndarray, h: int, w: int):
    """Host post-processing matching face_detection.py:50-64: margin
    expansion (int-truncated pixel margins), clamp, normalize, score>=0.1."""
    out = []
    for b, s, v in zip(boxes, scores, valid):
        if not v or s < 0.1:
            continue
        x1, y1, x2, y2 = float(b[0]), float(b[1]), float(b[2]), float(b[3])
        vmargin_pix = int((x2 - x1) * VMARGIN)  # reference uses det[2]-det[0]
        hmargin_pix = int((y2 - y1) * HMARGIN)  # and det[3]-det[1]
        out.append((
            max(x1 - hmargin_pix / 2, 0) / w,
            max(y1 - vmargin_pix / 2, 0) / h,
            min(x2 + hmargin_pix / 2, w) / w,
            min(y2 + vmargin_pix / 2, h) / h,
            float(s),
        ))
    return out
