"""The face_embedding configuration: MTCNN's P-, R- and O-Nets (Zhang et
al., 2016) and FaceNet's Inception-ResNet-v1 (davidsandberg/facenet, 160 x
160 crops, 128-d), in plain PyTorch, float32, no kernels of the program.

What it gives the harness:

  * ``build``: the weights, drawn from the seed on the card in one call a
    net, the classifier and box-regression heads set so that their outputs
    over the run's own frames have the mean and spread the traffic file
    states (the draw changes with the seed; the work a frame does does
    not);
  * ``write_weights``: the npz files, in the layout the program reads
    (the JAX package's flax tree, written from this file's own tensors);
  * ``reference``: the cascade (the program's stated semantics: the
    padded capacities, thresholds, pyramid and margins of the JAX
    package's MTCNN) on a packet's frames, and FaceNet on the crops of
    the program's own stored boxes;
  * ``compare``: the numbers held to the configuration's limits;
  * ``flops`` and ``bounds``: the work the stored frames needed, and the
    least time of each kernel call, for the per-layer metrics.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import plain, roofline
from ..plain import conv2d, div, linear

# ---------------------------------------------------------------- weights

# (torch key, shape, flax path, layout kind) of every leaf


def _mtcnn_spec():
    nets = {
        "pnet": [("conv1", "conv", (10, 3, 3, 3)), ("prelu1", "prelu", 10),
                 ("conv2", "conv", (16, 10, 3, 3)), ("prelu2", "prelu", 16),
                 ("conv3", "conv", (32, 16, 3, 3)), ("prelu3", "prelu", 32),
                 ("conv4_1", "conv", (2, 32, 1, 1)),
                 ("conv4_2", "conv", (4, 32, 1, 1))],
        "rnet": [("conv1", "conv", (28, 3, 3, 3)), ("prelu1", "prelu", 28),
                 ("conv2", "conv", (48, 28, 3, 3)), ("prelu2", "prelu", 48),
                 ("conv3", "conv", (64, 48, 2, 2)), ("prelu3", "prelu", 64),
                 ("dense4", "linear_conv:64,3,3", (128, 576)),
                 ("prelu4", "prelu", 128),
                 ("dense5_1", "linear", (2, 128)),
                 ("dense5_2", "linear", (4, 128))],
        "onet": [("conv1", "conv", (32, 3, 3, 3)), ("prelu1", "prelu", 32),
                 ("conv2", "conv", (64, 32, 3, 3)), ("prelu2", "prelu", 64),
                 ("conv3", "conv", (64, 64, 3, 3)), ("prelu3", "prelu", 64),
                 ("conv4", "conv", (128, 64, 2, 2)), ("prelu4", "prelu", 128),
                 ("dense5", "linear_conv:128,3,3", (256, 1152)),
                 ("prelu5", "prelu", 256),
                 ("dense6_1", "linear", (2, 256)),
                 ("dense6_2", "linear", (4, 256)),
                 ("dense6_3", "linear", (10, 256))],
    }
    flax_names = {"dense4": "fc1", "dense5_1": "fc2_1", "dense5_2": "fc2_2",
                  "dense5": "fc1", "dense6_1": "fc2_1", "dense6_2": "fc2_2",
                  "dense6_3": "fc2_3"}
    spec = []
    for net, layers in nets.items():
        for name, kind, shape in layers:
            fname = flax_names.get(name, name)
            if kind == "prelu":
                spec.append((f"{net}.{name}.weight", (shape,),
                             f"{net}/{fname}/alpha", "prelu"))
                continue
            spec.append((f"{net}.{name}.weight", shape,
                         f"{net}/{fname}/kernel", kind))
            spec.append((f"{net}.{name}.bias", (shape[0],),
                         f"{net}/{fname}/bias", "bias"))
    return spec


# FaceNet's units: (torch prefix, flax prefix, cin, cout, kernel, stride,
# padding); the blocks' linear up-projections: (torch prefix, flax prefix,
# cin, cout)
def _facenet_units():
    convs, ups = [], []

    def bc(t, f, cin, cout, k, s=1, p=0):
        k = (k, k) if isinstance(k, int) else k
        p = (p, p) if isinstance(p, int) else p
        convs.append((t, f, cin, cout, k, s, p))

    for t, f, cin, cout, k, s, p in (
            ("conv2d_1a", "conv1", 3, 32, 3, 2, 0),
            ("conv2d_2a", "conv2", 32, 32, 3, 1, 0),
            ("conv2d_2b", "conv3", 32, 64, 3, 1, 1),
            ("conv2d_3b", "conv4", 64, 80, 1, 1, 0),
            ("conv2d_4a", "conv5", 80, 192, 3, 1, 0),
            ("conv2d_4b", "conv6", 192, 256, 3, 2, 0)):
        bc(t, f, cin, cout, k, s, p)
    for i in range(5):
        t, f = f"repeat_1.{i}", f"block35_{i}"
        bc(f"{t}.branch0", f"{f}/b0", 256, 32, 1)
        bc(f"{t}.branch1.0", f"{f}/b1_0", 256, 32, 1)
        bc(f"{t}.branch1.1", f"{f}/b1_1", 32, 32, 3, 1, 1)
        bc(f"{t}.branch2.0", f"{f}/b2_0", 256, 32, 1)
        bc(f"{t}.branch2.1", f"{f}/b2_1", 32, 32, 3, 1, 1)
        bc(f"{t}.branch2.2", f"{f}/b2_2", 32, 32, 3, 1, 1)
        ups.append((f"{t}.conv2d", f"{f}/up", 96, 256))
    bc("mixed_6a.branch0", "ra0", 256, 384, 3, 2)
    bc("mixed_6a.branch1.0", "ra1_0", 256, 192, 1)
    bc("mixed_6a.branch1.1", "ra1_1", 192, 192, 3, 1, 1)
    bc("mixed_6a.branch1.2", "ra1_2", 192, 256, 3, 2)
    for i in range(10):
        t, f = f"repeat_2.{i}", f"block17_{i}"
        bc(f"{t}.branch0", f"{f}/b0", 896, 128, 1)
        bc(f"{t}.branch1.0", f"{f}/b1_0", 896, 128, 1)
        bc(f"{t}.branch1.1", f"{f}/b1_1", 128, 128, (1, 7), 1, (0, 3))
        bc(f"{t}.branch1.2", f"{f}/b1_2", 128, 128, (7, 1), 1, (3, 0))
        ups.append((f"{t}.conv2d", f"{f}/up", 256, 896))
    bc("mixed_7a.branch0.0", "rb0_0", 896, 256, 1)
    bc("mixed_7a.branch0.1", "rb0_1", 256, 384, 3, 2)
    bc("mixed_7a.branch1.0", "rb1_0", 896, 256, 1)
    bc("mixed_7a.branch1.1", "rb1_1", 256, 256, 3, 2)
    bc("mixed_7a.branch2.0", "rb2_0", 896, 256, 1)
    bc("mixed_7a.branch2.1", "rb2_1", 256, 256, 3, 1, 1)
    bc("mixed_7a.branch2.2", "rb2_2", 256, 256, 3, 2)
    for i in range(6):
        t, f = (f"repeat_3.{i}", f"block8_{i}") if i < 5 else \
            ("block8", "block8_final")
        bc(f"{t}.branch0", f"{f}/b0", 1792, 192, 1)
        bc(f"{t}.branch1.0", f"{f}/b1_0", 1792, 192, 1)
        bc(f"{t}.branch1.1", f"{f}/b1_1", 192, 192, (1, 3), 1, (0, 1))
        bc(f"{t}.branch1.2", f"{f}/b1_2", 192, 192, (3, 1), 1, (1, 0))
        ups.append((f"{t}.conv2d", f"{f}/up", 384, 1792))
    return convs, ups


FACENET_UNITS = _facenet_units()
EMB = 128
BN_EPS = 1e-3


def _facenet_spec():
    convs, ups = FACENET_UNITS
    spec = []
    for t, f, cin, cout, k, _, _ in convs:
        spec.append((f"{t}.conv.weight", (cout, cin, *k),
                     f"params/{f}/conv/kernel", "conv"))
        for leaf, fl, kind in (("weight", "params/{}/bn/scale", "bn_scale"),
                               ("bias", "params/{}/bn/bias", "bn_bias"),
                               ("running_mean", "batch_stats/{}/bn/mean",
                                "bn_mean"),
                               ("running_var", "batch_stats/{}/bn/var",
                                "bn_var")):
            spec.append((f"{t}.bn.{leaf}", (cout,), fl.format(f), kind))
    for t, f, cin, cout in ups:
        spec.append((f"{t}.weight", (cout, cin, 1, 1),
                     f"params/{f}/kernel", "conv"))
        spec.append((f"{t}.bias", (cout,), f"params/{f}/bias", "bias"))
    spec.append(("last_linear.weight", (EMB, 1792),
                 "params/bottleneck/kernel", "linear"))
    spec.append(("last_bn.bias", (EMB,), "params/bottleneck_bn/bias",
                 "bn_bias"))
    spec.append(("last_bn.running_mean", (EMB,),
                 "batch_stats/bottleneck_bn/mean", "bn_mean"))
    spec.append(("last_bn.running_var", (EMB,),
                 "batch_stats/bottleneck_bn/var", "bn_var"))
    return spec


SPECS = {"mtcnn": _mtcnn_spec(), "facenet": _facenet_spec()}


def _fan_in(shape) -> int:
    return int(np.prod(shape[1:]))


def draw(spec, gen: torch.Generator, device) -> dict:
    """Every leaf of ``spec`` from one normal draw on ``device``: He-normal
    kernels (ReLU and PReLU trunks keep their scale), small biases,
    PReLU slopes near 0.25, BatchNorm scales near 1, shifts and means
    near 0, variances near 1."""
    sizes = [int(np.prod(s)) for _, s, _, _ in spec]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, _, kind), n in zip(spec, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if kind in ("conv", "linear") or kind.startswith("linear_conv"):
            v = v * float(np.sqrt(2.0 / _fan_in(shape)))
        elif kind == "prelu":
            v = 0.25 + 0.05 * v
        elif kind == "bn_scale":
            v = 1.0 + 0.1 * v
        elif kind == "bn_var":
            v = torch.exp(0.2 * v)
        else:  # biases, BatchNorm shifts and means
            v = 0.05 * v
        out[key] = v.contiguous()
    return out


def _to_flax(kind: str, a: np.ndarray) -> np.ndarray:
    if kind == "conv":  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if kind == "linear":
        return a.T
    if kind.startswith("linear_conv:"):  # [O, C*H*W] -> [H*W*C, O]
        c, h, w = (int(x) for x in kind.split(":")[1].split(","))
        o = a.shape[0]
        return a.reshape(o, c, h, w).transpose(2, 3, 1, 0).reshape(
            h * w * c, o)
    return a


def write_weights(state: dict, directory: str, cfg=None) -> dict:
    """-> {"mtcnn": path, "facenet": path}: uncompressed npz files in the
    flax layout, each leaf under its '/'-joined path."""
    import os

    paths = {}
    for model, spec in SPECS.items():
        flat = {fpath: np.ascontiguousarray(
                    _to_flax(kind, state[key].float().cpu().numpy()),
                    np.float32)
                for key, _, fpath, kind in spec}
        paths[model] = os.path.join(directory, f"{model}.npz")
        np.savez(paths[model], **flat)
    return paths


# ------------------------------------------------------------------ nets

def _prelu(x, a):
    return torch.where(x > 0, x, a.view(1, -1, *([1] * (x.dim() - 2))) * x)


def pnet(p, x):
    """NHWC in -> (logits [B, 2, GH, GW], reg [B, 4, GH, GW])."""
    x = x.permute(0, 3, 1, 2)
    x = plain.max_pool_same(_prelu(conv2d(x, p["pnet.conv1.weight"],
                                          p["pnet.conv1.bias"]),
                                   p["pnet.prelu1.weight"]), 2, 2)
    x = _prelu(conv2d(x, p["pnet.conv2.weight"], p["pnet.conv2.bias"]),
               p["pnet.prelu2.weight"])
    x = _prelu(conv2d(x, p["pnet.conv3.weight"], p["pnet.conv3.bias"]),
               p["pnet.prelu3.weight"])
    return (conv2d(x, p["pnet.conv4_1.weight"], p["pnet.conv4_1.bias"]),
            conv2d(x, p["pnet.conv4_2.weight"], p["pnet.conv4_2.bias"]))


def rnet(p, x):
    """[K, 24, 24, 3] -> (logits [K, 2], reg [K, 4])."""
    x = x.permute(0, 3, 1, 2)
    x = plain.max_pool_same(_prelu(conv2d(x, p["rnet.conv1.weight"],
                                          p["rnet.conv1.bias"]),
                                   p["rnet.prelu1.weight"]), 3, 2)
    x = torch.nn.functional.max_pool2d(_prelu(
        conv2d(x, p["rnet.conv2.weight"], p["rnet.conv2.bias"]),
        p["rnet.prelu2.weight"]), 3, 2)
    x = _prelu(conv2d(x, p["rnet.conv3.weight"], p["rnet.conv3.bias"]),
               p["rnet.prelu3.weight"])
    x = _prelu(linear(x.reshape(x.shape[0], -1), p["rnet.dense4.weight"],
                      p["rnet.dense4.bias"]), p["rnet.prelu4.weight"])
    return (linear(x, p["rnet.dense5_1.weight"], p["rnet.dense5_1.bias"]),
            linear(x, p["rnet.dense5_2.weight"], p["rnet.dense5_2.bias"]))


def onet(p, x):
    """[K, 48, 48, 3] -> (logits [K, 2], reg [K, 4])."""
    x = x.permute(0, 3, 1, 2)
    x = plain.max_pool_same(_prelu(conv2d(x, p["onet.conv1.weight"],
                                          p["onet.conv1.bias"]),
                                   p["onet.prelu1.weight"]), 3, 2)
    x = torch.nn.functional.max_pool2d(_prelu(
        conv2d(x, p["onet.conv2.weight"], p["onet.conv2.bias"]),
        p["onet.prelu2.weight"]), 3, 2)
    x = plain.max_pool_same(_prelu(conv2d(x, p["onet.conv3.weight"],
                                          p["onet.conv3.bias"]),
                                   p["onet.prelu3.weight"]), 2, 2)
    x = _prelu(conv2d(x, p["onet.conv4.weight"], p["onet.conv4.bias"]),
               p["onet.prelu4.weight"])
    x = _prelu(linear(x.reshape(x.shape[0], -1), p["onet.dense5.weight"],
                      p["onet.dense5.bias"]), p["onet.prelu5.weight"])
    return (linear(x, p["onet.dense6_1.weight"], p["onet.dense6_1.bias"]),
            linear(x, p["onet.dense6_2.weight"], p["onet.dense6_2.bias"]))


def _softmax1(x):
    """The second class of a softmax over dim 1."""
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return (e / e.sum(dim=1, keepdim=True))[:, 1]


def facenet(p, x):
    """[B, 160, 160, 3] prewhitened -> [B, 128] L2-normalized."""
    convs, _ = FACENET_UNITS
    unit = {t: (s, pd) for t, _, _, _, _, s, pd in convs}

    def bc(x, t):
        s, pd = unit[t]
        y = conv2d(x, p[f"{t}.conv.weight"], None, s, pd)
        y = plain.batch_norm(y, p[f"{t}.bn.running_mean"],
                             p[f"{t}.bn.running_var"], p[f"{t}.bn.weight"],
                             p[f"{t}.bn.bias"], BN_EPS)
        return torch.relu(y)

    def up(x, t):
        return conv2d(x, p[f"{t}.conv2d.weight"], p[f"{t}.conv2d.bias"])

    pool = torch.nn.functional.max_pool2d
    x = x.permute(0, 3, 1, 2)
    x = bc(bc(bc(x, "conv2d_1a"), "conv2d_2a"), "conv2d_2b")
    x = pool(x, 3, 2)
    x = bc(bc(bc(x, "conv2d_3b"), "conv2d_4a"), "conv2d_4b")
    for i in range(5):
        t = f"repeat_1.{i}"
        b0 = bc(x, f"{t}.branch0")
        b1 = bc(bc(x, f"{t}.branch1.0"), f"{t}.branch1.1")
        b2 = bc(bc(bc(x, f"{t}.branch2.0"), f"{t}.branch2.1"),
                f"{t}.branch2.2")
        x = torch.relu(x + 0.17 * up(torch.cat([b0, b1, b2], 1), t))
    x = torch.cat([bc(x, "mixed_6a.branch0"),
                   bc(bc(bc(x, "mixed_6a.branch1.0"), "mixed_6a.branch1.1"),
                      "mixed_6a.branch1.2"), pool(x, 3, 2)], 1)
    for i in range(10):
        t = f"repeat_2.{i}"
        b0 = bc(x, f"{t}.branch0")
        b1 = bc(bc(bc(x, f"{t}.branch1.0"), f"{t}.branch1.1"),
                f"{t}.branch1.2")
        x = torch.relu(x + 0.10 * up(torch.cat([b0, b1], 1), t))
    x = torch.cat([
        bc(bc(x, "mixed_7a.branch0.0"), "mixed_7a.branch0.1"),
        bc(bc(x, "mixed_7a.branch1.0"), "mixed_7a.branch1.1"),
        bc(bc(bc(x, "mixed_7a.branch2.0"), "mixed_7a.branch2.1"),
           "mixed_7a.branch2.2"), pool(x, 3, 2)], 1)
    for i in range(6):
        t = f"repeat_3.{i}" if i < 5 else "block8"
        b0 = bc(x, f"{t}.branch0")
        b1 = bc(bc(bc(x, f"{t}.branch1.0"), f"{t}.branch1.1"),
                f"{t}.branch1.2")
        x = x + 0.20 * up(torch.cat([b0, b1], 1), t)
        if i < 5:
            x = torch.relu(x)
    x = plain.mean(x, (2, 3))
    x = linear(x, p["last_linear.weight"])
    x = plain.batch_norm(x, p["last_bn.running_mean"],
                         p["last_bn.running_var"],
                         torch.ones_like(p["last_bn.bias"]),
                         p["last_bn.bias"], BN_EPS)
    return x / (torch.sqrt((x * x).sum(dim=-1, keepdim=True)) + 1e-10)


def prewhiten(x):
    dims = tuple(range(1, x.dim()))
    c = x - plain.mean(x, dims, keepdim=True)
    std = torch.sqrt(plain.mean(c * c, dims, keepdim=True))
    floor = float(np.float32(1.0) / np.sqrt(np.float32(np.prod(x.shape[1:]))))
    return c / torch.clamp_min(std, floor)


# --------------------------------------------------------------- cascade

def pyramid_layout(h: int, w: int, cfg: dict):
    m = cfg["mtcnn"]
    minsize = max(12.0, m["window_ratio"] * min(h, w))
    scale = 12.0 / minsize
    minl = min(h, w) * scale
    scales = []
    while minl >= 12.0:
        scales.append(scale * m["pyramid_factor"] ** len(scales))
        minl *= m["pyramid_factor"]
    layout, oy = [], 0
    for s in scales:
        hs, ws = int(np.ceil(h * s)), int(np.ceil(w * s))
        layout.append((s, hs, ws, oy))
        oy += hs + (12 if hs % 2 == 0 else 13)
    return layout


def _square(b):
    side = torch.maximum(b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])
    cx = (b[..., 0] + b[..., 2]) * 0.5
    cy = (b[..., 1] + b[..., 3]) * 0.5
    half = div(side, 2)
    return torch.stack([cx - half, cy - half, cx + half, cy + half], dim=-1)


def _calibrate_boxes(b, reg):
    w = b[..., 2:3] - b[..., 0:1]
    h = b[..., 3:4] - b[..., 1:2]
    return b + reg * torch.cat([w, h, w, h], dim=-1)


class _Calls:
    """The nms and crop calls of a cascade, for their bounds, and the
    candidates each frame hands R-Net and O-Net, for the work."""

    def __init__(self, on: bool):
        self.on = on
        self.nms, self.crop = [], []
        self.inputs = {}  # net -> [T] candidates a frame

    def net_inputs(self, net: str, scores):
        self.inputs[net] = (scores > 0).sum(dim=1).cpu().numpy()

    def nms_call(self, scores, max_out):
        if self.on:
            self.nms.append(roofline.nms_bound(scores, max_out))

    def crop_call(self, images, boxes, fi, size):
        if self.on:
            t, h, w, c = images.shape
            self.crop.append(roofline.crop_bound(t, h, w, c, boxes, fi, size,
                                                 size))


def _crops(x, boxes, size, calls):
    t, k, _ = boxes.shape
    fi = torch.arange(t, device=x.device).repeat_interleave(k)
    flat = boxes.reshape(t * k, 4).contiguous()
    calls.crop_call(x, flat, fi, size)
    return plain.crop_and_resize(x, flat, (size, size), fi)


def _stage1(p, x, cfg, heads=None):
    """P-Net over the fused pyramid canvas -> per-scale cells (boxes [T,
    k, 4], scores or raw head outputs)."""
    m = cfg["mtcnn"]
    t, H, W, _ = x.shape
    layout = pyramid_layout(H, W, cfg)
    hc = layout[-1][3] + layout[-1][1]
    wc = max(ws for _, _, ws, _ in layout)
    canvas = x.new_zeros((t, hc, wc, 3))
    for s, hs, ws, oy in layout:
        canvas[:, oy:oy + hs, :ws] = plain.resize_hw(x, 1, hs, ws, "linear")
    logits, reg = pnet(p, canvas)
    cells = []
    for s, hs, ws, oy in layout:
        g0, gh, gw = oy // 2, (hs - 12) // 2 + 1, (ws - 12) // 2 + 1
        if gh <= 0 or gw <= 0:
            continue
        lg = logits[:, :, g0:g0 + gh, :gw]
        rg = reg[:, :, g0:g0 + gh, :gw]
        if heads is not None:
            heads.append((lg[:, 1] - lg[:, 0], rg))
            continue
        prob = _softmax1(lg).reshape(t, -1)
        sub_r = rg.permute(0, 2, 3, 1).reshape(t, -1, 4)
        k = min(m["max_cells_per_scale"], prob.shape[1])
        top_p, idx = plain.topk_stable(prob, k)
        gy = torch.div(idx, gw, rounding_mode="floor").to(torch.float32)
        gx = (idx % gw).to(torch.float32)
        b = torch.stack([div(gx * 2 + 1, s), div(gy * 2 + 1, s),
                         div(gx * 2 + 12, s), div(gy * 2 + 12, s)], dim=-1)
        b = _calibrate_boxes(b, sub_r.gather(1, idx[..., None].expand(t, k,
                                                                       4)))
        cells.append((b, torch.where(top_p > cfg["thresholds"][0], top_p,
                                     0.0)))
    return cells


def _nms_per_scale(cells, cfg, calls):
    n, t = len(cells), cells[0][1].shape[0]
    m = cfg["mtcnn"]["max_cells_per_scale"]
    pad = torch.nn.functional.pad
    scores = torch.cat([pad(s, (0, m - s.shape[1])) for _, s in cells])
    calls.nms_call(scores, m)
    bs, ss, vs = plain.nms(
        torch.cat([pad(b, (0, 0, 0, m - b.shape[1])) for b, _ in cells]),
        scores, 0.5, m)
    bs, ss, vs = bs.view(n, t, m, 4), ss.view(n, t, m), vs.view(n, t, m)
    ks = [s.shape[1] for _, s in cells]
    return (torch.cat([bs[i, :, :k] for i, k in enumerate(ks)], dim=1),
            torch.cat([torch.where(vs[i, :, :k], ss[i, :, :k], 0.0)
                       for i, k in enumerate(ks)], dim=1))


def detect(p, frames_f32, cfg, calls=None, heads=None, stop=None):
    """The cascade on [T, H, W, 3] float32 frames in [0, 255] -> pixel
    boxes [T, F, 4], scores [T, F], valid [T, F]. ``heads``: a dict that
    collects the raw head outputs of stage ``stop`` ("pnet", "rnet",
    "onet") over its valid inputs, and ends the cascade there."""
    m = cfg["mtcnn"]
    calls = calls or _Calls(False)
    t1, t2, t3 = cfg["thresholds"]
    t, h, w, _ = frames_f32.shape
    x = (frames_f32 - 127.5) * 0.0078125
    if stop == "pnet":
        found = []
        _stage1(p, x, cfg, heads=found)
        heads["pnet"] = found
        return None
    boxes, scores = plain.topk_boxes(*_nms_per_scale(_stage1(p, x, cfg), cfg,
                                                     calls), m["max_stage1"])
    scores = torch.where(torch.isfinite(scores), scores, 0.0)
    calls.nms_call(scores, m["max_stage1"])
    boxes, scores, valid = plain.nms(boxes, scores, 0.7, m["max_stage1"])
    boxes = _square(boxes)

    k2 = m["max_stage2"]
    boxes2, scores2 = plain.topk_boxes(boxes, torch.where(valid, scores, 0.0),
                                       k2)
    scores2 = torch.where(torch.isfinite(scores2), scores2, 0.0)
    calls.net_inputs("rnet", scores2)
    l2, r2 = rnet(p, _crops(x, boxes2, 24, calls))
    if stop == "rnet":
        ok = (scores2 > 0).reshape(-1)
        heads["rnet"] = ((l2[:, 1] - l2[:, 0])[ok], r2[ok])
        return None
    p2, r2 = _softmax1(l2).reshape(t, k2), r2.reshape(t, k2, 4)
    s2 = torch.where((p2 > t2) & (scores2 > 0), p2, 0.0)
    boxes2 = _calibrate_boxes(boxes2, r2)
    calls.nms_call(s2, k2)
    boxes2, s2, valid2 = plain.nms(boxes2, s2, 0.7, k2)
    boxes2 = _square(boxes2)

    k3 = 2 * m["max_faces"]
    boxes3, scores3 = plain.topk_boxes(boxes2, torch.where(valid2, s2, 0.0),
                                       k3)
    scores3 = torch.where(torch.isfinite(scores3), scores3, 0.0)
    calls.net_inputs("onet", scores3)
    l3, r3 = onet(p, _crops(x, boxes3, 48, calls))
    if stop == "onet":
        ok = (scores3 > 0).reshape(-1)
        heads["onet"] = ((l3[:, 1] - l3[:, 0])[ok], r3[ok])
        return None
    p3, r3 = _softmax1(l3).reshape(t, k3), r3.reshape(t, k3, 4)
    s3 = torch.where((p3 > t3) & (scores3 > 0), p3, 0.0)
    boxes3 = _calibrate_boxes(boxes3, r3)
    calls.nms_call(s3, m["max_faces"])
    return plain.nms(boxes3, s3, 0.7, m["max_faces"], mode="min")


def margins(boxes, scores, valid, h: int, w: int, cfg):
    """Margin expansion (int-truncated pixel margins), clamp, normalize by
    the frame, score >= 0.1 -> (normalized boxes, scores, valid)."""
    m = cfg["mtcnn"]
    x1, y1, x2, y2 = boxes.unbind(-1)
    vm = torch.trunc((x2 - x1) * m["vmargin"])
    hm = torch.trunc((y2 - y1) * m["hmargin"])
    nb = torch.stack([div(torch.clamp_min(x1 - div(hm, 2), 0.0), w),
                      div(torch.clamp_min(y1 - div(vm, 2), 0.0), h),
                      div(torch.clamp_max(x2 + div(hm, 2), float(w)), w),
                      div(torch.clamp_max(y2 + div(vm, 2), float(h)), h)],
                     dim=-1)
    ok = valid & (scores >= 0.1)
    return torch.where(ok[..., None], nb, 0.0), torch.where(ok, scores, 0.0), ok


# ---------------------------------------------------------- calibration

def _set_head(p, net: str, cls: str, reg: str, d, r, head: dict,
              reg_std: float):
    """Rewrite ``net``'s classifier so its logit difference over these
    inputs has mean ``head["shift"]`` and spread ``head["scale"]``, and
    its box regression so each offset has mean 0 and spread ``reg_std``
    (statistics of the float32 outputs ``d`` and ``r``)."""
    wk, bk = f"{net}.{cls}.weight", f"{net}.{cls}.bias"
    mu, sd = float(d.double().mean()), float(d.double().std()) + 1e-12
    a = head["scale"] / sd
    w, b = p[wk].clone(), p[bk].clone()
    dw, db = w[1] - w[0], b[1] - b[0]
    w.zero_()
    b.zero_()
    w[1] = dw * a
    b[1] = (db - mu) * a + head["shift"]
    p[wk], p[bk] = w.contiguous(), b.contiguous()
    wk, bk = f"{net}.{reg}.weight", f"{net}.{reg}.bias"
    rr = r.transpose(0, 1).reshape(4, -1).double()
    mu, sd = rr.mean(dim=1), rr.std(dim=1) + 1e-12
    scale = (reg_std / sd).to(p[wk].dtype)
    shape = (-1,) + (1,) * (p[wk].dim() - 1)
    p[wk] = (p[wk] * scale.view(shape)).contiguous()
    p[bk] = ((p[bk] - mu.to(p[bk].dtype)) * scale).contiguous()


def build(cfg: dict, traffic: dict, pool_u8, gen, device) -> dict:
    """The configuration's weights from ``gen`` (a generator on
    ``device``), with the heads set over the first frames of the pool."""
    p = draw(SPECS["mtcnn"], gen, device)
    p.update(draw(SPECS["facenet"], gen, device))
    heads = traffic["heads"]
    n = traffic["calibration_frames"]
    frames = pool_u8[:n].to(device).float()
    with torch.no_grad():
        for net, cls, reg in (("pnet", "conv4_1", "conv4_2"),
                              ("rnet", "dense5_1", "dense5_2"),
                              ("onet", "dense6_1", "dense6_2")):
            got = {}
            detect(p, frames, cfg, heads=got, stop=net)
            if net == "pnet":
                d = torch.cat([dd.reshape(-1) for dd, _ in got[net]])
                r = torch.cat([rr.permute(1, 0, 2, 3).reshape(4, -1)
                               for _, rr in got[net]], dim=1).T
            else:
                d, r = got[net]
            if d.numel() < 2:
                raise RuntimeError(f"calibration: no valid {net} inputs")
            _set_head(p, net, cls, reg, d, r, heads[net], heads["reg_std"])
    return p


# -------------------------------------------------------- rows and checks

def parse(column: str, data: bytes):
    """A stored element -> numpy: "faces" [n, 5] (x1, y1, x2, y2, score),
    "embeddings" [n, 128]."""
    if column == "faces":
        rows, off = [], 0
        while off < len(data):
            (n,) = struct.unpack_from("<i", data, off)
            rows.append(struct.unpack_from("<5f", data, off + 4))
            off += 4 + n
        return np.asarray(rows, np.float32).reshape(-1, 5)
    return np.frombuffer(data, np.float32).reshape(-1, EMB)


def _crop_px(nb, h: int, w: int):
    x1 = torch.trunc(nb[..., 0] * w)
    y1 = torch.trunc(nb[..., 1] * h)
    x2 = torch.trunc(nb[..., 2] * w)
    y2 = torch.trunc(nb[..., 3] * h)
    return torch.stack([x1, y1, x2, y2], -1), (x2 > x1) & (y2 > y1)


def reference(cfg, p, frames_u8, rows, bounds: bool = False) -> dict:
    """One packet: the cascade's faces of ``frames_u8`` [T, H, W, 3], and
    FaceNet's embedding of each face the program stored for these frames
    (``rows``: [{"faces": [n, 5], "embeddings": [n, 128]}]) -> {"frames":
    [{"faces": [n, 5], "embeddings": [n, 128]}] a frame, "calls": {"nms":
    [ms], "crop": [ms]}}. ``rows`` None: FaceNet on the cascade's own
    faces."""
    calls = _Calls(bounds)
    x = frames_u8.float()
    t, h, w, _ = x.shape
    with torch.no_grad():
        b, s, v = detect(p, x, cfg, calls)
        nb, s, ok = margins(b, s, v, h, w, cfg)
        faces = []
        for i in range(t):
            keep = ok[i]
            faces.append(torch.cat([nb[i][keep], s[i][keep][:, None]], 1)
                         .cpu().numpy())
        # FaceNet on the program's own boxes (its output judged stage by
        # stage): the crop of each, as the program cuts it; without rows,
        # on this cascade's own faces
        stored = [torch.as_tensor((f if rows is None else r["faces"])[:, :4],
                                  device=x.device)
                  for f, r in zip(faces, rows or faces)]
        fi = torch.cat([torch.full((len(sb),), i, dtype=torch.int64,
                                   device=x.device)
                        for i, sb in enumerate(stored)])
        px, good = _crop_px(torch.cat(stored), h, w)
        # the budget: the first T * faces_budget croppable faces of the
        # packet, frame by frame, are embedded; the rest keep the zero
        # vector (the op's stated overflow)
        budget = t * max(1, min(cfg["faces_budget"],
                                cfg["mtcnn"]["max_faces"]))
        good = good & (torch.cumsum(good.to(torch.int64), 0) <= budget)
        emb = torch.zeros((px.shape[0], EMB), device=x.device)
        if bool(good.any()):
            crops = plain.crop_and_resize(x, px[good].contiguous(),
                                          (160, 160), fi[good])
            emb[good] = facenet(p, prewhiten(crops))
        if bounds:
            # the program's crop call: the budget's B = T * budget slots,
            # the valid faces first, zero boxes after
            n_slots = budget
            boxes = torch.zeros((n_slots, 4), device=x.device)
            fidx = torch.zeros((n_slots,), dtype=torch.int64,
                               device=x.device)
            n = min(n_slots, px.shape[0])
            boxes[:n], fidx[:n] = px[:n], fi[:n]
            calls.crop_call(x, boxes, fidx, 160)
    frames, off = [], 0
    emb = emb.cpu().numpy()
    for i, sb in enumerate(stored):
        frames.append({"faces": faces[i], "embeddings": emb[off:off + len(sb)]})
        off += len(sb)
    return {"frames": frames, "calls": {"nms": calls.nms, "crop": calls.crop}}


def _iou(a, b):
    x1, y1 = np.maximum(a[0], b[0]), np.maximum(a[1], b[1])
    x2, y2 = np.minimum(a[2], b[2]), np.minimum(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def match(a, b, thresh: float = 0.5):
    """Greedy one-to-one pairs of rows of a and b [n, >=4] by IoU, best
    first -> [(i, j)]."""
    pairs = sorted(((_iou(a[i], b[j]), i, j) for i in range(len(a))
                    for j in range(len(b))), reverse=True)
    used_a, used_b, out = set(), set(), []
    for iou, i, j in pairs:
        if iou < thresh:
            break
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    return out


def compare(cfg, got: list, want: list, size) -> dict:
    """The program's rows against the reference's, frame by frame ->
    {"face_miss": faces in one and not the other over the reference's
    faces, "box_gap_px": widest coordinate gap of a matched face in
    pixels, "score_gap": widest score gap, "emb_gap": widest L2 gap of an
    embedding of the program's own box}."""
    h, w = size
    scale = np.array([w, h, w, h], np.float64)
    missed = n_ref = 0
    box_gap = score_gap = emb_gap = 0.0
    for g, r in zip(got, want):
        gf, rf = g["faces"], r["faces"]
        n_ref += len(rf)
        pairs = match(gf, rf)
        missed += len(gf) + len(rf) - 2 * len(pairs)
        for i, j in pairs:
            box_gap = max(box_gap, float(np.max(np.abs(
                (gf[i, :4].astype(np.float64) - rf[j, :4]) * scale))))
            score_gap = max(score_gap, float(abs(gf[i, 4] - rf[j, 4])))
        ge, re = g["embeddings"], r["embeddings"]
        if len(ge) != len(re):
            emb_gap = max(emb_gap, 2.0)
        elif len(ge):
            emb_gap = max(emb_gap, float(np.max(np.linalg.norm(
                ge.astype(np.float64) - re, axis=1))))
    return {"face_miss": missed / max(n_ref, 1), "box_gap_px": box_gap,
            "score_gap": score_gap, "emb_gap": emb_gap,
            "faces_compared": n_ref}


# ------------------------------------------------------------------ work

def flops_per_item(cfg, h: int, w: int) -> dict:
    """Float32 operations (2 a multiply-add) of the convolutions and dense
    layers, counted on meta tensors from the shapes alone: P-Net over a
    frame's pyramid, R-Net and O-Net a candidate, FaceNet a face."""
    meta = torch.device("meta")
    p = {key: torch.empty(shape, device=meta)
         for spec in SPECS.values() for key, shape, _, _ in spec}
    out = {}
    with plain.count_flops() as n:
        for _, hs, ws, _ in pyramid_layout(h, w, cfg):
            pnet(p, torch.empty((1, hs, ws, 3), device=meta))
    out["pnet"] = n[0]
    for net, fn, size in (("rnet", rnet, 24), ("onet", onet, 48),
                          ("facenet", facenet, 160)):
        with plain.count_flops() as n:
            fn(p, torch.empty((1, size, size, 3), device=meta))
        out[net] = n[0]
    return out


def stage_inputs(cfg, p, frames_u8, block: int = 48) -> dict:
    """{"rnet": [T], "onet": [T]}: the candidates that passed the stage
    before, a frame, as this reference's cascade finds them."""
    out = {"rnet": [], "onet": []}
    with torch.no_grad():
        for a in range(0, len(frames_u8), block):
            calls = _Calls(False)
            detect(p, torch.as_tensor(frames_u8[a:a + block]).to(
                p["pnet.conv1.weight"].device).float(), cfg, calls)
            for net in out:
                out[net].append(calls.inputs[net])
    return {net: np.concatenate(v) for net, v in out.items()}


def flops(cfg, p, pool_u8, idx, rows: list) -> float:
    """The work the stored frames ``rows`` (pool frames ``idx``) needed:
    P-Net over each frame's pyramid, R-Net and O-Net on the candidates
    that passed the stage before, FaceNet on each face kept; never a
    padded slot of the cascade's capacities or of the budget."""
    _, h, w, _ = pool_u8.shape
    per = flops_per_item(cfg, h, w)
    used = np.unique(idx)
    n = stage_inputs(cfg, p, pool_u8[used])
    at = {int(f): i for i, f in enumerate(used)}
    pos = np.array([at[int(f)] for f in idx], np.int64)
    faces = sum(len(r["faces"]) for r in rows)
    return float(per["pnet"] * len(rows)
                 + per["rnet"] * int(n["rnet"][pos].sum())
                 + per["onet"] * int(n["onet"][pos].sum())
                 + per["facenet"] * faces)
