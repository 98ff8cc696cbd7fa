"""The frcnn_vgg16 configuration: py-faster-rcnn's Faster R-CNN VGG16 for
COCO (Ren et al. 2015, arXiv:1506.01497; models/coco/VGG16/
faster_rcnn_end2end/test.prototxt: conv1_1..conv5_3, the RPN with 9
anchors, fc6 and fc7 at 4096, 81 classes) at its TEST settings
(lib/fast_rcnn/config.py: the shorter side to 600 within 1000, 6000
anchors before the proposals' NMS at 0.7, 300 after, 16-pixel least box),
then the reference decode (faster_rcnn_output_kernel_cpu.cpp: the argmax
over the 80 classes above 0.7, ``best_nms`` 0.3 "min"), in plain PyTorch
and NumPy, float32, no kernels of the program.

It follows the program's stated semantics (the JAX package's): the
frames resized as ``jax.image.resize`` does and less the caffe means (no
channel swap), anchors decoded with py-faster-rcnn's ``bbox_transform_inv``
less a pixel at the far edges, top-k in stable order, greedy NMS, the RoIs
cropped 7 x 7 from the stride-16 map by bilinear RoIAlign (two taps a side
at half-pixel centres), fc6 over the crop's HWC flatten, and the rows the
proposals' NMS did not keep set to the one-hot background.

What it gives the harness: ``build`` (the weights from the seed, the RPN
and class heads set over the pool's first frames), ``write_weights`` (the
npz the program reads), ``reference`` (a packet's detections), ``compare``,
``flops`` and the bounds of the ``nms`` and ``crop`` calls.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

from .. import plain, roofline
from ..plain import conv2d, linear

NUM_CLASSES, FEAT, POOL, STRIDE, N_ANCHORS = 81, 512, 7, 16, 9
ANCHOR_RATIOS, ANCHOR_SCALES = (0.5, 1.0, 2.0), (8.0, 16.0, 32.0)
# frames a block of the reference's passes: a 144-frame packet in blocks
# fits the card beside the check's other state
BLOCK = 16

_VGG = [("conv1", 2, 64), ("conv2", 2, 128), ("conv3", 3, 256),
        ("conv4", 3, 512), ("conv5", 3, 512)]


def _layers():
    """(torch prefix, flax prefix, weight shape, kind) of every layer."""
    out, cin = [], 3
    for blk, reps, f in _VGG:
        for i in range(1, reps + 1):
            out.append((f"vgg.{blk}_{i}", f"vgg/{blk}_{i}", (f, cin, 3, 3),
                        "conv"))
            cin = f
    out += [("rpn_conv", "rpn_conv", (512, FEAT, 3, 3), "conv"),
            ("rpn_cls_score", "rpn_cls_score", (2 * N_ANCHORS, 512, 1, 1),
             "conv"),
            ("rpn_bbox_pred", "rpn_bbox_pred", (4 * N_ANCHORS, 512, 1, 1),
             "conv"),
            ("fc6", "fc6", (4096, POOL * POOL * FEAT), "linear"),
            ("fc7", "fc7", (4096, 4096), "linear"),
            ("cls_score", "cls_score", (NUM_CLASSES, 4096), "linear"),
            ("bbox_pred", "bbox_pred", (4 * NUM_CLASSES, 4096), "linear")]
    return out


def spec(cfg=None):
    """(torch key, shape, flax path, kind) of every leaf."""
    out = []
    for key, fp, shape, kind in _layers():
        out.append((f"{key}.weight", shape, f"params/{fp}/kernel", kind))
        out.append((f"{key}.bias", (shape[0],), f"params/{fp}/bias", "bias"))
    return out


def draw(leaves, gen, device) -> dict:
    """He-normal kernels and small biases, from one normal draw."""
    sizes = [int(np.prod(s)) for _, s, _, _ in leaves]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, _, kind), n in zip(leaves, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if kind == "bias":
            v = 0.05 * v
        else:
            v = v * float(np.sqrt(2.0 / np.prod(shape[1:])))
        out[key] = v.contiguous()
    return out


def write_weights(state: dict, directory: str, cfg=None) -> dict:
    """The npz the program reads: the JAX package's flax tree (convs HWIO,
    dense kernels [in, out]; fc6's rows in the crop's HWC order)."""
    path = os.path.join(directory, "faster_rcnn.npz")
    flat = {}
    for key, _, fpath, kind in spec(cfg):
        a = state[key].float().cpu().numpy()
        if kind == "conv":
            a = a.transpose(2, 3, 1, 0)
        elif kind == "linear":
            a = a.T
        flat[fpath] = np.ascontiguousarray(a, np.float32)
    np.savez(path, **flat)
    return {"faster_rcnn": path}


# ------------------------------------------------------------------ net

def scaled_size(h: int, w: int, cfg) -> tuple:
    """py-faster-rcnn's test size of an h x w frame (lib/fast_rcnn/test.py
    ``_get_image_blob``) -> (height, width)."""
    f = cfg["scale"] / min(h, w)
    if round(f * max(h, w)) > cfg["max_size"]:
        f = cfg["max_size"] / max(h, w)
    return int(round(h * f)), int(round(w * f))


def prepare(frames_u8, cfg):
    """[T, H, W, 3] uint8 -> the net's input [T, h, w, 3] float32: resized
    to the test size, less the caffe means."""
    x = frames_u8.float()
    th, tw = scaled_size(x.shape[1], x.shape[2], cfg)
    x = plain.resize_hw(x, 1, th, tw, "linear")
    return x - torch.tensor(cfg["mean_bgr"], dtype=torch.float32,
                            device=x.device)


def trunk(p, x):
    """x [B, h, w, 3] -> (conv5_3 [B, 512, h/16, w/16], RPN logits [B,
    h/16, w/16, 18] as [9 bg, 9 fg], deltas [B, h/16, w/16, 36]); the
    convolutions take the NHWC input as it lies."""
    x = x.permute(0, 3, 1, 2)
    for bi, (blk, reps, _) in enumerate(_VGG):
        for i in range(1, reps + 1):
            key = f"vgg.{blk}_{i}"
            x = torch.relu(conv2d(x, p[f"{key}.weight"], p[f"{key}.bias"],
                                  1, 1))
        if bi < 4:
            x = F.max_pool2d(x, 2, 2)
    rpn = torch.relu(conv2d(x, p["rpn_conv.weight"], p["rpn_conv.bias"], 1,
                            1))
    return (x, rpn_heads(p, rpn, "rpn_cls_score"),
            rpn_heads(p, rpn, "rpn_bbox_pred"), rpn)


def rpn_heads(p, rpn, name):
    return conv2d(rpn, p[f"{name}.weight"], p[f"{name}.bias"]).permute(
        0, 2, 3, 1)


def anchors(fh: int, fw: int, device) -> torch.Tensor:
    """py-faster-rcnn's ``generate_anchors`` (a 16 x 16 base box, each
    ratio's width and height rounded, then each scale) shifted by the
    stride over the fh x fw map, row by row -> [fh * fw * 9, 4]."""
    base = np.array([0.0, 0.0, 15.0, 15.0])
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    rows = []
    for r in ANCHOR_RATIOS:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in ANCHOR_SCALES:
            rows.append([cx - 0.5 * (ws * s - 1), cy - 0.5 * (hs * s - 1),
                         cx + 0.5 * (ws * s - 1), cy + 0.5 * (hs * s - 1)])
    sx, sy = np.meshgrid(np.arange(fw) * STRIDE, np.arange(fh) * STRIDE)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    a = (shifts[:, None, :] + np.asarray(rows)[None, :, :]).reshape(-1, 4)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def proposals(cfg, logits, deltas, h: int, w: int):
    """The proposal layer of a block: fg softmax, decode, clip, the least
    size, the top ``pre_nms``, greedy NMS to ``num_rois`` rows -> (boxes
    [B, R, 4], valid [B, R], the pool's scores [B, K])."""
    b, fh, fw, _ = logits.shape
    fg = torch.softmax(logits.reshape(b, fh * fw, 2, N_ANCHORS), dim=2)[
        :, :, 1, :].reshape(b, -1)
    d = deltas.reshape(b, fh * fw * N_ANCHORS, 4)
    a = anchors(fh, fw, logits.device)
    aw = a[:, 2] - a[:, 0] + 1.0
    ah = a[:, 3] - a[:, 1] + 1.0
    acx = a[:, 0] + 0.5 * aw
    acy = a[:, 1] + 0.5 * ah
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    bw = torch.exp(d[..., 2]) * aw
    bh = torch.exp(d[..., 3]) * ah
    boxes = torch.stack([(cx - 0.5 * bw).clamp(0, w - 1),
                         (cy - 0.5 * bh).clamp(0, h - 1),
                         (cx + 0.5 * bw - 1.0).clamp(0, w - 1),
                         (cy + 0.5 * bh - 1.0).clamp(0, h - 1)], dim=-1)
    big = ((boxes[..., 2] - boxes[..., 0] + 1 >= cfg["rpn_min_size"])
           & (boxes[..., 3] - boxes[..., 1] + 1 >= cfg["rpn_min_size"]))
    score = torch.where(big, fg, -1.0)
    top, idx = plain.topk_stable(score, min(cfg["pre_nms"], score.shape[1]))
    cand = boxes.gather(1, idx[..., None].expand(*idx.shape, 4))
    kb, ks, kv = [], [], []
    # a few frames at a time: the overlaps are [frames, K, K]
    for i in range(0, b, 2):
        out = plain.nms(cand[i:i + 2].contiguous(), top[i:i + 2].contiguous(),
                        cfg["rpn_nms_thresh"], cfg["num_rois"])
        kb.append(out[0])
        kv.append(out[2])
    return torch.cat(kb), torch.cat(kv), top


def roi_head(p, feat, boxes, valid):
    """RoIAlign 7 x 7 on the stride-16 map, fc6, fc7, the class softmax,
    the rows not kept set to the one-hot background -> (cls_prob [B, R,
    81], fc7 [B, R, 4096]); and the crop call's boxes and frames."""
    b, r, _ = boxes.shape
    hwc = feat.permute(0, 2, 3, 1).contiguous()
    fi = torch.arange(b, device=feat.device)[:, None].expand(b, r).reshape(-1)
    flat = (boxes / STRIDE).reshape(-1, 4)
    crops = plain.crop_and_resize(hwc, flat, (POOL, POOL), fi)
    h6 = torch.relu(linear(crops.reshape(b, r, -1), p["fc6.weight"],
                           p["fc6.bias"]))
    fc7 = torch.relu(linear(h6, p["fc7.weight"], p["fc7.bias"]))
    prob = torch.softmax(linear(fc7, p["cls_score.weight"],
                                p["cls_score.bias"]), dim=-1)
    bg = torch.zeros_like(prob)
    bg[..., 0] = 1.0
    v = valid[..., None]
    return torch.where(v, prob, bg), torch.where(v, fc7, 0.0), (hwc, flat, fi)


def forward(cfg, p, frames_u8, calls=None):
    """A packet in blocks of BLOCK frames -> (cls_prob [T, R, 81], rois
    [T, R, 4], fc7 [T, R, 4096], valid [T, R]) on the card; ``calls``
    gathers the proposal pool's scores and the crop's boxes of the whole
    packet, for the bounds of the program's one call of each."""
    probs, rois, fc7s, valids = [], [], [], []
    for a in range(0, frames_u8.shape[0], BLOCK):
        x = prepare(frames_u8[a:a + BLOCK], cfg)
        feat, logits, deltas, _ = trunk(p, x)
        boxes, valid, top = proposals(cfg, logits, deltas, x.shape[1],
                                      x.shape[2])
        prob, fc7, crop = roi_head(p, feat, boxes, valid)
        probs.append(prob)
        rois.append(torch.where(valid[..., None], boxes, 0.0))
        fc7s.append(fc7)
        valids.append(valid)
        if calls is not None:
            calls["scores"].append(top)
            calls["crop"].append((crop[0].shape, crop[1], crop[2] + a))
    return (torch.cat(probs), torch.cat(rois), torch.cat(fc7s),
            torch.cat(valids))


# --------------------------------------------------------------- decode

def nms_min(boxes, scores, thresh: float):
    """The reference's ``best_nms``: highest score first (equal scores in
    row order), a box dropped when it overlaps a kept one by more than
    ``thresh`` of the smaller area; in float64 -> kept rows, in order."""
    order = sorted(range(len(scores)), key=lambda i: -scores[i])
    kept = []
    for i in order:
        b = boxes[i]
        area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
        ok = True
        for k in kept:
            c = boxes[k]
            inter = (max(min(b[2], c[2]) - max(b[0], c[0]), 0.0)
                     * max(min(b[3], c[3]) - max(b[1], c[1]), 0.0))
            denom = min(area_b, max(c[2] - c[0], 0.0) * max(c[3] - c[1], 0.0))
            if denom > 0 and inter / denom > thresh:
                ok = False
                break
        if ok:
            kept.append(i)
    return kept


def decode(cfg, prob, rois) -> list:
    """The reference decode of one frame: [R, 81] float32 and [R, 4] ->
    [n, 7] float64 rows (x1, y1, x2, y2, score, label, RoI), as stored
    (float32 values)."""
    label = np.argmax(prob[:, 1:], axis=1) + 1
    score = prob[np.arange(len(prob)), label]
    rows = np.flatnonzero(score.astype(np.float64) > cfg["score_thresh"])
    boxes = [[float(v) for v in rois[j]] for j in rows]
    kept = nms_min(boxes, [float(score[j]) for j in rows], cfg["nms_thresh"])
    out = [[*boxes[k], float(score[rows[k]]), float(label[rows[k]]),
            float(rows[k])] for k in kept]
    return np.asarray(out, np.float64).reshape(-1, 7)


def detections(cfg, prob, rois) -> list:
    prob, rois = prob.cpu().numpy(), rois.cpu().numpy()
    return [decode(cfg, prob[i], rois[i]) for i in range(len(prob))]


# --------------------------------------------------------- calibration

def _standardised(d):
    """[N, C] float64 -> (mean [C], spread [C])."""
    return d.mean(dim=0), d.std(dim=0) + 1e-12


def build(cfg: dict, traffic: dict, pool_u8, gen, device) -> dict:
    """The weights from ``gen``, then the heads, over the pool's first
    ``calibration_frames`` frames at the test size:

      * the RPN: each anchor's fg - bg logit given the spread
        ``heads.rpn.scale`` and mean 0, plus ``heads.rpn.small_shift`` on
        the smallest scale's anchors (so that the pool and the 300
        proposals kept are mostly small boxes: the reference decode's
        "min" NMS keeps few boxes that hold others), and each delta mean 0
        and spread ``heads.rpn.reg_std``;
      * the classes: each class logit over the proposals kept given the
        spread ``heads.cls.scale`` and mean 0, and the background a shift
        that gives ``heads.cls.detections_per_frame`` stored detections a
        frame over those frames (the same work for every seed)."""
    p = draw(spec(cfg), gen, device)
    n = traffic["calibration_frames"]
    heads = traffic["heads"]
    with torch.no_grad():
        x = prepare(pool_u8[:n].to(device), cfg)
        feat, _, _, rpn = trunk(p, x)
        flat = rpn.permute(0, 2, 3, 1).reshape(-1, 512)

        # the RPN's two heads, from their inputs' statistics
        w = p["rpn_cls_score.weight"].reshape(2 * N_ANCHORS, 512)
        bias = p["rpn_cls_score.bias"]
        dw = w[N_ANCHORS:] - w[:N_ANCHORS]
        db = bias[N_ANCHORS:] - bias[:N_ANCHORS]
        mu, sd = _standardised((flat @ dw.T + db).double())
        rh = heads["rpn"]
        k = (rh["scale"] / sd).float()
        shift = torch.tensor([rh["small_shift"] if s == ANCHOR_SCALES[0]
                              else 0.0 for _ in ANCHOR_RATIOS
                              for s in ANCHOR_SCALES], device=device)
        nw, nb = torch.zeros_like(w), torch.zeros_like(bias)
        nw[N_ANCHORS:] = dw * k[:, None]
        nb[N_ANCHORS:] = (db - mu.float()) * k + shift
        p["rpn_cls_score.weight"] = nw.reshape(2 * N_ANCHORS, 512, 1, 1) \
            .contiguous()
        p["rpn_cls_score.bias"] = nb.contiguous()
        w = p["rpn_bbox_pred.weight"].reshape(4 * N_ANCHORS, 512)
        mu, sd = _standardised((flat @ w.T + p["rpn_bbox_pred.bias"])
                               .double())
        k = (rh["reg_std"] / sd).float()
        p["rpn_bbox_pred.weight"] = (w * k[:, None]).reshape(
            4 * N_ANCHORS, 512, 1, 1).contiguous()
        p["rpn_bbox_pred.bias"] = ((p["rpn_bbox_pred.bias"] - mu.float())
                                   * k).contiguous()

        # the proposals with those heads, and fc7 on them
        boxes, valid, _ = proposals(cfg, rpn_heads(p, rpn, "rpn_cls_score"),
                                    rpn_heads(p, rpn, "rpn_bbox_pred"),
                                    x.shape[1], x.shape[2])
        _, fc7, _ = roi_head(p, feat, boxes, valid)
        fv = fc7[valid]
        w, bias = p["cls_score.weight"], p["cls_score.bias"]
        mu, sd = _standardised((fv @ w.T + bias).double())
        ch = heads["cls"]
        k = (ch["scale"] / sd).float()
        w = w * k[:, None]
        base = (bias - mu.float()) * k
        rois = torch.where(valid[..., None], boxes, 0.0)

        def per_frame(shift):
            b = base.clone()
            b[0] += shift
            prob = torch.softmax(fc7 @ w.T + b, dim=-1)
            prob = torch.where(valid[..., None], prob,
                               F.one_hot(torch.zeros_like(valid, dtype=torch
                                                          .int64),
                                         NUM_CLASSES).float())
            return sum(len(d) for d in detections(cfg, prob, rois)) / n

        # more background, fewer detections
        lo, hi = -ch["scale"] * 4.0, ch["scale"] * 4.0
        for _ in range(16):
            mid = (lo + hi) / 2
            if per_frame(mid) > ch["detections_per_frame"]:
                lo = mid
            else:
                hi = mid
        base[0] += (lo + hi) / 2
        p["cls_score.weight"] = w.contiguous()
        p["cls_score.bias"] = base.contiguous()
    return p


# -------------------------------------------------------- rows and checks

def parse(column: str, data: bytes):
    """A stored box list -> [n, 7] float64 rows (x1, y1, x2, y2, score,
    label, RoI)."""
    rows, off = [], 0
    while off < len(data):
        (n,) = struct.unpack_from("<i", data, off)
        rows.append(struct.unpack_from("<5f2i", data, off + 4))
        off += 4 + n
    return np.asarray(rows, np.float64).reshape(-1, 7)


def reference(cfg, p, frames_u8, rows, bounds: bool = False) -> dict:
    """One packet's detections -> {"frames": [{"detections": [n, 7]}] a
    frame, "calls": {"nms": [ms], "crop": [ms]}}: the bounds of the
    program's one ``nms`` call ([T, pre_nms] -> R) and one crop call
    (every row of the packet, the rows not kept as zero boxes)."""
    calls = {"scores": [], "crop": []} if bounds else None
    with torch.no_grad():
        prob, rois, _, _ = forward(cfg, p, frames_u8, calls)
        dets = detections(cfg, prob, rois)
        out = {"nms": [], "crop": []}
        if bounds:
            scores = torch.cat(calls["scores"])
            out["nms"].append(roofline.nms_bound(scores, cfg["num_rois"]))
            shape = calls["crop"][0][0]
            boxes = torch.cat([c[1] for c in calls["crop"]])
            fi = torch.cat([c[2] for c in calls["crop"]])
            out["crop"].append(roofline.crop_bound(
                frames_u8.shape[0], shape[1], shape[2], shape[3], boxes, fi,
                POOL, POOL))
    return {"frames": [{"detections": d} for d in dets], "calls": out}


def _iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def compare(cfg, got: list, want: list, size) -> dict:
    """The program's stored detections against the reference's, frame by
    frame -> {"det_miss": detections on one side only over the
    reference's, "box_gap_px": widest coordinate gap of a matched pair in
    input pixels, "score_gap": widest score gap}. Pairs: the same label,
    greedy by IoU (at least 0.5), best first."""
    missed = n_ref = 0
    box_gap = score_gap = 0.0
    for g, r in zip(got, want):
        gd, rd = g["detections"], r["detections"]
        n_ref += len(rd)
        cand = sorted(((_iou(gd[i], rd[j]), i, j) for i in range(len(gd))
                       for j in range(len(rd)) if gd[i, 5] == rd[j, 5]),
                      reverse=True)
        ua, ub = set(), set()
        for iou, i, j in cand:
            if iou < 0.5:
                break
            if i in ua or j in ub:
                continue
            ua.add(i)
            ub.add(j)
            box_gap = max(box_gap, float(np.max(np.abs(gd[i, :4]
                                                       - rd[j, :4]))))
            score_gap = max(score_gap, float(abs(gd[i, 4] - rd[j, 4])))
        missed += len(gd) + len(rd) - 2 * len(ua)
    return {"det_miss": missed / max(n_ref, 1), "box_gap_px": box_gap,
            "score_gap": score_gap, "detections_compared": n_ref}


# ------------------------------------------------------------------ work

def flops_per_part(cfg, h: int, w: int) -> dict:
    """Float32 operations (2 a multiply-add) counted on meta tensors from
    the shapes alone: the trunk and the RPN a frame at the test size, the
    head (fc6, fc7, cls_score) a proposal."""
    meta = torch.device("meta")
    p = {key: torch.empty(shape, device=meta)
         for key, shape, _, _ in spec(cfg)}
    th, tw = scaled_size(h, w, cfg)
    with plain.count_flops() as n:
        trunk(p, torch.empty((1, th, tw, 3), device=meta))
    out = {"trunk": n[0]}
    with plain.count_flops() as n:
        h6 = linear(torch.empty((1, POOL * POOL * FEAT), device=meta),
                    p["fc6.weight"])
        linear(linear(h6, p["fc7.weight"]), p["cls_score.weight"])
    out["head"] = n[0]
    return out


def proposals_kept(cfg, p, frames_u8) -> np.ndarray:
    """[T] the proposals the NMS keeps a frame, as this reference finds
    them."""
    out = []
    with torch.no_grad():
        for a in range(0, len(frames_u8), BLOCK):
            x = prepare(torch.as_tensor(frames_u8[a:a + BLOCK]).to(
                p["fc6.weight"].device), cfg)
            _, logits, deltas, _ = trunk(p, x)
            _, valid, _ = proposals(cfg, logits, deltas, x.shape[1],
                                    x.shape[2])
            out.append(valid.sum(dim=1).cpu().numpy())
    return np.concatenate(out)


def flops(cfg, p, pool_u8, idx, rows: list) -> float:
    """The work the stored frames ``rows`` (pool frames ``idx``) needed:
    the trunk and the RPN on each, the head on each proposal kept; never a
    padded row."""
    _, h, w, _ = pool_u8.shape
    per = flops_per_part(cfg, h, w)
    used = np.unique(idx)
    kept = proposals_kept(cfg, p, pool_u8[used])
    at = {int(f): i for i, f in enumerate(used)}
    n_kept = int(sum(kept[at[int(f)]] for f in idx))
    return float(per["trunk"] * len(rows) + per["head"] * n_kept)
