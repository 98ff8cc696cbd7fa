"""The pose_detection configuration: CMU's COCO body model (Cao et al. 2017,
at CVPR; pose/coco/pose_deploy_linevec.prototxt: the VGG-19 front, the CPM
feature layers, 6 two-branch stages of 128 channels, 38 PAF and 19 heat
maps), at one scale with linear upsampling, in plain PyTorch and NumPy,
float32, no kernels of the program.

The post-processing follows the program's stated semantics (the JAX
package's): the maps resized to the frame as ``jax.image.resize`` does,
peaks as 3x3 local maxima above 0.1 (the top 24 of each part, stable
order), the 10-sample PAF line integrals, and CPM2Output's greedy
grouping (``group_people``, a transcription of connect_limbs_coco).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import plain, roofline
from ..plain import conv2d, div

N_PARTS, N_HEAT, N_PAF, N_LIMBS = 18, 19, 38, 19
MAX_PEAKS, MAX_PEOPLE = 24, 96
THRE_PEAK, THRE_PAF, MIN_SAMPLES, N_SAMPLES = 0.10, 0.05, 9, 10
LIMB_SEQ = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
    (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
    (0, 15), (15, 17), (2, 16), (5, 17),
]
PAF_IDX = [
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
]
KP = 18 + 70 + 2 * 21  # keypoints a stored person

_VGG = [("conv1_1", 64, False), ("conv1_2", 64, True),
        ("conv2_1", 128, False), ("conv2_2", 128, True),
        ("conv3_1", 256, False), ("conv3_2", 256, False),
        ("conv3_3", 256, False), ("conv3_4", 256, True),
        ("conv4_1", 512, False), ("conv4_2", 512, False)]


def _layers(stages: int):
    """(caffe layer, cin, cout, k, flax prefix, bare) of the body net."""
    out, cin = [], 3
    for i, (name, f, _) in enumerate(_VGG):
        out.append((name, cin, f, 3, f"vgg{i}", False))
        cin = f
    out.append(("conv4_3_CPM", 512, 256, 3, "cpm0", False))
    out.append(("conv4_4_CPM", 256, 128, 3, "cpm1", False))
    for tag, n in (("L1", N_PAF), ("L2", N_HEAT)):
        for j in range(3):
            out.append((f"conv5_{j + 1}_CPM_{tag}", 128, 128, 3,
                        f"s0_{tag}_{j}", False))
        out.append((f"conv5_4_CPM_{tag}", 128, 512, 1, f"s0_{tag}_3", False))
        out.append((f"conv5_5_CPM_{tag}", 512, n, 1, f"s0_{tag}_4", True))
        for s in range(2, stages + 1):
            for j in range(1, 6):
                out.append((f"Mconv{j}_stage{s}_{tag}",
                            N_PAF + N_HEAT + 128 if j == 1 else 128, 128, 7,
                            f"s{s - 1}_{tag}_{j - 1}", False))
            out.append((f"Mconv6_stage{s}_{tag}", 128, 128, 1,
                        f"s{s - 1}_{tag}_5", False))
            out.append((f"Mconv7_stage{s}_{tag}", 128, n, 1,
                        f"s{s - 1}_{tag}_6", True))
    return out


def spec(cfg):
    """(torch key, shape, flax path, kind) of every leaf."""
    out = []
    for name, cin, cout, k, fp, bare in _layers(cfg["stages"]):
        base = fp if bare else f"{fp}/conv"
        out.append((f"{name}.weight", (cout, cin, k, k),
                    f"params/{base}/kernel", "conv"))
        out.append((f"{name}.bias", (cout,), f"params/{base}/bias", "bias"))
    return out


def draw(leaves, gen, device) -> dict:
    """He-normal kernels and small biases, from one normal draw."""
    sizes = [int(np.prod(s)) for _, s, _, _ in leaves]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, _, kind), n in zip(leaves, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if kind == "conv":
            v = v * float(np.sqrt(2.0 / np.prod(shape[1:])))
        else:
            v = 0.05 * v
        out[key] = v.contiguous()
    return out


def write_weights(state: dict, directory: str, cfg) -> dict:
    path = os.path.join(directory, "openpose.npz")
    flat = {}
    for key, _, fpath, kind in spec(cfg):
        a = state[key].float().cpu().numpy()
        flat[fpath] = np.ascontiguousarray(
            a.transpose(2, 3, 1, 0) if kind == "conv" else a, np.float32)
    np.savez(path, **flat)
    return {"openpose": path}


# ------------------------------------------------------------------ net

def body(p, x, stages: int):
    """x [B, 3, H, W] in [-0.5, 0.5] -> (heat [B, 19, H/8, W/8], paf [B,
    38, H/8, W/8])."""
    def c(x, name, k):
        return conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], 1, k // 2)

    for name, _, pool in _VGG:
        x = torch.relu(c(x, name, 3))
        if pool:
            x = F.max_pool2d(x, 2, 2)
    x = torch.relu(c(x, "conv4_3_CPM", 3))
    feat = torch.relu(c(x, "conv4_4_CPM", 3))

    def branch(h, stage, tag):
        if stage == 1:
            for j in range(1, 5):
                h = torch.relu(c(h, f"conv5_{j}_CPM_{tag}", 3 if j < 4 else 1))
            return c(h, f"conv5_5_CPM_{tag}", 1)
        for j in range(1, 7):
            h = torch.relu(c(h, f"Mconv{j}_stage{stage}_{tag}",
                             7 if j < 6 else 1))
        return c(h, f"Mconv7_stage{stage}_{tag}", 1)

    paf, heat = branch(feat, 1, "L1"), branch(feat, 1, "L2")
    for s in range(2, stages + 1):
        inp = torch.cat([paf, heat, feat], dim=1)
        paf, heat = branch(inp, s, "L1"), branch(inp, s, "L2")
    return heat, paf


def _input(frames_u8):
    """[T, H, W, 3] uint8 -> NCHW in [-0.5, 0.5], padded to a multiple of
    8 with zeros."""
    x = frames_u8.float()
    _, h, w, _ = x.shape
    x = F.pad(x, (0, 0, 0, (-w) % 8, 0, (-h) % 8))
    return (div(x, 256.0) - 0.5).permute(0, 3, 1, 2).contiguous()


# --------------------------------------------------------- calibration

def _bisect(count, target: float, lo: float, hi: float, steps: int = 18):
    """The shift in [lo, hi] at which ``count(shift)``, rising with it,
    comes nearest ``target``."""
    for _ in range(steps):
        mid = (lo + hi) / 2
        if count(mid) < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def build(cfg: dict, traffic: dict, pool_u8, gen, device) -> dict:
    """The weights from ``gen``, the last stage's two output layers set so
    that each heat and PAF channel, over the first frames of the pool at
    the net's resolution, has the spread the traffic states, and a mean
    that the traffic states or that gives its peaks and people a frame
    over those frames (the same work for every seed)."""
    stages = cfg["stages"]
    p = draw(spec(cfg), gen, device)
    n = traffic["calibration_frames"]
    heads = traffic["heads"]
    with torch.no_grad():
        x = _input(pool_u8[:n].to(device))
        heat, paf = body(p, x, stages)
    hp, wp = x.shape[2:]
    z = {}
    for maps, tag in ((paf, "L1"), (heat, "L2")):
        flat = maps.transpose(0, 1).reshape(maps.shape[1], -1).double()
        mu, sd = flat.mean(dim=1), flat.std(dim=1) + 1e-12
        z[tag] = (mu, sd, ((maps.double() - mu.view(1, -1, 1, 1))
                           / sd.view(1, -1, 1, 1)).float())

    def maps_at(tag, head, shift):
        return plain.resize_hw(z[tag][2] * head["scale"] + shift, 2, hp, wp,
                               "linear").contiguous()

    hh = heads["heat"]
    if "peaks_per_frame" in hh:
        hh = dict(hh, shift=_bisect(
            lambda m: float(find_peaks(maps_at("L2", hh, m))[1].sum()) / n,
            hh["peaks_per_frame"], -4.0 * hh["scale"], 0.1))
    ph = heads["paf"]
    if "people_per_frame" in ph:
        peaks, valid = find_peaks(maps_at("L2", hh, hh["shift"]))
        pk, vd = peaks.cpu().numpy(), valid.cpu().numpy()

        def people(m):
            sc = limb_scores(maps_at("L1", ph, m), peaks, valid).cpu().numpy()
            return sum(len(group_people(pk[i], vd[i], sc[i]))
                       for i in range(n)) / n
        ph = dict(ph, shift=_bisect(people, ph["people_per_frame"], 0.0, 3.0,
                                    steps=10))
    for tag, head in (("L1", ph), ("L2", hh)):
        mu, sd, _ = z[tag]
        a = (head["scale"] / sd).float()
        key = f"Mconv7_stage{stages}_{tag}"
        p[f"{key}.weight"] = (p[f"{key}.weight"] * a.view(-1, 1, 1, 1)
                              ).contiguous()
        p[f"{key}.bias"] = ((p[f"{key}.bias"] - mu.float()) * a
                            + head["shift"]).contiguous()
    return p


# ------------------------------------------------------- post-processing

def find_peaks(heat):
    t, _, h, w = heat.shape
    hm = heat[:, :N_PARTS]
    pad = F.pad(hm, (1, 1, 1, 1), value=-1.0)
    is_max = torch.ones_like(hm, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                is_max &= hm >= pad[:, :, 1 + dy:1 + dy + h,
                                    1 + dx:1 + dx + w]
    score = torch.where(is_max & (hm > plain.f32(THRE_PEAK)), hm, -1.0)
    top, idx = plain.topk_stable(score.reshape(t, N_PARTS, h * w), MAX_PEAKS)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    return torch.stack([xs, ys, top], dim=-1), top > 0


def limb_scores(paf, peaks, valid):
    """[T, L, K, K] mean PAF line integrals, -inf where infeasible (10
    samples from A towards B, each position one rounding of a + d * t)."""
    t, _, h, w = paf.shape
    dev = paf.device
    a_idx, b_idx, cx_idx, cy_idx = (torch.tensor(col, dtype=torch.int64,
                                                 device=dev)
                                    for col in (*zip(*LIMB_SEQ),
                                                *zip(*PAF_IDX)))
    pa, pb = peaks[:, a_idx], peaks[:, b_idx]
    va, vb = valid[:, a_idx], valid[:, b_idx]
    ax, ay = pa[..., :, None, 0], pa[..., :, None, 1]
    bx, by = pb[..., None, :, 0], pb[..., None, :, 1]
    dx, dy = bx - ax, by - ay
    raw_norm = torch.sqrt(dx * dx + dy * dy)
    norm = raw_norm + plain.f32(1e-8)
    ux, uy = dx / norm, dy / norm
    ts = div(torch.arange(N_SAMPLES, dtype=torch.float32, device=dev),
             N_SAMPLES).double()
    sx = (ax.double()[..., None] + dx.double()[..., None] * ts).float()
    sy = (ay.double()[..., None] + dy.double()[..., None] * ts).float()
    xi = torch.clamp(torch.floor(sx + 0.5), 0, w - 1).to(torch.int64)
    yi = torch.clamp(torch.floor(sy + 0.5), 0, h - 1).to(torch.int64)
    lin = yi * w + xi
    frame = torch.arange(t, device=dev)[:, None] * N_PAF
    shape = (t, N_LIMBS, 1, 1, 1)
    flat = paf.reshape(-1)
    fx = flat[((frame + cx_idx) * (h * w)).view(shape) + lin]
    fy = flat[((frame + cy_idx) * (h * w)).view(shape) + lin]
    dots = fx * ux[..., None] + fy * uy[..., None]
    n_good = (dots > plain.f32(THRE_PAF)).sum(dim=-1)
    feasible = ((n_good > MIN_SAMPLES) & (raw_norm > plain.f32(1e-6))
                & va[..., :, None] & vb[..., None, :])
    return torch.where(feasible, plain.mean(dots, (4,)), float("-inf"))


def group_people(peaks, valid, scores):
    """CPM2Output's greedy limb assignment and subset pruning -> [(score /
    cnt, kp [18, 3])]."""
    K = peaks.shape[1]
    subsets = []
    for l, (pa, pb) in enumerate(LIMB_SEQ):
        va_idx = [i for i in range(K) if valid[pa, i]]
        vb_idx = [j for j in range(K) if valid[pb, j]]
        if not va_idx and not vb_idx:
            continue
        if not va_idx or not vb_idx:
            part, idxs = (pb, vb_idx) if not va_idx else (pa, va_idx)
            for i in idxs:
                if not any(ss["parts"].get(part) == i for ss in subsets):
                    subsets.append({"parts": {part: i}, "cnt": 1,
                                    "score": float(peaks[part, i, 2])})
            continue
        s = scores[l]
        cands = [(float(s[i, j]), i, j) for i in va_idx for j in vb_idx
                 if np.isfinite(s[i, j])]
        cands.sort(key=lambda c: -c[0])
        num = min(len(va_idx), len(vb_idx))
        occ_a, occ_b, conns = set(), set(), []
        for sc, i, j in cands:
            if len(conns) == num:
                break
            if i in occ_a or j in occ_b:
                continue
            conns.append((i, j, sc))
            occ_a.add(i)
            occ_b.add(j)
        for i, j, sc in conns:
            found = 0
            if l:
                for ss in subsets:
                    if ss["parts"].get(pa) == i:
                        ss["parts"][pb] = j
                        ss["cnt"] += 1
                        ss["score"] += float(peaks[pb, j, 2]) + sc
                        found += 1
            if found == 0:
                subsets.append({"parts": {pa: i, pb: j}, "cnt": 2,
                                "score": float(peaks[pa, i, 2]
                                               + peaks[pb, j, 2]) + sc})
    people = []
    for ss in subsets:
        cnt = ss["cnt"]
        if cnt < 3 or ss["score"] / cnt <= 0.4:
            continue
        kp = np.zeros((N_PARTS, 3), np.float32)
        for part, pk in ss["parts"].items():
            kp[part] = peaks[part, pk]
        people.append((float(ss["score"] / cnt), kp))
        if len(people) == MAX_PEOPLE:
            break
    return people


# -------------------------------------------------------- rows and checks

def parse(column: str, data: bytes):
    """A stored pose list -> [n, 1 + 18 * 3]: each person's score and body
    keypoints (x / W, y / H, score)."""
    a = np.frombuffer(data, np.float32).reshape(-1, 1 + KP * 3)
    return np.concatenate([a[:, :1], a[:, 1:1 + N_PARTS * 3]], axis=1)


def reference(cfg, p, frames_u8, rows, bounds: bool = False) -> dict:
    """One packet's people -> {"frames": [{"poses": [n, 55]}] a frame,
    "calls": {"peaks": [ms]}}."""
    t, h, w, _ = frames_u8.shape
    with torch.no_grad():
        x = _input(frames_u8)
        heat, paf = body(p, x, cfg["stages"])
        _, _, hp, wp = x.shape
        heat = plain.resize_hw(heat, 2, hp, wp, "linear").contiguous()
        paf = plain.resize_hw(paf, 2, hp, wp, "linear")
        peaks, valid = find_peaks(heat)
        scores = limb_scores(paf, peaks, valid)
        calls = [roofline.peaks_bound(heat, N_PARTS, MAX_PEAKS, THRE_PEAK)] \
            if bounds else []
    peaks, valid, scores = (a.cpu().numpy() for a in (peaks, valid, scores))
    poses = []
    for i in range(t):
        rows_i = []
        for score, kp in group_people(peaks[i], valid[i], scores[i]):
            body_kp = kp.copy()
            body_kp[:, 0] /= w
            body_kp[:, 1] /= h
            rows_i.append(np.concatenate([[score], body_kp.reshape(-1)]))
        poses.append({"poses": np.asarray(rows_i, np.float32).reshape(
            -1, 1 + 54)})
    return {"frames": poses, "calls": {"peaks": calls}}


def _parts(person, h: int, w: int) -> dict:
    kp = person[1:].reshape(N_PARTS, 3)
    return {k: (float(kp[k, 0]) * w, float(kp[k, 1]) * h, float(kp[k, 2]))
            for k in range(N_PARTS) if kp[k, 2] > 0}


def compare(cfg, got: list, want: list, size) -> dict:
    """{"person_miss": people in one and not the other over the reference's
    people, "part_miss": parts of matched people on one side only over
    the reference's parts, "kp_gap_px": widest keypoint gap of a part on
    both sides in pixels, "score_gap": widest person-score gap}. People
    pair greedily by the parts they share at the same pixel."""
    h, w = size
    p_miss = part_miss = n_ref = n_parts = 0
    kp_gap = score_gap = 0.0
    for g, r in zip(got, want):
        gp = [_parts(x, h, w) for x in g["poses"]]
        rp = [_parts(x, h, w) for x in r["poses"]]
        n_ref += len(rp)
        n_parts += sum(len(x) for x in rp)
        cand = []
        for i, a in enumerate(gp):
            for j, b in enumerate(rp):
                same = sum(1 for k in a if k in b and abs(a[k][0] - b[k][0])
                           < 1.5 and abs(a[k][1] - b[k][1]) < 1.5)
                if same * 2 >= max(len(a), len(b)):
                    cand.append((same, i, j))
        cand.sort(reverse=True)
        ua, ub, pairs = set(), set(), []
        for _, i, j in cand:
            if i not in ua and j not in ub:
                ua.add(i)
                ub.add(j)
                pairs.append((i, j))
        p_miss += len(gp) + len(rp) - 2 * len(pairs)
        for i, j in pairs:
            a, b = gp[i], rp[j]
            part_miss += len(set(a) ^ set(b))
            for k in set(a) & set(b):
                kp_gap = max(kp_gap, float(np.hypot(a[k][0] - b[k][0],
                                                    a[k][1] - b[k][1])))
            score_gap = max(score_gap, float(abs(g["poses"][i][0]
                                                 - r["poses"][j][0])))
    return {"person_miss": p_miss / max(n_ref, 1),
            "part_miss": part_miss / max(n_parts, 1),
            "kp_gap_px": kp_gap, "score_gap": score_gap,
            "people_compared": n_ref}


# ------------------------------------------------------------------ work

def flops(cfg, p, pool_u8, idx, rows: list) -> float:
    """The body net's float32 operations over the stored frames, counted
    on meta tensors at the padded frame size; it does the same work on
    every frame."""
    _, h, w, _ = pool_u8.shape
    meta = torch.device("meta")
    shapes = {key: torch.empty(shape, device=meta)
              for key, shape, _, _ in spec(cfg)}
    with plain.count_flops() as n:
        body(shapes, torch.empty((1, 3, h + (-h) % 8, w + (-w) % 8),
                                 device=meta), cfg["stages"])
    return float(n[0] * len(rows))
