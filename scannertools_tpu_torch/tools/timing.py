"""Timing and inputs shared by the port's chip scripts (``chip_smoke.py``
and the tools beside this file) and its tests.

It imports nothing of the package, so that ``kernel_compare.py``, which
imports the package from another checkout, can import it by path.
"""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

# A spin of this many card cycles (about 0.5 ms) before the start event
# keeps the card busy while the host prepares the timed call.
FENCE_CYCLES = 1_000_000


def time_ms(fn, reps: int = 20, warm: int = 3, fence: bool = False) -> float:
    """Median of ``reps`` single calls, each timed with CUDA events. With
    ``fence`` the card spins before the start event, so the host's work in
    ``fn`` overlaps the spin and only the device's time of the call is
    measured; without it the card waits for the host inside the window."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if fence:
            torch.cuda._sleep(FENCE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def hist_frames(kind: str, fmt: str, t: int, h: int, w: int):
    """[t, bytes] u8 on the card: random, or one flat colour (RGB
    (200, 40, 40); the same red as limited-range BT.601 Y, U, V)."""
    n = h * w * 3 if fmt == "rgb" else h * w * 3 // 2
    if kind == "random":
        gen = torch.Generator(device="cuda").manual_seed(0)
        return torch.randint(0, 256, (t, n), dtype=torch.uint8,
                             device="cuda", generator=gen)
    x = torch.empty((t, n), dtype=torch.uint8, device="cuda")
    if fmt == "rgb":
        x.view(t, h * w, 3).copy_(torch.tensor([200, 40, 40],
                                               dtype=torch.uint8))
    else:
        x[:, :h * w] = 81
        x[:, h * w:h * w * 5 // 4] = 90
        x[:, h * w * 5 // 4:] = 240
    return x


def blob_maps(t: int, c: int, h: int, w: int, seed: int = 0,
              blobs: int = 15, sigma: float = 7.0, peak: float = 0.9,
              device="cuda"):
    """[t, c, h, w] float32 heat maps of a trained net's density: in each
    channel the largest of ``blobs`` Gaussians of ``sigma`` px and height
    ``peak`` at seeded whole-pixel centres, so each centre is a peak of
    exactly ``peak`` (at 480x640, 15 blobs of 7 px put about 3% of the
    pixels above 0.1)."""
    rng = np.random.default_rng(seed)
    cy, cx = (torch.from_numpy(rng.integers(0, n, (t, c, blobs)).astype(
        np.float32)).to(device) for n in (h, w))
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    out = torch.zeros((t, c, h, w), device=device)
    for b in range(blobs):
        gy = torch.exp(-(ys - cy[..., b, None]) ** 2 / (2 * sigma ** 2))
        gx = torch.exp(-(xs - cx[..., b, None]) ** 2 / (2 * sigma ** 2))
        out = torch.maximum(out, peak * gy[..., :, None] * gx[..., None, :])
    return out


def band_edge_maps(case: str, t: int, h: int, w: int, cluster: int = 8):
    """[t, 19, h, w] float32 numpy maps at the edges of pose_peaks' row
    bands (a band is ceil(h / cluster) rows): a peak on a band's last row
    whose larger neighbour lies on the next band's first row (or the
    reverse) for ``case`` "edge", a plateau across the edge for
    "plateau", each at columns on both sides of a 32- and a 128-column
    strip edge."""
    band = -(-h // cluster)
    hm = np.zeros((t, 19, h, w), np.float32)
    for part in range(18):
        e = band * (1 + part % 7)  # the first row of band 1 + part % 7
        if e >= h:
            continue
        for x in sorted({3, 31, 32, 127, 128, w - 2} & set(range(1, w - 1))):
            if case == "plateau":
                hm[:, part, e - 2:e + 2, x - 1:x + 2] = 0.4
            elif part % 2:
                hm[:, part, e - 1, x] = 0.5
                hm[:, part, e, x + part % 3 - 1] = 0.6
            else:
                hm[:, part, e - 1, x] = 0.6
                hm[:, part, e, x + part % 3 - 1] = 0.5
    return hm


def peaks_yardstick(heat, parts: int, thre: float, k: int):
    """The library yardstick of find_peaks: ``F.max_pool2d`` (3x3, stride
    1, pad 1), a ``where``, ``torch.topk`` over each of the first ``parts``
    maps. ``hm == max_pool2d(hm)`` is "``>=`` every neighbour", so it finds
    the same peaks, but ``torch.topk`` keeps neither ``top_k``'s order
    among ties nor its fill slots: not the same function. -> the call,
    which returns (scores [T, parts, k], flat indices)."""
    hm = heat[:, :parts]

    def call():
        is_max = hm == F.max_pool2d(hm, 3, 1, 1)
        score = torch.where(is_max & (hm > thre), hm, -1.0)
        return torch.topk(score.flatten(2), k)

    return call


def yardstick_agrees(top, peaks, valid, w: int) -> bool:
    """Whether the yardstick's valid slots (``top``: scores, indices) hold
    the kernel's peaks: the same scores in every map, and the same indices
    in every map with fewer than k peaks (with k or more, ``torch.topk``
    may pick other peaks among those tied with the k-th)."""
    vals, idx = top
    got = torch.where(valid, peaks[..., 2], 0.0)
    if not torch.equal(torch.sort(vals.clamp(min=0), -1)[0],
                       torch.sort(got, -1)[0]):
        return False
    few = valid.sum(-1) < valid.shape[-1]
    flat = (peaks[..., 1] * w + peaks[..., 0]).long()
    mine = torch.sort(torch.where(valid, flat, -1), -1)[0]
    theirs = torch.sort(torch.where(vals > 0, idx, -1), -1)[0]
    return bool((mine == theirs)[few].all())


def box_cloud(rng, t: int, k: int, span: float = 600.0, lo: float = 8.0,
              hi: float = 120.0):
    """[t, k, 4] float32 pixel boxes of lo-hi px around seeded centres in
    [0, span)."""
    c = rng.uniform(0, span, (t, k, 2))
    wh = rng.uniform(lo, hi, (t, k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=-1).astype(
        np.float32)


def grid_sample_crops(images, boxes, oh: int, ow: int, sample_positions):
    """The library yardstick of crop_and_resize: ``F.grid_sample``
    (bilinear, align_corners=True) at the crops' clamped sample positions
    (``sample_positions(lo, hi, n_out, size)``, the port's
    ``models.common._sample_positions``), for K boxes a frame in frame order
    (boxes [T, K, 4]) -> (the crops [T * K, oh, ow, C], the call alone)."""
    t, h, w, c = images.shape
    k = boxes.shape[1]
    flat = boxes.reshape(t * k, 4)
    ys = sample_positions(flat[:, 1], flat[:, 3], oh, h)
    xs = sample_positions(flat[:, 0], flat[:, 2], ow, w)
    gy = (ys / (h - 1) * 2 - 1)[:, :, None].expand(t * k, oh, ow)
    gx = (xs / (w - 1) * 2 - 1)[:, None, :].expand(t * k, oh, ow)
    grid = torch.stack([gx, gy], dim=-1).reshape(t, k * oh, ow, 2)
    inp = images.permute(0, 3, 1, 2).contiguous()

    def call():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    out = call().reshape(t, c, k, oh, ow).permute(0, 2, 3, 4, 1)
    return out.reshape(t * k, oh, ow, c), call


def grid_sample_level_crops(maps, boxes, level, frame_idx, oh: int, ow: int,
                            sample_positions, strides):
    """The library yardstick of crop_and_resize_levels: one
    ``F.grid_sample`` a level over that level's boxes (scaled by its
    stride), each frame's boxes side by side in the grid's rows, at the
    crops' clamped sample positions -> (the crops [B, oh, ow, C] in the
    boxes' order, gathered from the calls' outputs; the calls alone, four
    for four levels)."""
    t, c = maps[0].shape[0], maps[0].shape[3]
    calls, slots = [], []
    for lvl, (m, stride) in enumerate(zip(maps, strides)):
        sel = torch.nonzero(level == lvl).squeeze(1)
        if not sel.numel():
            continue
        h, w = m.shape[1:3]
        b, f = boxes[sel] / stride, frame_idx[sel]
        # each box's place among its frame's boxes of this level
        counts = torch.bincount(f, minlength=t)
        order = torch.argsort(f, stable=True)
        slot = torch.empty_like(f)
        slot[order] = torch.arange(len(f), device=f.device) - (
            torch.cumsum(counts, 0) - counts)[f[order]]
        k = int(counts.max())
        ys = sample_positions(b[:, 1], b[:, 3], oh, h)
        xs = sample_positions(b[:, 0], b[:, 2], ow, w)
        grid = torch.zeros((t, k, oh, ow, 2), device=b.device)
        grid[f, slot] = torch.stack(
            [(xs / max(w - 1, 1) * 2 - 1)[:, None, :].expand(-1, oh, ow),
             (ys / max(h - 1, 1) * 2 - 1)[:, :, None].expand(-1, oh, ow)],
            dim=-1)
        calls.append((m.permute(0, 3, 1, 2).contiguous(),
                      grid.reshape(t, k * oh, ow, 2)))
        slots.append((sel, f, slot, k))

    def call():
        return [F.grid_sample(inp, grid, mode="bilinear",
                              padding_mode="border", align_corners=True)
                for inp, grid in calls]

    crops = torch.empty((boxes.shape[0], oh, ow, c), device=boxes.device)
    for (sel, f, slot, k), out in zip(slots, call()):
        crops[sel] = out.reshape(t, c, k, oh, ow).permute(
            0, 2, 3, 4, 1)[f, slot]
    return crops, call


def level_boxes(rng, t: int, k: int, canvas, lo: float = 2.0,
                hi: float = 1100.0):
    """[t * k, 4] float32 canvas boxes, sides log-uniform in [lo, hi] (so
    that the canonical heuristic puts them on every FPN level), some past
    the canvas's edges and every 9th a zero box, with their frame indices
    [t * k] int64 (frame-major)."""
    h, w = canvas
    xy = rng.uniform(-0.05, 1.0, (t * k, 2)) * (w, h)
    wh = np.exp(rng.uniform(np.log(lo), np.log(hi), (t * k, 2)))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[::9] = 0.0
    return boxes, np.repeat(np.arange(t), k).astype(np.int64)


def planted_emissions(rng, tokens, t: int, v: int, blank: int = 0,
                      gain: float = 3.0) -> np.ndarray:
    """[t, v] float32 log-softmax of seeded normal logits with a CTC path
    through ``tokens`` planted: each token once (a blank between equal
    neighbours), centred in blank frames, its frames' labels raised by
    ``gain``. Needs t >= the lattice's mandatory frames."""
    logits = rng.normal(0.0, 1.0, (t, v)).astype(np.float32)
    path = []
    for tok in tokens:
        if path and path[-1] == tok:
            path.append(blank)
        path.append(tok)
    path = [blank] * ((t - len(path)) // 2) + path
    path += [blank] * (t - len(path))
    logits[np.arange(t), path] += gain
    z = logits - logits.max(axis=1, keepdims=True)
    return (z - np.log(np.exp(z).sum(axis=1, keepdims=True))).astype(
        np.float32)


def ctc_track(seed: int, windows: int, vocab: dict, t_range=(250, 350),
              v: int = 32, n_range=(40, 80)):
    """Caption windows of a track: [(log_probs [T, v], line, tokens)].
    Each line is lowercase words of at most 8 letters with single spaces, N
    characters with N uniform in ``n_range`` (S = 2N + 1 lattice states);
    its tokens are its characters by ``vocab``, a space as the word
    delimiter ``vocab["|"]`` (what ``encode_transcript`` gives such a
    line). T is uniform in ``t_range``, raised to the lattice's mandatory
    frames where it is below them, and the tokens' path is planted."""
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = []
    for _ in range(windows):
        n = int(rng.integers(n_range[0], n_range[1] + 1))
        words = []
        while True:
            left = n - len(" ".join(words))
            if left <= 0:
                break
            if words and left == 1:  # no room for a space and a letter
                words[-1] += letters[int(rng.integers(26))]
                break
            k = min(int(rng.integers(2, 9)), left - (1 if words else 0))
            words.append("".join(letters[i] for i in rng.integers(0, 26, k)))
        line = " ".join(words)
        tokens = np.array([vocab["|" if c == " " else c] for c in line])
        need = len(tokens) + int((tokens[1:] == tokens[:-1]).sum())
        t = max(need, int(rng.integers(t_range[0], t_range[1] + 1)))
        out.append((planted_emissions(rng, tokens, t, v), line,
                    tokens.tolist()))
    return out


# The states S of a window on the edges of the CTC kernel's warp lanes:
# K = ceil(S / 32) states a lane changes at 32, 64, ..., 256; 257 takes
# the block path.
CTC_LANE_EDGES = (2, 3, 31, 32, 33, 63, 64, 65, 191, 192, 193, 255, 256, 257)


def ctc_edge_batch(seed: int, s_values, v: int = 32, smax: int = 0,
                   extra: int = 5):
    """A packed batch (log_probs [B, Tmax, v] f32, t_len [B] int32,
    labels_ext [B, Smax] int32, allow_skip [B, Smax] bool, s_len [B]
    int32) of one window for each S of ``s_values``, padded to ``smax``
    (0: the largest S). A window's lattice is that of S // 2 seeded
    tokens cut to S states (an even S ends on a token state); its T is
    the tokens' mandatory frames plus 0 .. ``extra``, its path planted."""
    rng = np.random.default_rng(seed)
    smax = smax or max(s_values)
    rows = []
    for s in s_values:
        tokens = rng.integers(1, v, max(1, s // 2))
        need = len(tokens) + int((tokens[1:] == tokens[:-1]).sum())
        labels = np.zeros(2 * len(tokens) + 1, np.int32)
        labels[1::2] = tokens
        skip = np.zeros(len(labels), bool)
        skip[3::2] = tokens[1:] != tokens[:-1]
        t = need + int(rng.integers(0, extra + 1))
        rows.append((planted_emissions(rng, tokens.tolist(), t, v),
                     labels[:s], skip[:s]))
    tmax = max(lp.shape[0] for lp, _, _ in rows)
    log_probs = np.zeros((len(rows), tmax, v), np.float32)
    labels_ext = np.zeros((len(rows), smax), np.int32)
    allow_skip = np.zeros((len(rows), smax), bool)
    for i, (lp, labels, skip) in enumerate(rows):
        log_probs[i, :lp.shape[0]] = lp
        labels_ext[i, :len(labels)] = labels
        allow_skip[i, :len(skip)] = skip
    t_len = np.array([lp.shape[0] for lp, _, _ in rows], np.int32)
    s_len = np.array(list(s_values), np.int32)
    return log_probs, t_len, labels_ext, allow_skip, s_len
