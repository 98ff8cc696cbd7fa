"""Timing and inputs shared by the port's chip scripts (``chip_smoke.py``
and the tools beside this file).

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
