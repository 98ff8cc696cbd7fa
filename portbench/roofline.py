"""The chip's peaks and the least time a kernel call could take.

Frozen copies of the bound arithmetic the port's smoke test states
(``bound_ms``, ``nms_bound``, ``crop_bound``, ``peaks_bound``): each
input byte read once, each output byte written once, and the float32
operations the call's data needs. A share of a roofline is the bound
over the measured device time; it cannot pass 100% unless the bytes or
operations are counted too high or the time leaves out part of the work.
"""

from __future__ import annotations

import math
import subprocess

from . import plain

# NVIDIA H100 SXM data sheet, at its full 700 W limit: HBM3 bandwidth and
# the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(bytes_moved: float, fp32_ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S) * 1e3


def nms_bound(scores, max_out: int, score_thresh: float = 0.0) -> float:
    """One nms call on [T, K] scores: boxes and scores read, boxes, scores
    and valid written; K ceil(log2 K) comparisons a frame for a stable
    sort, 5 operations a box for its area and 14 an overlap for each pair
    after a valid row."""
    t, k = scores.shape
    nbytes = t * k * (16 + 4) + t * max_out * (16 + 4 + 1)
    per_frame_valid = (scores > score_thresh).sum(dim=1).tolist()
    pairs = sum(v * (k - 1) - v * (v - 1) // 2 for v in per_frame_valid)
    ops = t * (k * math.ceil(math.log2(max(k, 2))) + 5 * k) + 14 * pairs
    return bound_ms(nbytes, ops)


def crop_bound(t: int, h: int, w: int, c: int, boxes, frame_idx, oh: int,
               ow: int) -> float:
    """One crop call from T frames of h x w x c float32: the crops written
    once, the boxes and frame indices read, each frame pixel some crop's
    taps read, once; 9 operations a value and 26 a pixel."""
    n_out = boxes.shape[0] * oh * ow
    nbytes = (n_out * c * 4 + boxes.shape[0] * (16 + 8)
              + plain.touched_pixels(h, w, boxes, frame_idx, t, oh, ow)
              * c * 4)
    return bound_ms(nbytes, n_out * (9 * c + 26))


def peaks_bound(heat, n_parts: int, max_peaks: int,
                thre: float) -> float:
    """One peaks call on heat [T, C, H, W]: the part maps read once, the
    peaks and valid flags written; a compare a pixel and eight more for
    each pixel above the threshold."""
    t, _, h, w = heat.shape
    parts = heat[:, :n_parts]
    above = int((parts > plain.f32(thre)).sum())
    nbytes = parts.numel() * 4 + t * n_parts * max_peaks * (12 + 1)
    return bound_ms(nbytes, parts.numel() + 8 * above)


def power_limit():
    """The card's power limit, as nvidia-smi reads it ("700.00 W"), or
    None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
