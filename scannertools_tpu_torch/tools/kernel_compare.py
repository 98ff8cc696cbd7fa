"""Time the CUDA kernels of one checkout of the port, so that two
checkouts can be compared on one card, in turns.

    python3 scannertools_tpu_torch/tools/kernel_compare.py --tree DIR
        [--kernels hist,nms,crop,peaks] [--frames 64] [--height 1080]
        [--width 1920] [--reps 20]

Imports ``scannertools_tpu_torch`` from the checkout at ``DIR`` (not from
the tree this file lies in; run it by path, not with ``-m``), builds its
kernels, and times their wrappers with CUDA events, median of ``--reps``
calls (``timing.time_ms``): ``ms`` on an idle card, the wrapper's host
work inside the window (the method of ``chip_smoke.py``'s ``ms``), and
``device_ms`` with the card kept busy while the host prepares the call
(the kernel's time alone). The inputs are made here from fixed seeds, the
same for every checkout. ``--kernels`` picks among:

  * ``hist``: ``hist_rgb`` and ``hist_i420`` on random and on flat-colour
    ``--frames`` x ``--height`` x ``--width`` frames;
  * ``nms``: at the face path's calls of a 16-frame chunk: cross-scale
    [16, 256] (max_out 256), one pyramid scale [16, 128] and the five
    scales batched [80, 128], R-Net [16, 96], O-Net [16, 64] ("min",
    max_out 32); and at the detection models' calls: [1, 1000] (max_out
    1000, a Mask R-CNN FPN level), [2, 2048] and [8, 2048] (max_out 300,
    Faster R-CNN's proposals of two frames and of an 8-frame chunk),
    [8, 512] (max_out 100, SSD's chunk), and Mask R-CNN's calls of an
    8-frame chunk: the proposals [40, 1000] (max_out 1000) and the finals
    [8, 1000] (max_out 100, with the kept index), IoU 0.7; with the rows
    each keeps;
  * ``crop``: ``crop_and_resize`` from 16 frames of 640x480x3 at FaceNet's
    512 crops of 160x160, gender's 512 of 227x227, R-Net's 1536 of 24x24,
    O-Net's 1024 of 48x48; and 1000 boxes of a P2 map [1, 200, 336, 256]
    (an 800x1344 canvas at stride 4) at 7x7 and 14x14; and Faster R-CNN's
    RoIAlign, 300 boxes a frame of 8 conv5_3 maps [8, 37, 50, 512] (an
    800x600 input at stride 16) at 7x7. Beside each,
    ``F.grid_sample`` at the same sample positions (``library_ms``; the
    same call in every checkout). Where the checkout has it,
    ``crop_and_resize_levels`` at Mask R-CNN's calls of an 8-frame chunk:
    the FPN levels P2..P5 of 800x1088 canvases at C = 256, 8000 boxes at
    7x7 and 800 at 14x14, on every level (``library_ms``: four
    ``F.grid_sample`` calls, one a level);
  * ``peaks``: ``find_peaks`` at the pose path's call, [8, 19, 480, 640],
    on trained-like maps (``timing.blob_maps``: 15 Gaussian blobs of 7 px
    a part, about 3% of the pixels above the threshold) and on a constant
    0.5 plateau (every pixel a peak), with the count of pixels above the
    threshold and, as ``library_ms``, the ``max_pool2d``/``topk``
    yardstick (``timing.peaks_yardstick``: the same peaks, not the same
    function).

Run it on each checkout in turns (A, B, B, A) on the same card and compare
those. Prints one JSON line with the checkout, the times and, in the same
line, the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from timing import (blob_maps, box_cloud, card, grid_sample_crops,
                    grid_sample_level_crops, hist_frames, level_boxes,
                    peaks_yardstick, time_ms)

NMS_CASES = (  # name, frames, K, max_out, mode, kept index
    ("cross_scale", 16, 256, 256, "union", False),
    ("per_scale", 16, 128, 128, "union", False),
    ("per_scale_batched", 80, 128, 128, "union", False),
    ("rnet", 16, 96, 96, "union", False),
    ("onet", 16, 64, 32, "min", False),
    ("fpn_level", 1, 1000, 1000, "union", False),
    ("rpn", 2, 2048, 300, "union", False),
    ("ssd_chunk", 8, 512, 100, "union", False),
    ("rpn_chunk", 8, 2048, 300, "union", False),
    ("mrcnn_proposals", 40, 1000, 1000, "union", False),
    ("mrcnn_final", 8, 1000, 100, "union", True),
)
CROP_CASES = (  # name, boxes a frame, output side, source
    ("facenet", 32, 160, "frames"),
    ("gender", 32, 227, "frames"),
    ("rnet", 96, 24, "frames"),
    ("onet", 64, 48, "frames"),
    ("roi_7", 1000, 7, "p2"),
    ("roi_14", 1000, 14, "p2"),
    ("roi_align_c512", 300, 7, "c5"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--kernels", default="hist,nms,crop")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= {"hist", "nms", "crop", "peaks"}:
        raise SystemExit(f"kernel_compare: unknown --kernels {args.kernels}")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from scannertools_tpu_torch.models import common as MC
    from scannertools_tpu_torch.ops import histogram as H

    for mod in (MC, H):
        if not mod.__file__.startswith(tree + os.sep):
            raise SystemExit(f"kernel_compare: imported {mod.__file__}, "
                             f"not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: no CUDA device")
    res = {"tree": args.tree}

    def timed(name, call, library=None):
        res[f"{name}.ms"] = time_ms(call, args.reps, fence=False)
        res[f"{name}.device_ms"] = time_ms(call, args.reps, fence=True)
        if library is not None:
            res[f"{name}.library_ms"] = time_ms(library, args.reps,
                                                fence=True)

    if "hist" in kernels:
        t, h, w = args.frames, args.height, args.width
        res["hist.shape"] = [t, h, w]
        calls = {"hist_rgb": lambda x: H.hist_rgb(x, h * w * 3, 3),
                 "hist_i420": lambda x: H.hist_i420(x, h, w)}
        for name, call in calls.items():
            fmt = "rgb" if name == "hist_rgb" else "i420"
            for kind in ("random", "flat"):
                x = hist_frames(kind, fmt, t, h, w)
                timed(f"{name}.{kind}", lambda: call(x))
                del x

    if "nms" in kernels:
        rng = np.random.default_rng(2)
        for name, t, k, max_out, mode, index in NMS_CASES:
            boxes = torch.from_numpy(box_cloud(rng, t, k)).cuda()
            scores = torch.from_numpy(rng.uniform(0, 1, (t, k)).astype(
                np.float32)).cuda()
            timed(f"nms.{name}", lambda: MC.nms(boxes, scores, 0.7, max_out,
                                                0.0, mode, index))
            res[f"nms.{name}.kept"] = int(MC.nms(boxes, scores, 0.7, max_out,
                                                 0.0, mode)[2].sum())

    if "crop" in kernels:
        rng = np.random.default_rng(3)
        sources = {
            "frames": torch.from_numpy(rng.uniform(0, 255, (16, 480, 640, 3))
                                       .astype(np.float32)).cuda(),
            "p2": torch.from_numpy(rng.standard_normal((1, 200, 336, 256))
                                   .astype(np.float32)).cuda(),
            "c5": torch.from_numpy(rng.standard_normal((8, 37, 50, 512))
                                   .astype(np.float32)).cuda()}
        for name, k, size, src in CROP_CASES:
            images = sources[src]
            t, h, w, _ = images.shape
            if src == "frames":
                boxes = box_cloud(rng, t, k)
            else:
                boxes = box_cloud(rng, t, k, min(h, w), 2.0,
                                  min(60.0, min(h, w)))
            boxes = torch.from_numpy(boxes).cuda()
            flat = boxes.reshape(-1, 4).contiguous()
            fi = torch.arange(t).cuda().repeat_interleave(k)
            _, library = grid_sample_crops(images, boxes, size, size,
                                           MC._sample_positions)
            timed(f"crop.{name}",
                  lambda: MC.crop_and_resize(images, flat, (size, size), fi),
                  library=library)
        if hasattr(MC, "crop_and_resize_levels"):
            from scannertools_tpu_torch.models import maskrcnn as PM

            canvas = (800, 1088)
            maps = [torch.from_numpy(rng.standard_normal(
                (8, canvas[0] // s, canvas[1] // s, 256)).astype(
                    np.float32)).cuda() for s in MC.FPN_STRIDES]
            for name, k, size in (("levels_7", 1000, 7),
                                  ("levels_14", 100, 14)):
                boxes, fi = (torch.from_numpy(a).cuda()
                             for a in level_boxes(rng, 8, k, canvas))
                level = PM.fpn_level_for(boxes)
                _, library = grid_sample_level_crops(
                    maps, boxes, level, fi, size, size,
                    MC._sample_positions, MC.FPN_STRIDES)
                timed(f"crop.{name}", lambda: MC.crop_and_resize_levels(
                    maps, boxes, level, fi, (size, size)), library=library)
    if "peaks" in kernels:
        from scannertools_tpu_torch.models import pose as PP

        thre = PP._f32(PP.THRE_PEAK)
        for name in ("blobs", "plateau"):
            heat = blob_maps(8, 19, 480, 640, seed=0) if name == "blobs" \
                else torch.full((8, 19, 480, 640), 0.5, device="cuda")
            res[f"peaks.{name}.above"] = int(
                (heat[:, :PP.N_PARTS] > thre).sum())
            timed(f"peaks.{name}", lambda: PP.find_peaks(heat),
                  library=peaks_yardstick(heat, PP.N_PARTS, thre,
                                          PP.MAX_PEAKS))
            del heat
    torch.cuda.synchronize()
    res["card"] = card()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
