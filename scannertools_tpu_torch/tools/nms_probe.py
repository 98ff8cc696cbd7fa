"""Where the ``nms`` kernel's time goes, from the data it is given.

    python3 -m scannertools_tpu_torch.tools.nms_probe [--reps 20]

Times the ``nms`` wrapper alone (``device_ms``: CUDA events, the card kept
busy while the host prepares the call; median of ``--reps``) at the face
path's and the detection models' shapes (Mask R-CNN's two calls of an
8-frame chunk among them, its finals with the kept index), on kinds of
data that switch the kernel's phases on one at a time:

  * ``none_valid``: every score 0, so no row is valid: the launch, the
    loads, the sort and the zeroed outputs;
  * ``one_kept``: every box the same, all valid: the mask of every valid
    row, and a walk that keeps one row;
  * ``dense``: boxes in a small window, so most rows are suppressed;
  * ``sparse``: the timing records' clouds (600 px span), so nearly every
    row is kept;
  * ``disjoint``: boxes that touch none other: every row kept, no
    division in the mask and no step of the walk;
  * ``chain``: box i overlaps only box i + 1 above the threshold, scores
    falling with i: every other row kept, each after a step of the walk.

Each is timed as the wrapper picks its path (``device_ms.wrapper``) and,
up to NMS_SHARED_MAX_K rows, on each path forced (``device_ms.shared``,
``device_ms.global``), through the wrapper with ``nms_geometry``'s rule
moved. Beside the rows kept, ``steps`` counts the dependent steps the
data needs, the most of any frame: the kept rows that suppress a valid
row after them (a kept row that suppresses none changes nothing that
comes after it). Then the floor of the cross-scale call [16, 256]: the
device time of an empty launch (``launch_ms``) and of a step of the walk
(``step_us``: chain less disjoint over their difference in steps, on the
one-launch path); the floor is launch_ms + steps (``sparse``) x step_us.
Prints one JSON line a case and the floor, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from ..models import common as MC
from .timing import box_cloud, card, time_ms

IOU = 0.7
CASES = (("cross_scale", 16, 256, 256), ("per_scale", 80, 128, 128),
         ("fpn_level", 1, 1000, 1000), ("rpn", 2, 2048, 300),
         # Mask R-CNN's calls of an 8-frame chunk: the five levels'
         # proposals and the finals (timed with the kept index)
         ("mrcnn_proposals", 40, 1000, 1000), ("mrcnn_final", 8, 1000, 100),
         # frames a call against K, for the choice of path
         ("t1_k256", 1, 256, 256), ("t4_k512", 4, 512, 512),
         ("t1_k512", 1, 512, 512), ("t16_k512", 16, 512, 512),
         ("t4_k1000", 4, 1000, 1000), ("t16_k1000", 16, 1000, 1000),
         ("t64_k1000", 64, 1000, 1000))
KINDS = ("none_valid", "one_kept", "dense", "sparse", "disjoint", "chain")


def inputs(kind: str, t: int, k: int, rng):
    if kind in ("disjoint", "chain"):
        # 10 px boxes a row, 20 px apart (no two touch), or 1 px apart
        # (IoU 9/11 with the next box, 8/12 with the one after)
        step = 20.0 if kind == "disjoint" else 1.0
        x = np.arange(k) * step
        row = np.stack([x, np.zeros(k), x + 10, np.full(k, 10.0)], axis=1)
        boxes = np.broadcast_to(row, (t, k, 4)).copy()
        scores = np.broadcast_to(np.linspace(1.0, 0.5, k), (t, k)).copy()
    else:
        boxes = box_cloud(rng, t, k, 60.0 if kind == "dense" else 600.0)
        if kind == "one_kept":
            boxes[:] = (10.0, 10.0, 50.0, 50.0)
        scores = rng.uniform(0.01, 1, (t, k))
        if kind == "none_valid":
            scores[:] = 0.0
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def dependent_steps(boxes, scores) -> int:
    """The kept rows that suppress a valid row after them, the most of any
    frame."""
    _, s, keep, sup = MC.greedy_keep(boxes, scores, IOU)
    return int((keep & (sup & (s > 0)[:, None, :]).any(dim=2)).sum(
        dim=1).max())


@contextlib.contextmanager
def path(name: str):
    """``nms_geometry``'s rule moved so that the wrapper takes the named
    path ("shared" up to NMS_SHARED_MAX_K rows; "global" at any K); None
    leaves the rule as it is."""
    saved = MC.NMS_SPREAD_ABOVE_K, MC.NMS_SPREAD_BELOW_T
    if name == "shared":
        MC.NMS_SPREAD_ABOVE_K = MC.NMS_SHARED_MAX_K
    elif name == "global":
        MC.NMS_SPREAD_ABOVE_K, MC.NMS_SPREAD_BELOW_T = -1, sys.maxsize
    try:
        yield
    finally:
        MC.NMS_SPREAD_ABOVE_K, MC.NMS_SPREAD_BELOW_T = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nms_probe: no CUDA device")
    rng = np.random.default_rng(5)
    floor = {}
    for name, t, k, max_out in CASES:
        paths = [None] + (["shared", "global"] if k <= MC.NMS_SHARED_MAX_K
                          else [])
        for kind in KINDS if name in dict.fromkeys(
                c[0] for c in CASES[:4]) else ("dense", "sparse"):
            boxes, scores = inputs(kind, t, k, rng)
            want = MC.nms_plain(boxes, scores, IOU, max_out)
            res = {"call": name, "shape": [t, k], "max_out": max_out,
                   "kind": kind, "kept": int(want[2].sum()),
                   "steps": dependent_steps(boxes, scores)}
            for p in paths:
                with path(p):
                    got = MC.nms(boxes, scores, IOU, max_out)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"nms_probe: {name} {kind} on "
                                             f"the {p or 'chosen'} path "
                                             f"differs from nms_plain")
                    res[f"device_ms.{p or 'wrapper'}"] = time_ms(
                        lambda: MC.nms(boxes, scores, IOU, max_out,
                                       index=name == "mrcnn_final"),
                        args.reps, fence=True)
            if name == "cross_scale":
                floor[kind] = res
            print(json.dumps(res), flush=True)
    launch = time_ms(lambda: torch.cuda._sleep(0), args.reps, fence=True)
    chain, disjoint = floor["chain"], floor["disjoint"]
    sparse = floor["sparse"]
    step_us = 1e3 * (chain["device_ms.shared"] - disjoint["device_ms.shared"]
                     ) / (chain["steps"] - disjoint["steps"])
    print(json.dumps({"floor": "cross_scale", "shape": sparse["shape"],
                      "launch_ms": launch, "step_us": step_us,
                      "steps": sparse["steps"],
                      "floor_ms": launch + sparse["steps"] * step_us / 1e3}),
          flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
