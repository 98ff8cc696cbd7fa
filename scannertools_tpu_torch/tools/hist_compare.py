"""Time the histogram kernels of one checkout of the port, so that two
checkouts can be compared on one card, in turns.

    python3 scannertools_tpu_torch/tools/hist_compare.py --tree DIR
        [--frames 64] [--height 1080] [--width 1920] [--reps 20]

Imports ``scannertools_tpu_torch`` from the checkout at ``DIR`` (not from
the tree this file lies in; run it by path, not with ``-m``), builds its
kernels, and times its ``hist_rgb`` and ``hist_i420`` wrappers on random
and on flat-colour frames with CUDA events, median of ``--reps`` calls:
``ms`` on an idle card, the wrapper's host work inside the window (the
method of ``chip_smoke.py``'s ``ms``), and ``device_ms`` with the card kept
busy while the host prepares the call (the kernel's time alone). Run it on
each checkout in turns (A, B, B, A) on the same card and compare those.

Prints one JSON line with the checkout, the times and, in the same line,
the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

# A spin of this many card cycles (about 0.5 ms) before the start event
# keeps the card busy while the host prepares the timed call.
FENCE_CYCLES = 1_000_000


def time_ms(fn, reps: int, fence: bool, warm: int = 3) -> float:
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


def frames(kind: str, fmt: str, t: int, h: int, w: int):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from scannertools_tpu_torch.ops import histogram as H

    if not H.__file__.startswith(tree + os.sep):
        raise SystemExit(f"hist_compare: imported {H.__file__}, not from "
                         f"{tree}")
    if not torch.cuda.is_available():
        raise SystemExit("hist_compare: no CUDA device")
    t, h, w = args.frames, args.height, args.width
    calls = {"hist_rgb": lambda x: H.hist_rgb(x, h * w * 3, 3),
             "hist_i420": lambda x: H.hist_i420(x, h, w)}
    res = {"tree": args.tree, "shape": [t, h, w]}
    for name, call in calls.items():
        fmt = "rgb" if name == "hist_rgb" else "i420"
        for kind in ("random", "flat"):
            x = frames(kind, fmt, t, h, w)
            tag = "" if kind == "random" else "flat_"
            res[f"{name}.{tag}ms"] = time_ms(lambda: call(x), args.reps,
                                             fence=False)
            res[f"{name}.{tag}device_ms"] = time_ms(lambda: call(x),
                                                    args.reps, fence=True)
            del x
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    res["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
