"""Report where the ``ctc_viterbi`` kernel's time goes on one CUDA card.

    python3 -m scannertools_tpu_torch.tools.ctc_probe [--reps 20]
        [--log DIR]

Builds ``tools/ctc_probe.cu`` (which includes ``kernels/csrc/ctc.cu``)
with ``nvcc -Xptxas -v`` and reports the registers and spills of the warp
path's kernels; with ``--log``, the ptxas log and the SASS of
``warp_viterbi_kernel<6, true, true>`` (the caption track's: K = 6, bulk
copies, V <= 32) go to DIR. Then it
times with CUDA events (median of ``--reps`` single launches, the card
kept busy while the host prepares each one):

  * ``ctc_viterbi`` on one window of S = 161 states at T = 128 to 2800
    frames: the slope over T is a frame of the warp path, forward step
    and backtrace together;
  * the backtrace alone (``st_ctc_walk_probe``: one lane walking packed
    moves in shared memory) at the same T;
  * the forward step's chain alone, ``viterbi_step_probe`` on the warp
    path at K = 1..8 (Smax = 32 K) and on the block path at Smax = 161;
  * the 600-window track of ``chip_smoke.py`` (``timing.ctc_track`` seed
    9) at 1..8 windows a block, each launch held equal to the wrapper's.

Prints one JSON line per measurement and, last, the card's name and power
limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch

from ..kernels import build as _build
from ..ops import ctc_align as CA
from .timing import card, ctc_track, planted_emissions, time_ms

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "ctc_probe.cu")
TRACK_KERNEL = "warp_viterbi_kernelILi6ELb1ELb1E"  # <6, bulk, V <= 32>


def _compile(log_dir):
    """nvcc -Xptxas -v ctc_probe.cu -> (the loaded library, ptxas's lines
    on the warp path's registers and spills)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libctc-probe-{os.getpid()}.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           _build.CSRC, "-o", out, SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"ctc_probe: nvcc failed:\n{log}")
    lines, keep = [], False
    for line in log.splitlines():
        if "Function properties for" in line:
            keep = "warp_viterbi" in line or "walk_probe" in line \
                or "warp_step" in line
        if keep and ("Function properties" in line or "registers" in line
                     or "spill" in line):
            lines.append(line.strip())
    if log_dir:
        with open(os.path.join(log_dir, "ptxas.txt"), "w") as f:
            f.write(log)
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if os.path.isfile(tool):
            sass = subprocess.run([tool, "-sass", out], capture_output=True,
                                  text=True).stdout
            # the track's kernel: from its "Function :" line to the next
            parts = sass.split("Function : ")
            mine = [p for p in parts if p.startswith("_Z")
                    and TRACK_KERNEL in p.splitlines()[0]]
            with open(os.path.join(log_dir, "warp_k6_bulk.sass"), "w") as f:
                f.write("".join(mine))
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.st_ctc_walk_probe.restype = i
    lib.st_ctc_walk_probe.argtypes = [i, i, i, p, p]
    return lib, lines


def _slope(xs, ys) -> float:
    return float(np.polyfit(np.asarray(xs, float), np.asarray(ys, float),
                            1)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--log", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ctc_probe: no CUDA device")
    if args.log:
        os.makedirs(args.log, exist_ok=True)
    lib, ptxas = _compile(args.log)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    # one window of 161 states: the warp path's time a frame, and the
    # backtrace's alone
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, 32, 80).tolist()
    ts = (128, 256, 350, 700, 1400, 2800)
    window, walk = [], []
    for t in ts:
        one = [torch.from_numpy(x).cuda() for x in CA.pack_windows(
            [(planted_emissions(rng, tokens, t, 32), tokens)])]
        window.append(time_ms(lambda: CA.ctc_viterbi(*one), args.reps,
                              fence=True))
        out = torch.empty(t, dtype=torch.int32, device="cuda")

        def walk_call():
            rc = lib.st_ctc_walk_probe(161, t, 160, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"st_ctc_walk_probe failed: {rc}")

        walk.append(time_ms(walk_call, args.reps, fence=True))
        want, state = np.empty(t, np.int32), 160
        want[t - 1] = state
        for r in range(t - 2, -1, -1):  # an advance on odd rows
            state -= r % 2 == 1 and state > 0
            want[r] = state
        if not np.array_equal(out.cpu().numpy(), want):
            raise AssertionError(f"walk probe at T {t}: a wrong path")
    print(json.dumps({"window_161": {"t": ts, "device_ms": window,
                                     "ns_a_frame": _slope(ts, window) * 1e6},
                      "walk_161": {"t": ts, "device_ms": walk,
                                   "ns_a_frame": _slope(ts, walk) * 1e6}}),
          flush=True)

    # the forward step's chain alone
    lo, hi = 349, 8 * 349
    steps = {}
    for k in range(1, CA.WARP_MAX_K + 1):
        smax = 32 * k
        ms = [time_ms(lambda: CA.viterbi_step_probe(n, smax, path="warp"),
                      args.reps, fence=True) for n in (lo, hi)]
        steps[f"warp_k{k}"] = (ms[1] - ms[0]) / (hi - lo) * 1e6
    ms = [time_ms(lambda: CA.viterbi_step_probe(n, 161, path="block"),
                  args.reps, fence=True) for n in (lo, hi)]
    steps["block_161"] = (ms[1] - ms[0]) / (hi - lo) * 1e6
    print(json.dumps({"step_ns": steps}), flush=True)

    # the track at 1..8 windows a block
    track = ctc_track(9, 600, CA.char_vocab(), (250, 350), 32, (40, 80))
    batch = [torch.from_numpy(x).cuda() for x in CA.pack_windows(
        [(lp, tok) for lp, _, tok in track])]
    b, tmax, v = batch[0].shape
    smax = batch[2].shape[1]
    want = CA.ctc_viterbi(*batch)
    by_windows = {}
    for windows in range(1, CA.WARP_MAX_WINDOWS + 1):
        if windows * CA.window_bytes(tmax, v) > CA.SHARED_MAX:
            break
        states = torch.empty((b, tmax), dtype=torch.int32, device="cuda")
        scores = torch.empty(b, dtype=torch.float32, device="cuda")

        def call():
            rc = CA._lib().st_ctc_viterbi_warp(
                *[x.data_ptr() for x in batch], b, tmax, v, smax, windows, 1,
                states.data_ptr(), scores.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"st_ctc_viterbi_warp failed: {rc}")

        by_windows[windows] = time_ms(call, args.reps, fence=True)
        if not (torch.equal(states, want[0]) and torch.equal(scores,
                                                             want[1])):
            raise AssertionError(f"{windows} windows a block disagree")
    geo = CA.viterbi_geometry(b, tmax, smax, v)
    print(json.dumps({"track": {"shape": [b, tmax, v, smax],
                                "windows_picked": geo["windows"],
                                "device_ms_by_windows": by_windows}}),
          flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
