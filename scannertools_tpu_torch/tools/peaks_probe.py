"""Report the ``pose_peaks`` kernel's resources on one CUDA card, and its
time on maps of different peak density at the pose path's shape.

    python3 -m scannertools_tpu_torch.tools.peaks_probe [--reps 20]

Builds ``kernels/csrc/peaks.cu`` with ``nvcc -Xptxas -v`` and reports
ptxas's registers, stack and spills for both forms (16- and 4-byte
loads), then ``st_pose_peaks_info``: registers, shared and local bytes,
blocks resident an SM and clusters resident on the card. Then it times
the kernel with CUDA events (median of ``--reps`` single launches, the
card kept busy while the host prepares each one) on [8, 19, 480, 640]
maps: trained-like blobs (``timing.blob_maps``), smooth random maps (an
upsampled coarse grid: dense peaks, as the seeded net's) and a constant
0.5 plateau (every pixel a peak), each held to ``find_peaks_plain`` and
logged with its count of pixels above the threshold. Beside them,
``torch.sum`` over the same bytes: the card's own read rate.

Prints one JSON line per measurement and, last, the card's name and power
limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from ..kernels import build as _build
from ..models import pose as PP
from .timing import blob_maps, card, time_ms

SRC = os.path.join(_build.CSRC, "peaks.cu")


def _compile():
    """nvcc -Xptxas -v peaks.cu into the build directory -> (.so, ptxas's
    lines on registers and spills)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libpeaks-probe-{os.getpid()}.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"peaks_probe: nvcc failed:\n{log}")
    return out, [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line
                 or "Function properties" in line]


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.st_pose_peaks.restype = i
    lib.st_pose_peaks.argtypes = [p, i, i, i, i, p, p, p]
    return lib


def _call(lib, heat, peaks, valid):
    t, c, h, w = heat.shape
    rc = lib.st_pose_peaks(heat.data_ptr(), t, c, h, w, peaks.data_ptr(),
                           valid.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"st_pose_peaks failed with error {rc}")


def maps() -> dict:
    """The probe's [8, 19, 480, 640] inputs on the card."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    coarse = torch.randn((8, 19, 60, 80), device="cuda", generator=gen)
    smooth = torch.nn.functional.interpolate(
        coarse * 0.5 + 0.2, size=(480, 640), mode="bilinear").contiguous()
    return {"blobs": blob_maps(8, 19, 480, 640, seed=0), "smooth": smooth,
            "plateau": torch.full((8, 19, 480, 640), 0.5, device="cuda")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("peaks_probe: no CUDA device")
    path, ptxas = _compile()
    lib = _load(path)
    print(json.dumps({"ptxas": ptxas, "vec": PP.find_peaks_info(True),
                      "scalar": PP.find_peaks_info(False)}), flush=True)
    thre = PP._f32(PP.THRE_PEAK)
    for name, heat in maps().items():
        t = heat.shape[0]
        peaks = torch.empty((t, PP.N_PARTS, PP.MAX_PEAKS, 3), device="cuda")
        valid = torch.empty((t, PP.N_PARTS, PP.MAX_PEAKS), dtype=torch.bool,
                            device="cuda")
        words = heat.view(torch.int64)
        row = {"maps": name, "shape": list(heat.shape),
               "above": int((heat[:, :PP.N_PARTS] > thre).sum()),
               "device_ms": time_ms(lambda: _call(lib, heat, peaks, valid),
                                    args.reps, fence=True),
               "torch_sum_ms": time_ms(lambda: words.sum(), args.reps,
                                       fence=True)}
        want = PP.find_peaks_plain(heat)
        row["equal"] = torch.equal(peaks, want[0]) and torch.equal(valid,
                                                                   want[1])
        print(json.dumps(row), flush=True)
    torch.cuda.synchronize()
    print(json.dumps({"card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
