"""Find what bounds the histogram kernels on one CUDA card, by timing
ceiling variants of them at the main path's shape.

    python3 -m scannertools_tpu_torch.tools.hist_probe [--frames 64]
        [--height 1080] [--width 1920] [--reps 20] [--log DIR]

Builds ``tools/hist_probe.cu`` (the variants) and ``kernels/csrc/
histogram.cu`` with ``nvcc -Xptxas -v`` and reports each kernel's
registers, stack and spills (and, where ``cuobjdump`` is found, its SASS
instruction counts). Then, on random and on flat-colour frames (one RGB
colour; one Y, U, V triple), it times with CUDA events (median of
``--reps`` single launches, the card kept busy while the host prepares
each one) each kernel of ``csrc/histogram.cu`` and its ceiling variants:
read-only (the same loads, no counting) and count-only (the same counting
on bytes made in registers, no loads), at the work split of
``ops/histogram.py`` (``ITEMS_PER_BLOCK``); the full kernel also at
``OTHER_SPLITS`` work items per block. Every variant runs first at the
default shared-memory carveout, then after asking for the largest one.
Beside them it times PyTorch reductions over the same bytes, the card's
own read rate, and checks that every full launch gives the histograms of
the ``ops/histogram.py`` wrapper. It also prints
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for each kernel, with and
without the carveout.

Prints one JSON line per measurement and, last, the card's name and power
limit from nvidia-smi. With ``--log DIR`` it also writes the full ptxas
output, the SASS and the JSON lines there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from ..kernels import build as _build
from ..ops import histogram as H
from ..utils.framechunk import _YUV_COEFS
from .timing import hist_frames, time_ms

HERE = os.path.dirname(os.path.abspath(__file__))
PROBE_SRC = os.path.join(HERE, "hist_probe.cu")
KERNEL_SRC = os.path.join(_build.CSRC, "histogram.cu")
MODES = {"full": 0, "read_only": 1, "count_only": 2}


def _compile(src: str, name: str):
    """nvcc -Xptxas -v ``src`` into the build directory -> (.so, log)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"lib{name}-probe-{os.getpid()}.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", _build.CSRC, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    return out, log


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    proc = subprocess.run([tool], input="\n".join(names),
                          capture_output=True, text=True)
    return proc.stdout.splitlines() if proc.returncode == 0 else list(names)


def ptxas_report(log: str):
    """ptxas -v output -> [{kernel, registers, stack, spill_stores,
    spill_loads, smem}] for each compiled entry function."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def sass_report(so: str):
    """(SASS text, [{kernel, instructions, <opcode>: count}]) of a built
    library, or ("", []) without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return "", []
    proc = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return proc.stdout + proc.stderr, []
    ops = ("LDG", "LDS", "STS", "ATOMS", "RED", "ATOMG", "IMAD", "PRMT",
           "LOP3", "SHF", "IADD3", "FADD", "FMUL", "F2I", "I2F", "FRND",
           "FMNMX", "BRA", "BAR")
    rows, cur = [], None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = {"kernel": m.group(1), "instructions": 0}
            rows.append(cur)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m:
            cur["instructions"] += 1
            if m.group(1) in ops:
                cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return proc.stdout, rows


def _launch(lib, fmt, mode, x, t, h, w, flat, carveout, geo, out, fold):
    stream = torch.cuda.current_stream().cuda_stream
    if fmt == "rgb":
        rc = lib.probe_rgb(MODES[mode], x.data_ptr(), t, x.shape[1],
                           h * w * 3, carveout, geo.grid, geo.item_units,
                           geo.items_per_frame, flat, out.data_ptr(),
                           fold.data_ptr(), stream)
    else:
        coefs = (ctypes.c_float * 6)(*_YUV_COEFS[(False, False)])
        rc = lib.probe_i420(MODES[mode], x.data_ptr(), t, x.shape[1], h, w,
                            coefs, carveout, geo.grid, geo.item_units,
                            geo.items_per_frame, flat, out.data_ptr(),
                            fold.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"{fmt} {mode}: launch failed with {rc}")


def _load_probe(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.probe_rgb.argtypes = [i, p, i64, i64, i64, i, i64, i64, i64, i, p,
                              p, p]
    lib.probe_i420.argtypes = [i, p, i64, i64, i, i, p, i, i64, i64, i64, i,
                               p, p, p]
    lib.probe_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
    for fn in (lib.probe_rgb, lib.probe_i420, lib.probe_occupancy):
        fn.restype = i
    return lib


# PyTorch reductions over the same bytes: the card's own read rate
READS = {
    "sum_i64": lambda x: x.view(torch.int64).sum(),
    "sum_i32": lambda x: x.view(torch.int32).sum(),
}
# Work items per block timed beside ops/histogram.py's ITEMS_PER_BLOCK
OTHER_SPLITS = (16, 64)


def _occupancy(fn, *args) -> int:
    blocks = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"occupancy query failed with {rc}")
    return blocks.value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--log", default=None,
                    help="directory for the ptxas log and the JSON lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hist_probe: no CUDA device")
    t, h, w = args.frames, args.height, args.width
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    probe_so, probe_log = _compile(PROBE_SRC, "hist_probe")
    _, kernel_log = _compile(KERNEL_SRC, "histogram")
    for src, log in (("tools/hist_probe.cu", probe_log),
                     ("kernels/csrc/histogram.cu", kernel_log)):
        for row in ptxas_report(log):
            emit({"ptxas": src, **row})
    sass, sass_rows = sass_report(probe_so)
    for row in sass_rows:
        emit({"sass": "tools/hist_probe.cu", **row})
    lib = _load_probe(probe_so)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    out = torch.zeros((t, 3, 16), dtype=torch.int32, device="cuda")
    fold = torch.zeros(1, dtype=torch.int32, device="cuda")
    for carveout in (0, 1):
        occ = {fmt: _occupancy(lib.probe_occupancy, kernel, carveout)
               for fmt, kernel in (("rgb", 0), ("i420", 1))}
        for fmt, blocks in occ.items():
            emit({"occupancy": fmt, "carveout_max": bool(carveout),
                  "blocks_per_sm": blocks})
        for fmt in ("rgb", "i420"):
            for kind in ("random", "flat"):
                x = hist_frames(kind, fmt, t, h, w)
                flat = int(kind == "flat")
                res = {"fmt": fmt, "frames": kind,
                       "carveout_max": bool(carveout), "shape": [t, h, w],
                       "bytes": x.numel()}
                for name, fn in READS.items():
                    res[f"read.{name}_ms"] = time_ms(lambda: fn(x),
                                                     args.reps, fence=True)
                want = (H.hist_rgb(x, h * w * 3, 3) if fmt == "rgb" else
                        H.hist_i420(x, h, w))
                agree = True
                for ipb in (H.ITEMS_PER_BLOCK, *OTHER_SPLITS):
                    geo = (H.rgb_geometry(t, h * w * 3, 3, occ[fmt] * sms,
                                          ipb)
                           if fmt == "rgb" else
                           H.i420_geometry(t, h, w, occ[fmt] * sms, ipb))
                    tag = f"items_per_block_{ipb}"
                    res[f"{tag}.grid"] = geo.grid
                    res[f"{tag}.item_units"] = geo.item_units
                    modes = MODES if ipb == H.ITEMS_PER_BLOCK else ("full",)
                    for mode in modes:
                        res[f"{tag}.{mode}_ms"] = time_ms(
                            lambda: _launch(lib, fmt, mode, x, t, h, w, flat,
                                            carveout, geo, out, fold),
                            args.reps, fence=True)
                    out.zero_()
                    _launch(lib, fmt, "full", x, t, h, w, flat, carveout,
                            geo, out, fold)
                    agree &= torch.equal(out, want)
                res["full_agrees_with_wrapper"] = agree
                emit(res)
                if not agree:
                    raise AssertionError(f"{fmt} {kind}: the probe's full "
                                         "kernel disagrees with the wrapper")
                del x
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit({"card": card})
    if args.log:
        os.makedirs(args.log, exist_ok=True)
        with open(os.path.join(args.log, "hist_probe.jsonl"), "w") as f:
            f.writelines(json.dumps(o) + "\n" for o in lines)
        with open(os.path.join(args.log, "hist_probe_ptxas.txt"), "w") as f:
            f.write(probe_log + "\n" + kernel_log)
        with open(os.path.join(args.log, "hist_probe.sass"), "w") as f:
            f.write(sass)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
