#!/usr/bin/env python3
"""Chip smoke test of scannertools_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the CUDA kernels from ``scannertools_tpu_torch/kernels/csrc``
and holds each one to its plain torch version on the card (difference 0) at
ragged geometries, at the main path's 1080p 64-frame chunk and at one
7680x4320 frame; it times kernel and plain version with CUDA events.

Phase 2 drives the main path through the public API on the default device:
``Client() -> Histogram -> ShotBoundaries -> NamedStream`` over a 1080p,
480-frame, 24 fps video with cuts at 120, 240 and 360, once with RGB24 and
once with I420 ingest. The frames come from a synthetic decoder behind the
package's NamedVideoStream, so the script needs neither a video file nor
the libav development files the native decoder is built from; libav decode
itself is covered by the CPU tests. Each run must give
the boundaries [120, 240, 360], histogram rows equal to the plain version's
on the same frames, and launches of its kernel.

Output, on stdout: one JSON line per phase-1 check, the run totals, then
``{"kernels": [...]}``, the card's name and power limit from nvidia-smi,
and last ``{"ok": true, "device": {...}}``. Any failure raises: the exit
code is then not 0 and the last line is not printed. Without a CUDA device,
or without the package beside this file, it fails the same way.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES, HEIGHT, WIDTH, FPS = 480, 1080, 1920, 24.0
CUTS = (120, 240, 360)
CHUNK = 64
COLORS = [(200, 40, 40), (40, 200, 40), (40, 40, 200), (200, 200, 40)]
BAR = 16  # moving white bar width, px (even: whole chroma columns)

# H100 SXM data sheet peaks: HBM3 bandwidth and FP32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------ timing


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` single calls, each timed with CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(bytes_moved: float, fp32_ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 1


def random_frames(gen, t: int, nbytes: int):
    import torch

    return torch.randint(0, 256, (t, nbytes), dtype=torch.uint8,
                         device="cuda", generator=gen)


def check_kernels():
    """-> per-kernel records at the main path's shape (1080p, T=64)."""
    import torch

    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.utils.framechunk import LANES

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"hist_rgb": 0, "hist_i420": 0}
    records = {}

    def compare(name, got, want, **shape):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst[name] = max(worst[name], err)
        log({"check": name, **shape, "max_abs_err": err})
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}: max abs diff {err}")

    def lane_rows(t, payload):
        return random_frames(gen, t, -(-payload // LANES) * LANES)

    # RGB byte streams in the FrameChunk layout, plus unaligned NHWC tensors
    # (the byte-load path) and 1- and 4-channel streams
    for t, h, w in [(3, 33, 17), (2, 120, 128), (CHUNK, HEIGHT, WIDTH),
                    (1, 4320, 7680)]:
        flat = lane_rows(t, h * w * 3)
        npix = h * w * 3
        compare("hist_rgb", H.hist_rgb(flat, npix, 3),
                H.hist_rgb_plain(flat, npix, 3), t=t, h=h, w=w, c=3)
        if (t, h, w) == (CHUNK, HEIGHT, WIDTH):
            nbytes = t * npix
            bound, by = bound_ms(nbytes + t * 3 * 16 * 4, nbytes)
            records["hist_rgb"] = {
                "ms": time_ms(lambda: H.hist_rgb(flat, npix, 3)),
                "plain_ms": time_ms(lambda: H.hist_rgb_plain(flat, npix, 3),
                                    reps=5, warm=1),
                "bound_ms": bound, "bound_by": by}
        del flat
    for t, h, w, c in [(3, 33, 17, 3), (2, 31, 29, 1), (2, 45, 37, 4)]:
        nhwc = random_frames(gen, t, h * w * c).reshape(t, h, w, c)
        compare("hist_rgb", H.hist_rgb(nhwc, h * w * c, c),
                H.hist_rgb_plain(nhwc, h * w * c, c), t=t, h=h, w=w, c=c,
                layout="nhwc")

    for t, h, w in [(3, 34, 18), (2, 120, 128), (CHUNK, HEIGHT, WIDTH),
                    (1, 4320, 7680)]:
        flat = lane_rows(t, h * w * 3 // 2)
        for bt709 in (False, True):
            for full in (False, True):
                compare("hist_i420",
                        H.hist_i420(flat, h, w, full, bt709),
                        H.hist_i420_plain(flat, h, w, full, bt709),
                        t=t, h=h, w=w, bt709=bt709, full_range=full)
        if (t, h, w) == (CHUNK, HEIGHT, WIDTH):
            nbytes = t * h * w * 3 // 2
            # per luma sample: (Y-yo)*ys and three sums; per chroma sample:
            # two offsets and four products
            ops = t * (6 * h * w + 6 * (h // 2) * (w // 2))
            bound, by = bound_ms(nbytes + t * 3 * 16 * 4, ops)
            records["hist_i420"] = {
                "ms": time_ms(lambda: H.hist_i420(flat, h, w)),
                "plain_ms": time_ms(lambda: H.hist_i420_plain(flat, h, w),
                                    reps=5, warm=1),
                "bound_ms": bound, "bound_by": by}
        del flat
    torch.cuda.synchronize()
    for name in records:
        records[name]["max_abs_err"] = worst[name]
        log({"timing": name, "shape": [CHUNK, HEIGHT, WIDTH],
             **records[name]})
    return records


# ------------------------------------------------------------ phase 2


def shot_of(i: int) -> int:
    return sum(i >= c for c in CUTS)


def rgb_to_i420_limited(rgb):
    """BT.601 limited-range YUV of one RGB colour (the decoder's job)."""
    r, g, b = (float(v) / 255.0 for v in rgb)
    y = 16 + 65.481 * r + 128.553 * g + 24.966 * b
    u = 128 - 37.797 * r - 74.203 * g + 112.0 * b
    v = 128 + 112.0 * r - 93.786 * g - 18.214 * b
    return tuple(int(round(c)) for c in (y, u, v))


class SyntheticDecoder:
    """The decoder interface the executor calls, drawing the shots and a
    moving bar straight into the staging slot it is given."""

    i420_supported = True
    i420_full_range = False
    i420_bt709 = False

    def __init__(self, n: int, h: int, w: int):
        self.n, self.h, self.w = n, h, w
        self._rgb = {}  # shot -> its bar-less RGB frame, drawn once
        self._i420 = {}  # shot -> its bar-less I420 frame

    def _bar(self, i: int) -> int:
        return (i * 2 * BAR) % (self.w - BAR)

    def read_frames(self, rows, out=None):
        if out is None:
            out = np.empty((len(rows), self.h, self.w, 3), np.uint8)
        for k, i in enumerate(rows):
            shot = shot_of(i)
            if shot not in self._rgb:
                frame = np.empty((self.h, self.w, 3), np.uint8)
                frame[:] = COLORS[shot]
                self._rgb[shot] = frame
            out[k] = self._rgb[shot]
            x = self._bar(i)
            out[k, :, x:x + BAR] = 255
        return out

    def read_frames_i420(self, rows, out=None):
        h, w = self.h, self.w
        if out is None:
            out = np.empty((len(rows), h * w * 3 // 2), np.uint8)
        for k, i in enumerate(rows):
            shot = shot_of(i)
            if shot not in self._i420:
                frame = np.empty(h * w * 3 // 2, np.uint8)
                yv, uv, vv = rgb_to_i420_limited(COLORS[shot])
                frame[:h * w] = yv
                frame[h * w:h * w * 5 // 4] = uv
                frame[h * w * 5 // 4:] = vv
                self._i420[shot] = frame
            out[k] = self._i420[shot]
            x = self._bar(i)
            yp = out[k, :h * w].reshape(h, w)
            up = out[k, h * w:h * w * 5 // 4].reshape(h // 2, w // 2)
            vp = out[k, h * w * 5 // 4:].reshape(h // 2, w // 2)
            yp[:, x:x + BAR] = 235
            up[:, x // 2:(x + BAR) // 2] = 128
            vp[:, x // 2:(x + BAR) // 2] = 128
        return out

    def close(self) -> None:
        pass


def synthetic_stream_class():
    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.io.video import VideoMetadata

    class SyntheticVideoStream(st.NamedVideoStream):
        """A NamedVideoStream whose decoder is SyntheticDecoder."""

        def __len__(self) -> int:
            return N_FRAMES

        def video_path(self) -> str:
            return "synthetic"

        def metadata(self) -> VideoMetadata:
            return VideoMetadata("synthetic", N_FRAMES, FPS, WIDTH, HEIGHT)

        def decoder(self) -> SyntheticDecoder:
            return SyntheticDecoder(N_FRAMES, HEIGHT, WIDTH)

    return SyntheticVideoStream


def plain_histograms(ingest: str, device: str = "cuda"):
    """[N, 3, 16] histograms of the synthetic frames by the plain
    versions, on the card."""
    import torch

    from scannertools_tpu_torch.ops import histogram as H
    from scannertools_tpu_torch.utils.framechunk import FrameChunk

    dec = SyntheticDecoder(N_FRAMES, HEIGHT, WIDTH)
    out = []
    for a in range(0, N_FRAMES, CHUNK):
        rows = list(range(a, min(a + CHUNK, N_FRAMES)))
        if ingest == "rgb":
            chunk = FrameChunk.from_hwc(dec.read_frames(rows)).device(device)
            out.append(H.hist_rgb_plain(chunk.flat, chunk.npix, 3))
        else:
            chunk = FrameChunk.from_i420(dec.read_frames_i420(rows),
                                         HEIGHT, WIDTH).device(device)
            out.append(H.hist_i420_plain(chunk.flat, HEIGHT, WIDTH))
    return torch.cat(out).cpu().numpy()


def run_pipeline(db: str):
    """-> {ingest: launches of each kernel in that run}."""
    import torch

    import scannertools_tpu_torch as st
    from scannertools_tpu_torch.ops import histogram as H

    stream_cls = synthetic_stream_class()
    launches = {}
    for ingest in ("rgb", "i420"):
        sc = st.Client(db_path=os.path.join(db, ingest))
        video = stream_cls(sc, "video")
        frame = sc.io.Input([video])
        hist = sc.ops.Histogram(frame=frame)
        bounds = sc.ops.ShotBoundaries(histograms=hist)
        hist_out = st.NamedStream(sc, "hist")
        shots_out = st.NamedStream(sc, "shots")
        out = sc.io.Output([hist, bounds], [(hist_out, shots_out)])
        perf = st.PerfParams.manual(work_packet_size=CHUNK, ingest=ingest)

        H.hist_rgb.launches = 0
        H.hist_i420.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.run(out, perf, cache_mode=st.CacheMode.Overwrite)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[ingest] = {"hist_rgb": H.hist_rgb.launches,
                            "hist_i420": H.hist_i420.launches}

        cuts = next(shots_out.load(rows=[0]))
        rows = np.stack([np.stack(r) for r in hist_out.load()])
        want = plain_histograms(ingest)
        log({"run": "pipeline", "ingest": ingest, "frames": N_FRAMES,
             "height": HEIGHT, "width": WIDTH, "seconds": seconds,
             "frames_per_s": N_FRAMES / seconds, "boundaries": cuts,
             "launches": launches[ingest],
             "totals_s": sc.profiler.totals()})
        print(sc.summarize(), flush=True)
        if cuts != list(CUTS):
            raise AssertionError(f"{ingest}: boundaries {cuts}, want {CUTS}")
        if rows.shape != (N_FRAMES, 3, 16) or not (rows == want).all():
            raise AssertionError(f"{ingest}: histogram rows differ from the "
                                 "plain version's")
        kernel = "hist_rgb" if ingest == "rgb" else "hist_i420"
        other = "hist_i420" if ingest == "rgb" else "hist_rgb"
        expected = -(-N_FRAMES // CHUNK)
        if launches[ingest][kernel] != expected or launches[ingest][other]:
            raise AssertionError(
                f"{ingest}: launches {launches[ingest]}, want {expected} of "
                f"{kernel} and none of {other}")
    return launches


# ------------------------------------------------------------ main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from scannertools_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    log({"phase": "build", "sources": build.sources(),
         "seconds": time.perf_counter() - t0})

    records = check_kernels()

    db = tempfile.mkdtemp(prefix="chip_smoke_db_")
    try:
        launches = run_pipeline(db)
    finally:
        shutil.rmtree(db, ignore_errors=True)

    kernels = [
        {"name": "hist_rgb", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/histogram.cu",
         "replaces": "scannertools_tpu/ops/histogram.py:168",
         "launches": launches["rgb"]["hist_rgb"], **records["hist_rgb"],
         "library_ms": None},
        {"name": "hist_i420", "route": "cuda",
         "source": "scannertools_tpu_torch/kernels/csrc/histogram.cu",
         "replaces": "scannertools_tpu/ops/histogram.py:260",
         "launches": launches["i420"]["hist_i420"], **records["hist_i420"],
         "library_ms": None},
    ]
    log({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
