"""Time one job's host->device upload from its staging ring, with and
without page-locking the ring, on one CUDA card.

    python3 -m scannertools_tpu_torch.tools.upload_bench [--frames 480]
        [--height 1080] [--width 1920] [--chunk 64] [--rounds 2]

For each ingest format (rgb: 3 B/px, i420: 1.5 B/px) it runs the upload
loop of one job as the executor does: a fresh ``ChunkRing`` of depth+2 = 6
chunk slots; each chunk is written into its slot (one host memcpy, in place
of decode), copied to the card on a side stream and waited for, and its
slot released. Variants, each on a fresh ring:

  pageable       the ring as allocated (what the executor does);
  pageable_warm  the same ring running a second job: what a ring kept
                 across jobs would pay per job;
  register       the ring page-locked with ``cudaHostRegister`` before the
                 job and unregistered after it (per-job pinning);
  reused         a registered ring running a second job: what a ring kept
                 pinned across jobs would pay per job once pinned.

Variants alternate (pageable, register, register, pageable per round) so
drift in the host's rate falls on both. Prints one JSON line per job with
the seconds spent pinning, filling, copying and unpinning and the total,
then the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..io.prefetch import ChunkRing

NSLOTS = 6  # depth + 2 at the default prefetch_depth=2, io_packet_size=256


def _job(ring: ChunkRing, src: np.ndarray, n_frames: int, chunk: int,
         stream: torch.cuda.Stream) -> dict:
    fill = copy = 0.0
    fb = src.shape[1]
    for a in range(0, n_frames, chunk):
        t = min(chunk, n_frames - a)
        slot = ring.acquire()
        view = slot[: t * fb].reshape(t, fb)
        t0 = time.perf_counter()
        np.copyto(view, src[:t])
        ring.commit()
        t1 = time.perf_counter()
        with torch.cuda.stream(stream):
            dev = torch.from_numpy(view).to("cuda", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        ready.synchronize()
        t2 = time.perf_counter()
        ring.release()
        del dev
        fill += t1 - t0
        copy += t2 - t1
    return {"fill_s": fill, "copy_s": copy}


def _register(base: int, nbytes: int) -> float:
    t0 = time.perf_counter()
    rc = torch.cuda.cudart().cudaHostRegister(base, nbytes, 0)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostRegister failed with error {rc}")
    return time.perf_counter() - t0


def _unregister(base: int) -> float:
    t0 = time.perf_counter()
    rc = torch.cuda.cudart().cudaHostUnregister(base)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostUnregister failed with error {rc}")
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=480)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("upload_bench: no CUDA device")
    stream = torch.cuda.Stream()
    torch.zeros(1, device="cuda")  # create the context outside the timings
    rng = np.random.default_rng(0)
    for fmt, fb in (("rgb", args.height * args.width * 3),
                    ("i420", args.height * args.width * 3 // 2)):
        src = rng.integers(0, 256, (args.chunk, fb), dtype=np.uint8)
        for rnd in range(args.rounds):
            for variant in ("pageable", "register", "register", "pageable"):
                ring = ChunkRing(args.chunk * fb, NSLOTS)
                if not ring.native:
                    raise RuntimeError("the native staging ring did not build")
                # a fresh ring's first free slot is the start of its storage
                base = ring.acquire().ctypes.data
                pin = unpin = 0.0
                if variant == "register":
                    pin = _register(base, ring.slot_bytes * ring.nslots)
                first = _job(ring, src, args.frames, args.chunk, stream)
                second = _job(ring, src, args.frames, args.chunk, stream)
                if variant == "register":
                    unpin = _unregister(base)
                ring.close()
                again = "reused" if variant == "register" else "pageable_warm"
                jobs = [(variant, pin, first, unpin), (again, 0.0, second, 0.0)]
                for name, pin, times, unpin in jobs:
                    print(json.dumps({
                        "format": fmt, "variant": name, "round": rnd,
                        "frames": args.frames, "height": args.height,
                        "width": args.width,
                        "bytes": args.frames * fb, "pin_s": pin, **times,
                        "unpin_s": unpin,
                        "total_s": pin + times["fill_s"] + times["copy_s"]
                        + unpin}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
