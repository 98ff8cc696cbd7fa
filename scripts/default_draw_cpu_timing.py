"""Time a family's default draw on the CPU, alone and in several processes
at once.

The port draws default weights on the CPU in pieces small enough that
torch runs each operation on the calling thread
(``scannertools_tpu_torch/models/jax_random.py``). This script shows what
that buys when processes share the cores, as a test suite's workers do:
it starts ``--procs`` processes together, each drawing ``--family`` with
``weights.default_params(..., device="cpu")``, and prints one JSON line
of their seconds.

    python scripts/default_draw_cpu_timing.py [--family facenet]
        [--procs 6] [--threads 0] [--math-piece 2048]

``--threads`` N > 0 pins each process's torch to N threads;
``--math-piece`` sets the pieces the inverse error function takes (the
hash's chunk, 16384, makes it one call a chunk).
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def draw(family: str, threads: int, math_piece: int) -> float:
    sys.path.insert(0, REPO)
    import torch

    from scannertools_tpu_torch.models import jax_random, weights
    from scannertools_tpu_torch.ops import faces

    if threads:
        torch.set_num_threads(threads)
    jax_random._CPU_MATH_PIECE = math_piece
    t0 = time.perf_counter()
    weights.default_params(faces._MODELS[family], device="cpu")
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="facenet")
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--math-piece", type=int, default=2048)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(draw(args.family, args.threads, args.math_piece))
        return 0
    cmd = [sys.executable, os.path.abspath(__file__), "--one",
           "--family", args.family, "--threads", str(args.threads),
           "--math-piece", str(args.math_piece)]
    alone = float(subprocess.check_output(cmd))
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE)
             for _ in range(args.procs)]
    together = [float(p.communicate()[0]) for p in procs]
    print(json.dumps({"family": args.family, "threads": args.threads,
                      "math_piece": args.math_piece, "cpus": os.cpu_count(),
                      "alone_s": alone, "together_s": together}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
