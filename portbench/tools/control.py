"""The control of a cell's check: the plain reference computed in TF32 (its
convolutions and dense layers with operands rounded to TF32, the step a
change that turned TF32 on would take) put in the program's place, and
judged by the same comparison against the float32 reference.

    python3 -m portbench.tools.control --workload face_embedding.crowd \
        --seeds 21 22 23

Prints one JSON line a seed: each number compared, the limit, and whether
the control fails (it has to). The frames and weights are the run's own
for that seed; the packets are the pool's first ``check_packets``, each
as many frames as the program's work packet.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def readings(bench, cell, seed, device, overrides=None):
    """The control's numbers and the limits -> (numbers, limits)."""
    from portbench import drive, harness, plain

    files = harness.cell_files(bench, cell)
    overrides = overrides or {}
    cfg = harness._merge(harness.load_json(files["config"]),
                         overrides.get("config"))
    traffic = harness._merge(harness.load_json(files["traffic"]),
                             overrides.get("traffic"))
    ref = importlib.import_module(f"portbench.reference.{cfg['name']}")
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = drive.draw_pool(traffic, gen, device)
    state = ref.build(cfg, traffic, pool, gen, device)
    w = drive.packet_rows(traffic, *pool.shape[1:3])
    got, want = [], []
    for i in range(traffic["check_packets"]):
        frames = pool[(i * w) % len(pool):][:w].to(device)
        with plain.precision("tf32"):
            low = ref.reference(cfg, state, frames, None)["frames"]
        got += low
        want += ref.reference(cfg, state, frames, low)["frames"]
    return ref.compare(cfg, got, want, tuple(pool.shape[1:3])), \
        cfg["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        numbers, limits = readings(bench, args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": numbers, "limits": limits,
                          "fails": any(numbers[k] > v
                                       for k, v in limits.items())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
