"""Sweep the heads of a cell's random nets: how many faces or people a
frame each setting keeps, on the reference alone (no program, no window).

    python3 -m portbench.tools.tune --workload face_embedding.crowd \
        --seeds 11 12 13 --grid '{"onet": {"shift": [2.0, 3.0]}}'

A grid maps each head of the traffic file's "heads" to the values of its
keys to try; every combination is tried on every seed, over the pool's
first ``--frames`` frames, through the reference. An empty grid
tries the traffic file's own heads. Prints one JSON line a setting: the
mean, least and most count a frame, and the mean of each seed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def _settings(heads: dict, grid: dict):
    keys = [(h, k) for h, kv in grid.items() for k in kv]
    for values in itertools.product(*(grid[h][k] for h, k in keys)):
        out = json.loads(json.dumps(heads))
        for (h, k), v in zip(keys, values):
            out[h][k] = v
        yield dict(zip([f"{h}.{k}" for h, k in keys], values)), out


def _counts(ref, cfg, traffic, pool, seed, device, heads, frames):
    """Faces or people a frame over the pool's first ``frames`` frames, on
    the weights ``build`` sets for ``heads``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = ref.build(cfg, {**traffic, "heads": heads}, pool, gen, device)
    out = ref.reference(cfg, p, pool[:frames].to(device), None)
    return [len(next(iter(f.values()))) for f in out["frames"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--grid", required=True)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import drive, harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(bench, args.workload)
    cfg = harness.load_json(files["config"])
    traffic = harness.load_json(files["traffic"])
    import importlib

    ref = importlib.import_module(f"portbench.reference.{cfg['name']}")
    grid = json.loads(args.grid)
    results = {}
    for seed in args.seeds:
        gen = torch.Generator(device=args.device).manual_seed(seed)
        pool = drive.draw_pool(traffic, gen, args.device)
        for key, heads in _settings(traffic["heads"], grid):
            counts = _counts(ref, cfg, traffic, pool, seed, args.device,
                             heads, args.frames)
            results.setdefault(json.dumps(key, sort_keys=True), []).append(
                (float(np.mean(counts)), min(counts), max(counts)))
    for k, per_seed in results.items():
        means = [m for m, _, _ in per_seed]
        print(json.dumps({"setting": json.loads(k), "mean": float(
            np.mean(means)), "seed_means": means,
            "least": min(lo for _, lo, _ in per_seed),
            "most": max(hi for _, _, hi in per_seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
